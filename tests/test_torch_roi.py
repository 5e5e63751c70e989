"""The port's ROI rasterizer (``ops/roi.polygon_mask``, the C function of
``csrc/roi.c`` built with the system C compiler at first use) on the CPU.

* bit for bit with its plain version (``polygon_mask_plain``, the Python ray
  cast) and with the JAX package's ``ops.roi.polygon_mask`` (its own C
  rasterizer), on polygons of 1-20 vertices drawn from a seed: vertices
  past every edge of the grid, negative coordinates that wrap past 2**64,
  horizontal edges, ``scaling`` 0, 1, 3 and 7, square and non-square grids;
* the library is built from the checkout without nvcc, and a failed build
  raises with the compiler's output instead of falling back to Python;
* ``masked_mean_trace`` against the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thz_image_explorer_tpu.ops import roi as jroi
from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops import roi

#: (shape0, shape1) grids: square, non-square both ways, one row, one column
GRIDS = [(24, 24), (13, 29), (40, 17), (1, 9), (9, 1)]
SCALINGS = [0, 1, 3, 7]


def _polygons(shape, seed):
    """Polygons of 1-20 vertices over a grid of ``shape``: random ones
    reaching past every edge, ones with negative (wrapping) vertices, ones
    with horizontal edges, and huge coordinates near 2**64."""
    rng = np.random.default_rng(seed)
    size = max(shape)
    polys = []
    for n in range(1, 21):
        pts = rng.integers(-2 * size, 3 * size, size=(n, 2))
        polys.append([(int(x), int(y)) for x, y in pts])
    for n in (3, 4, 7):
        # inside the grid but for one vertex dragged past the left and top
        # edges: it wraps to ~2**64 in the reference's u64 arithmetic
        pts = rng.integers(0, size, size=(n, 2))
        pts[0] = (-int(rng.integers(1, 5)), -int(rng.integers(1, 5)))
        polys.append([(int(x), int(y)) for x, y in pts])
    for n in (4, 6, 10):
        # horizontal edges: pairs of consecutive vertices on one row
        ys = rng.integers(-1, size + 1, size=(n + 1) // 2)
        xs = rng.integers(-1, size + 1, size=n)
        polys.append([(int(xs[i]), int(ys[i // 2])) for i in range(n)])
    polys.append([(0, 0), (2**64 - 1, 3), (5, 2**63 + 7)])
    polys.append([(1, 1), (size + 5, 1), (size + 5, size + 5), (1, size + 5)])
    return polys


@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("shape", GRIDS, ids=[f"{a}x{b}" for a, b in GRIDS])
def test_polygon_mask_equals_plain_and_jax(shape, scaling):
    seed = 1000 * shape[0] + 10 * shape[1] + scaling
    set_any = 0
    for poly in _polygons(shape, seed):
        got = roi.polygon_mask(poly, shape, scaling)
        assert got.dtype == bool and got.shape == shape
        np.testing.assert_array_equal(got, roi.polygon_mask_plain(poly, shape, scaling),
                                      err_msg=str(poly))
        np.testing.assert_array_equal(got, jroi.polygon_mask(poly, shape, scaling),
                                      err_msg=str(poly))
        set_any += int(got.sum())
    # the cases are not vacuous: some polygons cover pixels
    assert (set_any > 0) == (scaling != 0)


def test_polygon_mask_edge_cases():
    for shape in ((5, 7), (0, 4), (4, 0)):
        for poly in ([], [(2, 3)], [(1, 1), (1, 1), (1, 1)]):
            got = roi.polygon_mask(poly, shape)
            np.testing.assert_array_equal(got, roi.polygon_mask_plain(poly, shape))
            np.testing.assert_array_equal(got, jroi.polygon_mask(poly, shape))
    # the reference's flipped y: the box's pixels y = 1-3 land on the mask's
    # rows 7 - 1 - y = 5, 4, 3
    got = roi.polygon_mask([(1, 1), (4, 1), (4, 4), (1, 4)], (7, 6))
    assert got[3:6, 1:4].all() and got.sum() == 9


def test_rasterizer_builds_without_nvcc(monkeypatch, tmp_path):
    """The library comes from ``csrc/roi.c`` through the C compiler into the
    build directory; no nvcc is asked for."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: pytest.fail("nvcc asked for"))
    monkeypatch.setattr(kernels, "_loaded", {})
    got = roi.polygon_mask([(1, 1), (20, 2), (9, 15)], (24, 24))
    assert kernels.library_path("roi").parent == tmp_path
    assert kernels.library_path("roi").exists() and "roi" in kernels.C_SOURCES
    np.testing.assert_array_equal(got, roi.polygon_mask_plain([(1, 1), (20, 2), (9, 15)],
                                                              (24, 24)))


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """No quiet fallback to Python: a compiler error reaches the caller."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "CC_FLAGS",
                        kernels.CC_FLAGS + ("-include", "thz_no_such_header.h"))
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(RuntimeError, match="the compiler failed for roi") as err:
        roi.polygon_mask([(1, 1), (20, 2), (9, 15)], (24, 24))
    assert "thz_no_such_header.h" in str(err.value)
    assert not list(tmp_path.glob("roi-*.so"))


@pytest.mark.parametrize("empty", [False, True], ids=["mask", "empty_mask"])
def test_masked_mean_trace_matches_jax(empty):
    rng = np.random.default_rng(7)
    data = rng.normal(size=(13, 9, 33)).astype(np.float32)
    mask = np.zeros((13, 9), bool) if empty else rng.random((13, 9)) < 0.3
    want = np.asarray(jroi.masked_mean_trace(jnp.asarray(data), jnp.asarray(mask)))
    got = roi.masked_mean_trace(torch.as_tensor(data), torch.as_tensor(mask))
    assert got.shape == (33,)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), roi.masked_mean_stack(torch.as_tensor(data), torch.as_tensor(mask)[None])[0])
    if empty:
        assert not got.any()
