"""The port's ROI rasterizer (``ops/roi.polygon_mask``, the C function of
``csrc/roi.c`` built with the system C compiler at first use) on the CPU.

* bit for bit with its plain version (``polygon_mask_plain``, the Python ray
  cast) and with the JAX package's ``ops.roi.polygon_mask`` (its own C
  rasterizer), on polygons of 1-20 vertices drawn from a seed: vertices
  past every edge of the grid, negative coordinates that wrap past 2**64,
  horizontal edges, ``scaling`` 0, 1, 3 and 7, square and non-square grids;
* the library is built from the checkout without nvcc, and a failed build
  raises with the compiler's output instead of falling back to Python;
* ``kernels.SIGNATURES`` against the sources: one entry for every
  ``extern "C"`` function of ``csrc/*.cu`` and every non-static function
  of ``csrc/*.c``, none else, each with its source's arity, return type
  and scalar parameter types; ``kernels.load`` declares them;
* ``masked_mean_trace`` against the JAX package's.
"""

import ctypes
import re

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


#: a C scalar type -> its ctypes type (``void`` only as a return type)
_C_SCALARS = {"void": None, "int": ctypes.c_int, "long long": ctypes.c_longlong,
              "float": ctypes.c_float, "size_t": ctypes.c_size_t, "uint64_t": ctypes.c_uint64}
_POINTERS = (ctypes.c_void_p, ctypes.c_char_p)


def _entry_points(name):
    """``{symbol: (return type, [parameter types])}`` of ``csrc/<name>``'s
    exported functions, as C text: a ``.cu``'s ``extern "C"`` definitions, a
    ``.c``'s non-static top-level ones."""
    if name in kernels.C_SOURCES:
        text = (kernels.CSRC / f"{name}.c").read_text()
        found = re.findall(r"^(?!static\b)([A-Za-z_][\w ]*?[\w*])\s*\b(\w+)\(([^)]*)\)\s*\{",
                           text, re.M)
    else:
        text = (kernels.CSRC / f"{name}.cu").read_text()
        found = re.findall(r'extern "C"\s+([\w ]*?[\w*])\s*\b(\w+)\(([^)]*)\)', text)
    out = {}
    for ret, symbol, params in found:
        types = [re.sub(r"\s*\b\w+$", "", " ".join(q.split())) for q in params.split(",")]
        assert symbol not in out, f"{name}: {symbol} defined twice"
        out[symbol] = (" ".join(ret.split()), types)
    return out


@pytest.mark.parametrize("name", kernels.SOURCES + kernels.C_SOURCES)
def test_signature_table_matches_the_source(name):
    """The table names each exported function of the source once, and
    nothing else, with its arity, return type and scalar types."""
    found = _entry_points(name)
    assert found, name
    table = kernels.SIGNATURES[name]
    assert set(table) == set(found), name
    for symbol, (ret, params) in found.items():
        restype, argtypes = table[symbol]
        assert restype is _C_SCALARS[ret], (symbol, ret)
        assert len(argtypes) == len(params), (symbol, params)
        for c_type, got in zip(params, argtypes):
            if "*" in c_type:
                assert got in _POINTERS or issubclass(got, ctypes._Pointer), (symbol, c_type)
            else:
                assert got is _C_SCALARS[c_type.removeprefix("const ")], (symbol, c_type)


def test_signature_table_names_every_library():
    assert set(kernels.SIGNATURES) == set(kernels.SOURCES + kernels.C_SOURCES)
    symbols = [s for table in kernels.SIGNATURES.values() for s in table]
    assert len(symbols) == len(set(symbols))


def test_load_declares_the_table_once(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    lib = kernels.load("roi")
    restype, argtypes = kernels.SIGNATURES["roi"]["thz_roi_polygon_mask"]
    fn = lib.thz_roi_polygon_mask
    assert fn.restype is restype and list(fn.argtypes) == argtypes
    assert kernels.load("roi") is lib and lib.thz_roi_polygon_mask is fn
    with pytest.raises(RuntimeError, match="rl2d kernel launch failed: CUDA error 700"):
        kernels.check_launch(700, "rl2d")
    kernels.check_launch(0, "rl2d")


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
