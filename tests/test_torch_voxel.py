"""The port's 3-D voxel view against the JAX package's, on the CPU.

The envelope (``envelope_plain``, reached through ``voxel_opacities``) is
held against the JAX package's f32 XLA path (``_voxel_opacities_impl(...,
use_pallas=False)``) and against its Pallas kernel in interpret mode; the
dynamic threshold must equal the JAX one bit for bit; the top-k and dense
extractions, the VTU writer and ``Explorer.save_vtu`` must give what the JAX
package gives for the same inputs.

Every tap vector below is asymmetric: the Gaussian is symmetric and would
hide a correlation taken in the wrong direction (a convolution). The data
stay away from the normalization edges, and each case checks that it does
(:func:`_assert_away_from_edges`): a trace whose envelope maximum lies
within a few ulp of the opacity threshold, or whose range lies within a few
ulp of 1e-6, flips between 0 and a full ramp on a 1-ulp difference.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_sample import synthetic_scan, write_scan_thz
from thz_image_explorer_tpu.io import vtk as jvtk
from thz_image_explorer_tpu.ops import voxel as jvox
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu_torch.io import vtk as tvtk
from thz_image_explorer_tpu_torch.ops import envelope as tenv
from thz_image_explorer_tpu_torch.ops import voxel as tvox
from thz_image_explorer_tpu_torch.pipeline import Explorer

#: opacities are in [0, 1]; the two f32 paths differ only in the order of
#: the correlation's sum (XLA's convolution vs a shifted-slice sum)
OPAC_ATOL = 2e-5
#: the JAX Pallas kernel multiplies by a bf16 band matrix (its own test's
#: tolerance, tests/test_viz_utils.py:316)
PALLAS_TOL = 5e-3

ASYM5 = np.array([0.1, 0.5, 0.2, 0.05, 0.15], np.float32)


def _traces(x, y, t, seed, zero=(), flat=()):
    """Gaussian noise traces with a per-trace amplitude, some all-zero and
    some constant."""
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(x, y, t)) * rng.uniform(0.2, 1.5, (x, y, 1))).astype(np.float32)
    for i in zero:
        data[i // y, i % y] = 0.0
    for i in flat:
        data[i // y, i % y] = 0.7
    return data


def _assert_away_from_edges(data, taps, contrast, thr, margin=1e-4):
    """Every trace's envelope maximum is further than ``margin`` (relative)
    from ``thr``, and its range is 0 or further than ``margin`` from 1e-6
    (computed in f64)."""
    r = len(taps) // 2
    flat = data.reshape(-1, data.shape[-1]).astype(np.float64)
    with np.errstate(divide="ignore"):
        p = np.power(flat * flat, float(contrast))
    p = np.pad(p, ((0, 0), (r, r)))
    env = sum(float(taps[k]) * p[:, k: k + flat.shape[1]] for k in range(len(taps)))
    lmax, rng_ = env.max(axis=1), env.max(axis=1) - env.min(axis=1)
    assert (np.abs(lmax - thr) > margin * max(abs(thr), 1e-30)).all()
    assert ((rng_ == 0) | (np.abs(rng_ - 1e-6) > margin * 1e-6)).all()


def _jax_opacities(data, taps, contrast, thr):
    opac, th = jvox._voxel_opacities_impl(
        jnp.asarray(data), jnp.asarray(taps), np.float32(contrast), np.float32(thr),
        len(taps) // 2, False)
    return np.asarray(opac), np.float32(th)


# ------------------------------------------------------------ the envelope
ENVELOPE_CASES = {
    # name: (data, taps, contrast, threshold)
    "asymmetric_taps": (_traces(6, 10, 96, 1, zero=(3,), flat=(7,)), ASYM5, 2.0, 0.3),
    "r0": (_traces(4, 5, 64, 2, zero=(0,)), np.array([0.8], np.float32), 2.0, 0.3),
    "taps_longer_than_trace": (_traces(3, 4, 9, 3, flat=(2,)),
                               np.linspace(0.05, 1.0, 21).astype(np.float32), 2.0, 0.3),
    "contrast_0_zero_traces": (_traces(4, 6, 80, 4, zero=(0, 5, 11), flat=(2,)),
                               ASYM5, 0.0, 0.01),
    "contrast_1p3_flat": (_traces(5, 6, 70, 5, zero=(1,), flat=(4, 9)), ASYM5[::-1].copy(),
                          1.3, 0.25),
    "gaussian_default": (_traces(4, 7, 128, 6, zero=(2,)), jvox.gaussian_kernel1d(3.0, 9), 2.0, 0.1),
}


@pytest.mark.parametrize("case", list(ENVELOPE_CASES))
def test_voxel_opacities_match_jax_xla(case):
    data, taps, contrast, thr = ENVELOPE_CASES[case]
    _assert_away_from_edges(data, taps, contrast, thr)
    ref, ref_thr = _jax_opacities(data, taps, contrast, thr)
    got, got_thr = tvox.voxel_opacities(torch.from_numpy(data), taps, contrast, thr,
                                        len(taps) // 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=OPAC_ATOL)
    assert float(got_thr) == float(ref_thr) == 0.0  # under the 2M cap
    rows = got.numpy().reshape(-1, data.shape[-1])
    assert np.isclose(rows.max(axis=1), 1.0).any()
    if contrast == 0:
        # 0^0 = 1: every trace, the all-zero ones too, has the same envelope
        assert (rows == rows[0]).all()
    elif case != "taps_longer_than_trace":
        assert (rows.max(axis=1) == 0).any()  # zeroed traces too
    # the CPU wrapper is the plain version
    flat = torch.from_numpy(data.reshape(-1, data.shape[-1]))
    assert torch.equal(tenv.envelope(flat, taps, contrast, thr),
                       tenv.envelope_plain(flat, taps, contrast, thr))


def test_contrast_zero_takes_zero_to_the_zero_as_one():
    """0^0 = 1 (torch.pow, jnp.power, powf): an all-zero trace at contrast 0
    has the envelope of a constant 1, so it is normalized, not zeroed."""
    data = np.zeros((1, 2, 32), np.float32)
    data[0, 1] = _traces(1, 1, 32, 9)[0, 0]
    got = tenv.envelope_plain(torch.from_numpy(data.reshape(2, 32)), ASYM5, 0.0, 0.5)
    ref, _ = _jax_opacities(data, ASYM5, 0.0, 0.5)
    np.testing.assert_allclose(got.numpy(), ref.reshape(2, 32), atol=OPAC_ATOL)
    assert got[0].max() == 1.0 and got[0, 16] == 1.0  # the interior is the max


def test_envelope_matches_jax_pallas_interpret():
    """The JAX Pallas kernel (interpret mode, bf16 band matrix) on its own
    test's shape: 288 traces, one ragged block."""
    data = _traces(8, 36, 128, 1, zero=(5,))
    taps = ASYM5
    w = jvox._band_matrix_bf16(taps, 128, 2)
    ref = np.asarray(jvox._envelope_pallas(
        jnp.asarray(data.reshape(-1, 128)), w, np.float32(2.0), np.float32(0.4),
        interpret=True))
    got = tenv.envelope(torch.from_numpy(data.reshape(-1, 128)), taps, 2.0, 0.4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_envelope_refuses_bad_input():
    flat = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="float32"):
        tenv.envelope(flat.double(), ASYM5, 2.0, 0.1)
    with pytest.raises(ValueError, match="odd length"):
        tenv.envelope(flat, ASYM5[:4], 2.0, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tenv.envelope(torch.zeros((8, 4)).T, ASYM5, 2.0, 0.1)
    with pytest.raises(ValueError, match="no envelope kernel"):
        tenv.envelope(flat.to("meta"), ASYM5, 2.0, 0.1)
    with pytest.raises(ValueError, match="radius"):
        tvox.voxel_opacities(flat.reshape(2, 2, 8), ASYM5, 2.0, 0.1, 3)


# ------------------------------------------------------- dynamic threshold
def _tie_spike(max_instances):
    rng = np.random.default_rng(2)
    return np.concatenate([
        np.full(max_instances + 500_000, 0.999, np.float32),
        rng.uniform(0.0, 0.9, 500_000).astype(np.float32),
    ])


@pytest.mark.parametrize("case", ["cubed_uniform", "tie_spike"])
def test_dynamic_threshold_bit_for_bit(case, monkeypatch):
    """The inputs of tests/test_viz_utils.py:264 (cap 1M) and :354."""
    if case == "cubed_uniform":
        for mod in (jvox, tvox):
            monkeypatch.setattr(mod, "MAX_INSTANCES", 1_000_000)
        flat = np.random.default_rng(0).uniform(0, 1, 3_000_000).astype(np.float32) ** 3
    else:
        flat = _tie_spike(tvox.MAX_INSTANCES)
    ref = np.float32(jvox._dynamic_threshold(jnp.asarray(flat)))
    got = tvox._dynamic_threshold(torch.from_numpy(flat))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == ref.tobytes()
    kept = int((flat >= float(got)).sum())
    if case == "cubed_uniform":
        assert kept <= 1_000_000
    else:
        assert kept >= tvox.MAX_INSTANCES + 500_000  # the tie mass survives


def test_voxel_opacities_above_the_cap():
    """48x44x1024 > 2M voxels, so the threshold runs: opacities within the
    f32 tolerance and the threshold the JAX one (its edges are built in the
    same f32 order, and no opacity lies near one)."""
    data = _traces(48, 44, 1024, 7, zero=(0, 100), flat=(9,))
    taps = jvox.gaussian_kernel1d(3.0, 9)
    _assert_away_from_edges(data, taps, 2.0, 0.1)
    ref, ref_thr = _jax_opacities(data, taps, 2.0, 0.1)
    got, got_thr = tvox.voxel_opacities(torch.from_numpy(data), taps, 2.0, 0.1, 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=OPAC_ATOL)
    assert 0.0 < float(ref_thr) < 1.0
    assert got_thr.numpy().tobytes() == ref_thr.tobytes()
    assert int((got.numpy() >= float(got_thr)).sum()) <= tvox.MAX_INSTANCES


# ------------------------------------------------------------------ top-k
def _spiky(x=8, y=6, t=64, seed=1):
    """tests/test_viz_utils.py's top-k cube: noise and two bright voxels."""
    rng = np.random.default_rng(seed)
    data = (0.1 * rng.normal(size=(x, y, t))).astype(np.float32)
    data[2, 1, 20] = 4.0
    data[5, 3, 40] = 3.0
    return data


def _by_index(idx, vals):
    return dict(zip(np.asarray(idx).tolist(), np.asarray(vals, np.float32).tolist()))


def _assert_same_selection(got, ref, kth, tol):
    """Top-k selections as sets keyed by flat index: every entry above the
    k-th value (by more than ``tol``) is in both with the same value within
    ``tol``; ties at the k-th value may be broken differently."""
    for a, b in ((got, ref), (ref, got)):
        for i, v in a.items():
            if v > kth + tol:
                assert i in b, (i, v)
                assert abs(b[i] - v) <= tol, (i, v, b[i])
    assert len(got) == len(ref)


@pytest.mark.parametrize("k", [25, 300])
def test_topk_unpacked_matches_jax(k):
    data, taps = _spiky(), ASYM5
    vals, idx, thr = tvox._voxel_topk_impl(torch.from_numpy(data), taps, 2.0, 0.1, 2, k)
    jvals, jidx, jthr = (np.asarray(a) for a in jvox._voxel_topk_impl(
        jnp.asarray(data), jnp.asarray(taps), np.float32(2.0), np.float32(0.1), 2, False, k))
    assert vals.dtype == torch.float16 and idx.dtype == torch.int32
    np.testing.assert_array_equal(vals.numpy(), jvals)  # f16 of f32 values 2e-7 apart
    assert float(thr) == float(jthr)
    _assert_same_selection(_by_index(idx.numpy(), vals.numpy()), _by_index(jidx, jvals),
                           float(jthr), 1e-3)


@pytest.mark.parametrize("k", [25, 300])
def test_topk_packed_matches_jax(k):
    data, taps = _spiky(seed=7), ASYM5
    packed, thr = tvox._voxel_topk_packed(torch.from_numpy(data), taps, 2.0, 0.1, 2, k)
    jpacked, jthr = (np.asarray(a) for a in jvox._voxel_topk_packed(
        jnp.asarray(data), jnp.asarray(taps), np.float32(2.0), np.float32(0.1), 2, False, k))
    packed = packed.numpy().astype(np.uint32)
    assert packed.shape == jpacked.shape == (k,)
    np.testing.assert_allclose(float(thr), float(jthr), atol=OPAC_ATOL)
    # the 6-bit alphas may differ by one step where an opacity lies at a
    # rounding boundary; none of these does, so they are equal
    got = _by_index(packed >> 6, packed & 63)
    ref = _by_index(jpacked >> 6, jpacked & 63)
    _assert_same_selection(got, ref, float(np.floor(float(jthr) * 63)), 0.0)


def _view_dict(pos, rgba):
    return {tuple(np.round(p, 5)): tuple(c) for p, c in zip(pos, rgba)}


@pytest.mark.parametrize("valid_grid,scaling", [(None, 1), ((6, 5), 2)])
def test_extract_instances_topk_matches_jax(valid_grid, scaling):
    """The live view (packed: the cube has < 2**26 voxels) with web.py's
    argument set, also on a padded grid and a downscaled cube."""
    data = _spiky(seed=3)
    kw = dict(time_span=10.0, scaling=scaling, original_dims=(12, 10, 64), max_points=40,
              valid_grid=valid_grid, opacity_threshold=0.1, contrast=2.0,
              kernel_sigma=2.5, kernel_radius=4)
    *ref, = jvox.extract_instances_topk(jnp.asarray(data), **kw)
    *got, = tvox.extract_instances_topk(torch.from_numpy(data), **kw)
    assert got[2:5] == ref[2:5]  # rendered voxel dims, the scaling folded in
    np.testing.assert_allclose(got[5], ref[5], atol=OPAC_ATOL)
    g, r = _view_dict(got[0], got[1]), _view_dict(ref[0], ref[1])
    assert 0 < len(g) <= 40 and set(g) == set(r)
    for key in g:
        np.testing.assert_allclose(g[key], r[key], atol=1e-6)
    if valid_grid is not None:  # spacing from the valid grid: inside its extent
        assert np.abs(got[0][:, 0]).max() <= 10 * 0.25 / 2 + 1e-6
        assert np.abs(got[0][:, 1]).max() <= 12 * 0.25 / 2 + 1e-6


def test_extract_instances_topk_unpacked_matches_dense():
    """The unpacked fetch, through its own function, as the live view takes
    it above 2**26 voxels: the brightest voxels of the dense extraction."""
    data = _spiky()
    kw = dict(time_span=10.0, scaling=1, original_dims=(8, 6, 64))
    pos_d, rgba_d, *_ = tvox.extract_instances(torch.from_numpy(data), **kw)
    idx, vals, keep, thr = tvox._fetch_unpacked(
        torch.from_numpy(data), tvox.gaussian_kernel1d(3.0, 9), 2.0, 0.1, 9, 25)
    pos_t, rgba_t, *_, thr_t = tvox._topk_instances(idx, vals, keep, thr, data.shape,
                                                    kw["time_span"], 1, kw["original_dims"],
                                                    None)
    dense = {tuple(np.round(p, 5)): o for p, o in zip(pos_d, rgba_d[:, 3])}
    assert 0 < len(pos_t) <= 25
    for p, o in zip(pos_t, rgba_t[:, 3]):
        assert abs(dense[tuple(np.round(p, 5))] - o) <= 1e-3  # f16 values
        assert o >= thr_t


@pytest.mark.parametrize("valid_grid,scaling", [(None, 1), ((7, 5), 2)])
def test_extract_instances_matches_jax(valid_grid, scaling):
    data = _traces(9, 6, 48, 11, zero=(4,))
    kw = dict(time_span=12.5, scaling=scaling, original_dims=(14, 10, 48),
              valid_grid=valid_grid, opacity_threshold=0.2, contrast=1.5,
              kernel_sigma=2.0, kernel_radius=3)
    ref = jvox.extract_instances(jnp.asarray(data), **kw)
    got = tvox.extract_instances(torch.from_numpy(data), **kw)
    np.testing.assert_array_equal(got[0], ref[0])  # same voxels, same geometry
    np.testing.assert_allclose(got[1], ref[1], atol=OPAC_ATOL)
    assert got[2:6] == ref[2:6]


# --------------------------------------------------------------- VTU files
def test_export_to_vtk_writes_the_same_bytes(tmp_path):
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(57, 3)).astype(np.float32)
    rgba = rng.uniform(size=(57, 4)).astype(np.float32)
    for n in (57, 0):
        jvtk.export_to_vtk(pos[:n], rgba[:n], str(tmp_path / "j.vtu"))
        tvtk.export_to_vtk(pos[:n], rgba[:n], str(tmp_path / "t.vtu"))
        assert (tmp_path / "t.vtu").read_bytes() == (tmp_path / "j.vtu").read_bytes()
    with pytest.raises(ValueError, match="same length"):
        tvtk.export_to_vtk(pos, rgba[:3], str(tmp_path / "bad.vtu"))


def _read_vtu(path):
    """(points (N, 3), rgb (N, 3), opacity (N,)) of a written .vtu."""
    text = open(path).read()

    def array(name_attr):
        m = re.search(r"<DataArray[^>]*" + name_attr + r"[^>]*>\n(.*?)\s*</DataArray>",
                      text, re.S)
        return np.array(m.group(1).split(), np.float64)

    n = int(re.search(r'NumberOfPoints="(\d+)"', text).group(1))
    points = array('type="Float64" NumberOfComponents="3" format').reshape(n, 3)
    return points, array('Name="RGB"').reshape(n, 3), array('Name="Opacity"')


@pytest.fixture(scope="module")
def scan_path(tmp_path_factory):
    t, raw = synthetic_scan(width=18, height=14, n_time=64)
    return write_scan_thz(str(tmp_path_factory.mktemp("scan") / "s.thzimg"), t, raw)


#: the contrast of the Explorer test: the filtered scan's traces are ~1e-2,
#: so (v^2)^0.5 keeps every envelope range far above the 1e-6 edge
CONTRAST_3D = 0.5


def _drive_3d(ex, scan_path, out_dir, threshold):
    ex.open_file(scan_path)
    ex.set_filter_active("frequency_band_pass", True)
    ex.set_filter_active("water_vapor_notch", True)
    ex.set_3d_contrast(CONTRAST_3D)
    ex.set_kernel_sigma(2.0)
    ex.set_kernel_radius(4)
    ex.set_opacity_threshold(threshold)
    paths = [str(out_dir / f"{type(ex).__module__.split('.')[0]}_{i}.vtu") for i in (1, 2)]
    ex.save_vtu(paths[0])
    ex.set_downscaling(2)
    ex.save_vtu(paths[1])
    return paths


def _threshold_in_a_gap(scan_path):
    """An opacity threshold midway in the widest gap between the per-trace
    envelope maxima of the final cube at scale 1 and 2 (so no trace sits at
    it), inside the middle half of the scale-2 maxima (so both branches
    run at both scales). Every trace's range is far above 1e-6."""
    ex = Explorer(device="cpu")
    ex.open_file(scan_path)
    ex.set_filter_active("frequency_band_pass", True)
    ex.set_filter_active("water_vapor_notch", True)
    taps = tvox.gaussian_kernel1d(2.0, 4)
    maxima = []
    for scale in (1, 2):
        ex.set_downscaling(scale)
        data = ex.pipeline.output.data.numpy().astype(np.float64)
        p = np.pad(np.power(data * data, CONTRAST_3D), ((0, 0), (0, 0), (4, 4)))
        env = sum(float(taps[k]) * p[..., k: k + data.shape[-1]] for k in range(9))
        assert (env.max(axis=-1) - env.min(axis=-1)).min() > 1e-4
        maxima.append(env.max(axis=-1).ravel())
    lo, hi = np.percentile(maxima[1], [25, 75])
    m = np.sort(np.concatenate(maxima))
    m = m[(m >= lo) & (m <= hi)]
    i = int(np.argmax(np.diff(m)))
    return float((m[i] + m[i + 1]) / 2)


def test_explorers_save_the_same_vtu(scan_path, tmp_path):
    """Both Explorers: open -> FD filters -> the 3-D settings -> SaveVTU, then
    a 2x downscale -> SaveVTU. The JAX package pads the grid to 16 (valid
    grid 18x14); the port does not. Same points, same colours within the
    chain's parity (atol 5e-5 on traces of amplitude ~1, raised by the
    contrast and the per-trace normalization: 1e-3)."""
    thr = _threshold_in_a_gap(scan_path)
    jpaths = _drive_3d(JaxExplorer(), scan_path, tmp_path, thr)
    tex = Explorer(device="cpu")
    tpaths = _drive_3d(tex, scan_path, tmp_path, thr)
    assert tex.view3d == {"contrast": CONTRAST_3D, "kernel_sigma": 2.0, "kernel_radius": 4,
                          "opacity_threshold": thr}
    sizes = []
    for jp, tp in zip(jpaths, tpaths):
        jpts, jrgb, jop = _read_vtu(jp)
        tpts, trgb, top = _read_vtu(tp)
        np.testing.assert_array_equal(tpts, jpts)
        np.testing.assert_allclose(top, jop, atol=1e-3)
        np.testing.assert_allclose(trgb, jrgb, atol=4e-3)  # jet: 4x the opacity
        assert (top == 0).any() and (top == 1).any()
        sizes.append(len(tpts))
    # under the 2M cap every valid voxel is an instance
    assert sizes == [18 * 14 * 64, 9 * 7 * 64]


def test_explorer_3d_defaults_match_jax():
    assert Explorer(device="cpu").view3d == JaxExplorer().view3d
