"""The port's deconvolution modules against the JAX package's, on the CPU.

Host planning (FIR bank, PSF model, band geometry, energy matrices) must be
equal bit for bit; the PSF ``.npz`` codec must read what the other package
wrote; the Richardson-Lucy plain version and the whole ``deconvolve_cube``
must agree with the JAX functions (the Pallas kernel in interpret mode, as
the JAX package's own tests run it) and with ``tests/oracle_deconv.py``.

The real ``psf.npz`` is not in the repository, so every case uses a
synthetic PSF both packages build from the same coefficients. It is
asymmetric on purpose (x0 != 0, y0 != 0, wx != wy): a symmetric PSF would
hide a correlation taken in the wrong direction.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle_deconv import deconvolve_oracle
from thz_image_explorer_tpu.io import psf_npz as jpsf_npz
from thz_image_explorer_tpu.models import psf as jpsf
from thz_image_explorer_tpu.ops import deconvolution as jdec
from thz_image_explorer_tpu.ops import firdesign as jfir
from thz_image_explorer_tpu.ops.pallas_rl import rl_bands_separable as jax_rl_bands
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch.data import make_cube
from thz_image_explorer_tpu_torch.io import psf_npz as tpsf_npz
from thz_image_explorer_tpu_torch.models import psf as tpsf
from thz_image_explorer_tpu_torch.ops import deconvolution as tdec
from thz_image_explorer_tpu_torch.ops import firdesign as tfir
from thz_image_explorer_tpu_torch.ops import rlsep
from thz_image_explorer_tpu_torch.pipeline.filters import Deconvolution
from thz_image_explorer_tpu_torch.pipeline.stage import StageContext

KNOTS = np.geomspace(0.1, 10.0, 6)


def synthetic_psf_arrays(wx=(0.70, 0.50), wy=(0.85, 0.55), x0=0.3, y0=-0.2,
                         correction=None):
    """The 28 schema arrays of a PSF with widths ``a / f + b`` mm, constant
    centres ``x0``, ``y0`` mm and knots over 0.1-10 THz. ``correction``
    (an rng) gives the width corrections random spline coefficients
    instead of zeros. A constant centre sets both ``values`` and
    ``coeff_a``: ``eval_const_extrap`` reads ``values`` outside the knots."""
    zeros = np.zeros_like(KNOTS)

    def spline(prefix, const, rng=None):
        c = np.full_like(KNOTS, const)
        coeffs = [c, zeros, zeros, zeros]
        if rng is not None:
            coeffs = [rng.uniform(-0.05, 0.05, KNOTS.shape) for _ in range(4)]
        return {f"{prefix}_knots_thz": KNOTS, f"{prefix}_values_mm": c,
                **{f"{prefix}_coeff_{n}": v for n, v in zip("abcd", coeffs)}}

    return {
        "wx_base_a": np.array([wx[0]]), "wx_base_b": np.array([wx[1]]),
        **spline("wx_corr", 0.0, correction),
        "wy_base_a": np.array([wy[0]]), "wy_base_b": np.array([wy[1]]),
        **spline("wy_corr", 0.0, correction),
        **spline("x0", x0), **spline("y0", y0),
    }


def psf_pair(tmp_path, **kw):
    """(JAX PSF, port PSF) of the same synthetic coefficients."""
    arrays = synthetic_psf_arrays(**kw)
    path = tmp_path / "synthetic_psf.npz"
    np.savez(path, **arrays)
    return jpsf_npz.load_psf(str(path)), convert.psf_from_numpy(arrays)


def _cube(w=32, h=28, n=128, seed=11):
    """Two pulses per trace with random per-pixel amplitudes plus noise
    (the JAX tests' realistic case, smaller)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(n) * 0.05).astype(np.float32)
    cube = np.zeros((w, h, n), np.float32)
    cube[:, :, 20] = rng.uniform(0.5, 1.0, (w, h))
    cube[:, :, 60] = 0.4 * rng.uniform(0.2, 1.0, (w, h))
    cube += 0.01 * rng.normal(size=cube.shape).astype(np.float32)
    return t, cube


PARAMS = dict(n_iterations=8, n_filters=6, start_freq=0.25, end_freq=4.0)


def _plans(tmp_path, shape=(32, 28), dx=1.0, dy=1.0, params=PARAMS, n=128):
    jp, tp = psf_pair(tmp_path)
    t, _ = _cube(*shape, n=n)
    jgeo = jdec.plan_bands(jdec.DeconvolutionParams(**params), jp, t, shape, dx, dy)
    tgeo = tdec.plan_bands(tdec.DeconvolutionParams(**params), tp, t, shape, dx, dy)
    return jgeo, tgeo


# ------------------------------------------------------------ host planning
@pytest.mark.parametrize("n_filters,start,end,width,n", [
    (25, 0.1, 10.0, 0.5, 1024), (6, 0.25, 4.0, 0.5, 128), (3, 0.5, 2.0, 4.0, 64),
])
def test_filter_bank_equals_jax(n_filters, start, end, width, n):
    t = np.arange(n) * 0.05
    jt, jc = jfir.create_filter_bank(n_filters, start, end, width, t)
    tt, tc = tfir.create_filter_bank(n_filters, start, end, width, t)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("seed", [None, 5])
def test_psf_evals_equal_jax(tmp_path, seed):
    rng = None if seed is None else np.random.default_rng(seed)
    arrays = synthetic_psf_arrays(correction=rng)
    np.savez(tmp_path / "p.npz", **arrays)
    jp, tp = jpsf_npz.load_psf(str(tmp_path / "p.npz")), convert.psf_from_numpy(arrays)
    # inside the knots, and both extrapolation sides
    f = np.float32(np.concatenate([[0.03, 0.07], np.geomspace(0.1, 10, 17), [12.0, 30.0]]))
    for name in ("wx_fit", "wy_fit"):
        np.testing.assert_array_equal(getattr(tp, name).eval(f), getattr(jp, name).eval(f))
    for name in ("x0_spline", "y0_spline"):
        np.testing.assert_array_equal(getattr(tp, name).eval_const_extrap(f),
                                      getattr(jp, name).eval_const_extrap(f))
        np.testing.assert_array_equal(getattr(tp, name).eval(f), getattr(jp, name).eval(f))
    assert tp.is_loaded and jp.is_loaded
    assert tp.fingerprint() == jp.fingerprint()
    assert not tpsf.PSF.empty().is_loaded


@pytest.mark.parametrize("x0,w,dx", [(0.3, 1.7, 0.5), (-0.2, 0.9, 1.0), (0.0, 4.0, 0.25)])
def test_psf_axes_equal_jax(x0, w, dx):
    x = np.arange(-9, 10, dtype=np.float32) * np.float32(dx)
    y = np.arange(-12, 13, dtype=np.float32) * np.float32(dx)
    jx, jy = jpsf.gaussian(x, x0, w), jpsf.gaussian(y, -x0, 1.3 * w)
    tx, ty = tpsf.gaussian(x, x0, w), tpsf.gaussian(y, -x0, 1.3 * w)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    ja = jpsf.create_psf_axes(jx, jy, x, y, dx, dx)
    ta = tpsf.create_psf_axes(tx, ty, x, y, dx, dx)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a, b)


_FIELDS = [f.name for f in dataclasses.fields(jdec.BandGeometry) if not f.name.startswith("_")]


@pytest.mark.parametrize("shape,dx,params", [
    ((32, 28), 1.0, PARAMS),
    ((20, 18), 1.0, dict(PARAMS, n_filters=5)),
    ((200, 200), 0.5, {}),  # the Apply default: 25 bands, 500 iterations
    ((48, 40), 0.5, dict(PARAMS, n_iterations=1)),
])
def test_plan_bands_equals_jax(tmp_path, shape, dx, params):
    jgeo, tgeo = _plans(tmp_path, shape, dx, dx, params)
    assert jgeo is not None and tgeo is not None
    assert [f.name for f in dataclasses.fields(tdec.BandGeometry)
            if not f.name.startswith("_")] == _FIELDS
    for name in _FIELDS:
        a, b = getattr(tgeo, name), getattr(jgeo, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the profiles are asymmetric, so a flip is visible
    assert not np.array_equal(tgeo.px[0], tgeo.px[0, ::-1])


def test_plan_bands_guards_equal_jax(tmp_path):
    jp, tp = psf_pair(tmp_path)
    t, _ = _cube(n=64)
    p = PARAMS
    for shape, d in (((8, 8), 1.0), ((32, 28), 0.01), ((15, 40), 1.0)):
        assert jdec.plan_bands(jdec.DeconvolutionParams(**p), jp, t, shape, d, d) is None
        assert tdec.plan_bands(tdec.DeconvolutionParams(**p), tp, t, shape, d, d) is None
    assert tdec.plan_bands(tdec.DeconvolutionParams(**p), tpsf.PSF.empty(), t,
                           (32, 28), 1.0, 1.0) is None
    # equal widths everywhere: every band gets 0 iterations, in both
    jp, tp = psf_pair(tmp_path, wx=(0.0, 0.8), wy=(0.0, 0.8))
    jgeo = jdec.plan_bands(jdec.DeconvolutionParams(**p), jp, t, (32, 28), 1.0, 1.0)
    tgeo = tdec.plan_bands(tdec.DeconvolutionParams(**p), tp, t, (32, 28), 1.0, 1.0)
    assert not tgeo.n_iter.any()
    np.testing.assert_array_equal(tgeo.n_iter, jgeo.n_iter)


@pytest.mark.parametrize("n_filters,n", [(6, 128), (25, 1024)])
def test_energy_matrices_equal_jax(n_filters, n):
    t = np.arange(n) * 0.05
    taps, _ = jfir.create_filter_bank(n_filters, 0.1, 10.0, 0.5, t)
    fft_len = tdec._conv_len(n + taps.shape[1] - 1)
    assert fft_len == jdec._conv_len(n + taps.shape[1] - 1)
    for a, b in zip(tdec._energy_matrices(taps, fft_len, n),
                    jdec._energy_matrices(taps, fft_len, n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if n == 1024:
        assert fft_len == 1536


def test_reflect_index_equals_jax_pad_matrix():
    for h, pad, pad_max in ((20, 3, 5), (18, 9, 9), (7, 0, 4), (16, 15, 15)):
        src, valid = tdec._reflect_index(h, pad, pad_max)
        expected = np.zeros((h + 2 * pad_max, h), np.float32)
        expected[np.flatnonzero(valid), src[valid]] = 1.0
        np.testing.assert_array_equal(expected, jdec._reflect_pad_matrix(h, pad, pad_max))


def test_psf_npz_read_by_the_other_package(tmp_path):
    rng = np.random.default_rng(2)
    arrays = synthetic_psf_arrays(correction=rng)
    jp, tp = jpsf_npz.load_psf(_save(tmp_path / "a.npz", arrays)), convert.psf_from_numpy(arrays)
    jpsf_npz.save_psf(str(tmp_path / "jax.npz"), jp)
    tpsf_npz.save_psf(str(tmp_path / "port"), tp)  # no suffix: exactly this path
    assert (tmp_path / "port").exists()
    from_jax = tpsf_npz.load_psf(str(tmp_path / "jax.npz"))
    from_port = jpsf_npz.load_psf(str(tmp_path / "port"))
    assert from_jax.fingerprint() == jp.fingerprint() == tp.fingerprint()
    assert from_port.fingerprint() == jp.fingerprint()
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 28
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float64
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _save(path, arrays):
    np.savez(path, **arrays)
    return str(path)


# ------------------------------------------------------------ the RL kernel
def _centred(profiles):
    """Profiles of different odd lengths, zero-padded to one odd canvas."""
    k = max(len(p) for p in profiles) | 1
    out = np.zeros((len(profiles), k), np.float32)
    for i, p in enumerate(profiles):
        r0 = (k - len(p)) // 2
        out[i, r0: r0 + len(p)] = p
    return out


def _rl_case(name):
    """(padded, px, py, n_iter) of the JAX kernel test's shapes
    (tests/test_pallas_rl.py) and of an asymmetric, flipped case with a
    zero margin around each band's own region."""
    if name == "pallas_rl_test":
        rng = np.random.default_rng(3)
        padded = rng.uniform(0.5, 2.0, (3, 24, 136)).astype(np.float32)
        px = _centred([rng.uniform(0.1, 0.5, 2 * k + 1).astype(np.float32) for k in (1, 2, 3)])
        py = _centred([rng.uniform(0.1, 0.5, 2 * k + 1).astype(np.float32) for k in (2, 1, 4)])
        return padded, px, py, np.array([4, 0, 7], np.int32)
    if name == "grouped_test":
        rng = np.random.default_rng(7)
        padded = rng.uniform(0.5, 2.0, (4, 16, 128)).astype(np.float32)
        px = rng.uniform(0.1, 0.4, (4, 3)).astype(np.float32)
        py = rng.uniform(0.1, 0.4, (4, 5)).astype(np.float32)
        return padded, px, py, np.array([6, 2, 0, 4], np.int32)
    rng = np.random.default_rng(13)
    padded = np.zeros((2, 31, 45), np.float32)
    padded[0, 2:29, 3:42] = rng.uniform(0.2, 1.5, (27, 39))
    padded[1, 4:27, 1:44] = rng.uniform(0.2, 1.5, (23, 43))
    x = np.arange(-4, 5, dtype=np.float32)
    px = np.stack([np.exp(-(x - 1.3) ** 2 / 3), np.exp(-(x + 0.7) ** 2 / 5)]).astype(np.float32)
    py = _centred([np.exp(-(np.arange(-3, 4) - 0.9) ** 2 / 2),
                   np.exp(-(np.arange(-6, 7) + 2.1) ** 2 / 8)])
    py[1] = py[1, ::-1]  # a band with FFT semantics: pre-flipped
    return padded, px, py, np.array([5, 9], np.int32)


@pytest.mark.parametrize("case", ["pallas_rl_test", "grouped_test", "asymmetric_flipped"])
def test_rl_plain_matches_jax_kernel(case):
    padded, px, py, n_iter = _rl_case(case)
    _, h2, w2 = padded.shape
    rs = np.stack([jdec._banded_matrix(v, h2) for v in px])
    cs = np.stack([jdec._banded_matrix(v, w2) for v in py])
    ref = np.asarray(jax_rl_bands(jnp.asarray(padded), jnp.asarray(rs), jnp.asarray(cs),
                                  jnp.asarray(n_iter), interpret=True))
    t = [torch.from_numpy(a) for a in (padded, px, py)]
    got = rlsep.rl_bands_separable(*t, n_iter)
    plain = rlsep.rl_bands_separable_plain(*t, n_iter)
    assert torch.equal(got, plain)  # the CPU wrapper is the plain version
    # the JAX test's tolerance: its interpret kernel splits operands into
    # bf16 pairs
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(got[n_iter == 0].numpy(), padded[n_iter == 0])
    np.testing.assert_array_equal(
        rlsep.banded_matrix(t[1], h2).numpy(), rs)


def test_rl_groups_and_stop(monkeypatch):
    padded, px, py, n_iter = _rl_case("grouped_test")
    t = [torch.from_numpy(a) for a in (padded, px, py)]
    whole = rlsep.rl_bands_separable(*t, n_iter)
    monkeypatch.setattr(rlsep, "GROUP", 4)
    seen = []
    split = rlsep.rl_bands_separable(*t, n_iter,
                                     between=lambda d, n: seen.append((d, n)) or False)
    assert seen == [(0, 2), (1, 2)]
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)
    assert rlsep.rl_bands_separable(*t, n_iter, between=lambda d, n: d == 1) is None
    zero = np.zeros(4, np.int32)
    assert torch.equal(rlsep.rl_bands_separable(*t, zero), t[0])


def test_rl_wrapper_refuses_bad_input():
    padded, px, py, n_iter = [torch.from_numpy(np.asarray(a)) if i < 3 else a
                              for i, a in enumerate(_rl_case("grouped_test"))]
    with pytest.raises(ValueError, match="padded"):
        rlsep.rl_bands_separable(padded.double(), px, py, n_iter)
    with pytest.raises(ValueError, match="px"):
        rlsep.rl_bands_separable(padded, px[:2], py, n_iter)
    with pytest.raises(ValueError, match="n_iter"):
        rlsep.rl_bands_separable(padded, px, py, n_iter[:2])
    with pytest.raises(ValueError, match=">= 0"):
        rlsep.rl_bands_separable(padded, px, py, -n_iter)
    with pytest.raises(ValueError, match="contiguous"):
        rlsep.rl_bands_separable(padded.transpose(1, 2), px, py, n_iter)


# ------------------------------------------------------------ the whole cube
@pytest.fixture(scope="module")
def deconv_case(tmp_path_factory):
    jgeo, tgeo = _plans(tmp_path_factory.mktemp("psf"))
    _, cube = _cube()
    # mixed semantics and skewed trip counts, as at the reference geometry
    assert tgeo.use_fft_conv.any() and (~tgeo.use_fft_conv).any()
    assert tgeo.n_iter.min() < tgeo.n_iter.max()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rlsep, "GROUP", 3)
        got = tdec.deconvolve_cube(torch.from_numpy(cube), tgeo)
    return cube, jgeo, tgeo, got.numpy()


@pytest.mark.parametrize("rl_impl,tol", [("scan", 1e-4), ("pallas", 2e-3)])
def test_deconvolve_matches_jax(deconv_case, rl_impl, tol, monkeypatch):
    cube, jgeo, _tgeo, got = deconv_case
    if rl_impl == "pallas":
        monkeypatch.setenv("THZ_PALLAS_INTERPRET", "1")
    ref = np.asarray(jdec.deconvolve_cube(jnp.asarray(cube), jgeo, chunk_size=4,
                                          rl_impl=rl_impl))
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol)


def test_deconvolve_matches_oracle(deconv_case):
    cube, _jgeo, tgeo, got = deconv_case
    expected = deconvolve_oracle(cube, tgeo)
    scale = np.abs(expected).max()
    np.testing.assert_allclose(got / scale, expected / scale, atol=5e-3)
    assert np.abs(got - cube).max() > 1e-3 * scale  # it did something


def test_deconvolve_cancellation_and_progress(deconv_case, monkeypatch):
    cube, _jgeo, tgeo, got = deconv_case
    calls = []
    monkeypatch.setattr(rlsep, "GROUP", 2)
    out = tdec.deconvolve_cube(torch.from_numpy(cube), tgeo,
                               cancelled=lambda: calls.append(1) or len(calls) > 1)
    assert out is None and len(calls) == 2
    seen = []
    monkeypatch.setattr(rlsep, "GROUP", 3)
    again = tdec.deconvolve_cube(torch.from_numpy(cube), tgeo, progress=seen.append)
    k = -(-int(tgeo.n_iter.max()) // 3)
    assert seen == [i / (k + 1) for i in range(k + 1)] + [1.0]
    np.testing.assert_array_equal(again.numpy(), got)  # the plan cache gives the same


def _stage_cube(cube, t, dx):
    return make_cube(t, cube, dx=dx, dy=dx, device="cpu")


def test_stage_guards_pass_the_cube_through(tmp_path):
    _jp, tp = psf_pair(tmp_path)
    t, cube = _cube()
    stage = Deconvolution()
    stage.params = tdec.DeconvolutionParams(**PARAMS)
    progress = []
    ctx = StageContext(psf=tp, progress=progress.append)
    no_dx = _stage_cube(cube, t, None)
    assert stage.apply(no_dx, ctx) is no_dx  # dx/dy unknown
    c = _stage_cube(cube, t, 1.0)
    assert stage.apply(c, StageContext()) is c  # no PSF
    assert stage.apply(c, StageContext(psf=tpsf.PSF.empty())) is c  # not loaded
    small = _stage_cube(cube[:12, :12], t, 1.0)
    assert stage.apply(small, ctx) is small  # plan_bands refuses
    assert progress == [0.0, None, 0.0, None]
    out = stage.apply(c, ctx)
    assert out is not c and out.data is not c.data and out.fft is c.fft
    key = stage._plan_cache[0]
    stage.apply(c, StageContext(psf=convert.psf_from_numpy(synthetic_psf_arrays())))
    assert stage._plan_cache[0] == key  # keyed on content, not identity
