"""Tilt compensation in the port against the JAX package, on the CPU.

``ops/tilt.py``: the extension step count equal to JAX's over a grid of
scan sizes, pixel spacings and tilts; the per-pixel integer shifts bit for
bit (a pixel whose step differs is counted and named); the new time axis
within one f32 step; the traces at atol 1e-6. The executor's replan: the host time axis without
a device read-back, zero spectra that allocate nothing, an FFT-window step
that reruns neither the tilt nor the replan, downstream stages clamped to
the new axis. And ``STEPS_TILT``: both Explorers driven through tilt on,
tilt changed (T changes), a TD band-pass clamped to the new axis, a click,
tilt off and on, and an Apply after tilt, every published series compared
after each step.
"""

import dataclasses
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_sample import synthetic_scan, write_scan_thz
from test_torch_deconv import psf_pair
from thz_image_explorer_tpu.data import make_cube as jmake_cube
from thz_image_explorer_tpu.ops import tilt as jtilt
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu_torch.data import make_cube
from thz_image_explorer_tpu_torch.ops import tilt
from thz_image_explorer_tpu_torch.pipeline import Explorer, PlotData

TILT = "tilt_compensation"
DEC = "deconvolution"
#: traces: the adapted-Blackman window's cosines differ by up to 3e-7
#: between XLA on the CPU and torch, times traces of magnitude <= ~1
TRACE_ATOL = 1e-6
#: the main path (tests/test_torch_pipeline.py) and the deconvolved steps
#: (tests/test_torch_apply.py: 1e-3 of each series' largest value)
ATOL, RTOL = 5e-5, 1e-4
DECONV_REL = 1e-3

SIZES = [(8, 6), (19, 13), (200, 200), (512, 512)]
SPACINGS = [0.25, 0.5, 1.0]
TILTS = [(0.0, 0.0), (2.0, 2.0), (3.0, 2.0), (-15.0, 3.0), (7.5, -11.0), (15.0, 15.0),
         (-0.3, 0.1)]


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("d", SPACINGS)
@pytest.mark.parametrize("tilts", TILTS, ids=[f"{a}_{b}" for a, b in TILTS])
def test_extension_steps_match_jax(size, d, tilts):
    w, h = size
    assert tilt.extension_steps(w, h, d, 0.8 * d, *tilts) == jtilt.extension_steps(
        w, h, d, 0.8 * d, *tilts)


def test_extension_steps_of_the_chip_scan():
    """The 200x200 scan at 0.5 mm: the T values the card's tilt phase runs."""
    assert tilt.extension_steps(200, 200, 0.5, 0.5, 2.0, 2.0) == 232
    assert tilt.extension_steps(200, 200, 0.5, 0.5, 3.0, 2.0) == 291


def test_fma32_is_one_rounding():
    """fma32 == the exactly rounded a*b + c, ties included."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (rng.standard_normal(400) * 3).astype(np.float32)
    # exact ties: c chosen so a*b + c sits halfway between two f32 values
    a[:3] = np.float32(1.0) + np.float32(2.0 ** -23)
    b[:3] = np.float32(1.0) + np.float32(2.0 ** -23)
    c[:3] = np.float32(-1.0)
    got = tilt.fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.uint32)) & 1))
        assert g == best, (x, y, z, g, best)


def _jax_shifts(data_shape, t, d, tilts):
    """JAX's per-pixel insert offsets, read off its output: a cube whose
    first sample is -1 (the window keeps sample 0) and whose other samples
    are 0.5 starts with insert + 1 samples of -1."""
    w, h, n = data_shape
    data = np.full((w, h, n), 0.5, np.float32)
    data[:, :, 0] = -1.0
    out = jtilt.tilt_compensate(jmake_cube(jnp.asarray(t), jnp.asarray(data), dx=d, dy=d),
                                *tilts)
    return (np.asarray(out.data) == -1.0).sum(-1) - 1, np.asarray(out.time)


SHIFT_CASES = [(w, h, d, tl) for (w, h) in [(19, 13), (40, 36), (64, 50)]
               for d in (0.25, 0.37, 1.0)
               for tl in [(2.0, 2.0), (3.0, 2.0), (-7.3, 11.1), (15.0, -15.0), (0.5, 0.0)]]


@pytest.mark.parametrize("case", SHIFT_CASES,
                         ids=[f"{w}x{h}_d{d}_{a}_{b}" for w, h, d, (a, b) in SHIFT_CASES])
def test_shifts_and_time_equal_jax(case):
    """The integer shifts bit for bit: a pixel whose step differs is named (a
    clamped offset of 0 reads as 0 on both sides). The new time axis within
    one f32 step of JAX's, its ends equal: which product of a linspace
    sample XLA fuses into a multiply-add varies with the compiled program."""
    w, h, d, tilts = case
    t = (np.arange(48) * 0.05 + 0.35).astype(np.float32)
    want, want_time = _jax_shifts((w, h, 48), t, d, tilts)
    n = tilt.extension_steps(w, h, d, d, *tilts)
    got = tilt.pixel_shifts(w, h, (w, h), d, d, *tilts, n)
    differ = np.argwhere(got != want)
    assert len(differ) == 0, f"{len(differ)} pixels step differently: {differ[:10].tolist()}"
    _assert_axis_close(tilt.extended_time(t, n), want_time)


def _assert_axis_close(got, want):
    """Equal ends, and every sample within one f32 step at the axis's
    largest magnitude."""
    assert got.shape == want.shape and (got[0], got[-1]) == (want[0], want[-1])
    step = float(np.spacing(np.abs(want).max()))
    assert float(np.abs(got.astype(np.float64) - want).max()) <= step


def _scan_cube(w, h, n, seed):
    t, raw = synthetic_scan(width=w, height=h, n_time=n, seed=seed)
    return t, raw - raw[:, :, :1]


@pytest.mark.parametrize("tilts", [(2.0, 2.0), (3.0, -2.0), (-15.0, 15.0), (0.0, 0.0)],
                         ids=["2_2", "3_-2", "-15_15", "zero"])
def test_tilt_compensate_matches_jax(tilts):
    t, data = _scan_cube(21, 17, 96, seed=5)
    want = jtilt.tilt_compensate(jmake_cube(jnp.asarray(t), jnp.asarray(data), dx=0.5, dy=0.7),
                                 *tilts)
    got = tilt.tilt_compensate(make_cube(t, data, dx=0.5, dy=0.7, device="cpu"), *tilts,
                               host_time=t)
    assert got.data.shape == want.data.shape
    _assert_axis_close(got.time.numpy(), np.asarray(want.time))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), atol=TRACE_ATOL, rtol=0)
    # without the host axis the op reads it from the cube: the same result
    again = tilt.tilt_compensate(make_cube(t, data, dx=0.5, dy=0.7, device="cpu"), *tilts)
    assert torch.equal(again.data, got.data)


def test_unknown_spacing_is_a_no_op():
    t, data = _scan_cube(8, 6, 64, seed=1)
    cube = make_cube(t, data, device="cpu")
    assert tilt.tilt_compensate(cube, 5.0, 5.0) is cube


def test_head_is_the_raw_first_sample_and_tail_zero():
    t, data = _scan_cube(16, 6, 64, seed=2)
    data = data + 0.25  # a nonzero first sample
    cube = make_cube(t, data, dx=2.0, dy=1.0, device="cpu")
    out = tilt.tilt_compensate(cube, 8.0, 0.0, host_time=t)
    n = tilt.extension_steps(16, 6, 2.0, 1.0, 8.0, 0.0)
    shifts = tilt.pixel_shifts(16, 6, (16, 6), 2.0, 1.0, 8.0, 0.0, n)
    x = out.data.numpy()
    for i, j in [(0, 0), (8, 3), (15, 5)]:
        s = int(shifts[i, j])
        np.testing.assert_array_equal(x[i, j, :s], data[i, j, 0])
        assert (x[i, j, s + 64:] == 0).all()


# ------------------------------------------------------------ the executor
def _tilted_explorer(w=20, h=18, n=64, tilts=(2.0, 1.0)):
    t, raw = synthetic_scan(width=w, height=h, n_time=n, seed=4)
    from thz_image_explorer_tpu_torch.io.dotthz import DotthzMetadata

    ex = Explorer(device="cpu")
    ex.open_arrays(t, raw, DotthzMetadata(md={"dx [mm]": "1.0", "dy [mm]": "1.0"}))
    ex.set_filter_param(TILT, "tilt_x", tilts[0])
    ex.set_filter_param(TILT, "tilt_y", tilts[1])
    ex.set_filter_active(TILT, True)
    return ex


def test_replan_from_the_host_axis(monkeypatch):
    """The tilt stage's slot carries the host axis's values, a frequency
    axis of the new length, and spectra that allocate nothing; the host
    axis is the stage's host_time_out, not a read-back of the device."""
    ex = _tilted_explorer()
    p = ex.pipeline
    k = p.index_of(TILT)
    slot = p.slots[k]
    n = tilt.extension_steps(20, 18, 1.0, 1.0, 2.0, 1.0)
    assert slot.n_time == 64 + 2 * n and n > 0
    np.testing.assert_array_equal(p._host_time[k], slot.time.numpy())
    assert slot.n_freq == slot.n_time // 2 + 1
    for name in ("fft", "amplitudes", "phases"):
        v = getattr(slot, name)
        assert v.shape == (20, 18, slot.n_freq) and v.stride() == (0, 0, 0)
        assert not bool(v.any())
    # downstream slots follow the new axis; the FFT stage's spectra are real
    fft = p.slots[p.fft_index]
    assert fft.fft.shape == (20, 18, slot.n_freq) and fft.fft.stride()[-1] == 1
    assert ex.plot.filtered_time.shape == (slot.n_time,)
    assert ex.plot.time.shape == (64,)

    # a tilt step reads no device axis back: Tensor.cpu is not called on a
    # time axis during the chain run
    reads = []
    real = torch.Tensor.cpu

    def spy(self, *a, **kw):
        if self.ndim == 1 and self.shape[0] in (64, slot.n_time):
            reads.append(self.shape)
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    ex.set_filter_param(TILT, "tilt_x", 3.0)
    p.update_filter(TILT)
    assert reads == []


def test_fft_window_step_reruns_neither_tilt_nor_replan(monkeypatch):
    ex = _tilted_explorer()
    p = ex.pipeline
    calls = []
    real_tilt, real_replan = tilt.tilt_compensate, type(p)._replan
    monkeypatch.setattr(tilt, "tilt_compensate", lambda *a, **k: (calls.append("tilt"),
                                                                   real_tilt(*a, **k))[1])
    monkeypatch.setattr(type(p), "_replan", staticmethod(
        lambda cube: (calls.append("replan"), real_replan(cube))[1]))
    k = p.index_of(TILT)
    kept = p.slots[k]
    ex.set_fft_window_low(1.3)
    assert calls == [] and p.slots[k] is kept
    ex.set_filter_param(TILT, "tilt_y", -1.0)
    ex.update_filter(TILT)
    assert calls == ["tilt", "replan"]


def test_downstream_band_pass_clamps_to_the_new_axis():
    ex = _tilted_explorer()
    p = ex.pipeline
    bp = p.filters["time_band_pass_before_fft"]
    bp.low, bp.high = -100.0, 100.0
    ex.set_filter_active("time_band_pass_before_fft", True)
    t = p._host_time[p.index_of(TILT)]
    assert (bp.low, bp.high) == (float(t[0]), float(t[-1]))
    assert t[0] < 0.0  # the axis starts before the scan's first sample


# ---------------------------------------------------------- both Explorers
def _tilt(x, y):
    return lambda ex, a: (ex.set_filter_param(TILT, "tilt_x", x),
                          ex.set_filter_param(TILT, "tilt_y", y), ex.update_filter(TILT))


#: (name, command, whether the published state is deconvolved after it)
STEPS_TILT = [
    ("open", lambda ex, a: ex.open_file(a["path"]), False),
    ("rois", lambda ex, a: (ex.add_roi("u1", "ref", [(1, 1), (8, 1), (8, 7), (1, 7)]),
                            ex.add_roi("u2", "samp", [(10, 9), (17, 9), (14, 16)]),
                            ex.set_reference("ref"), ex.set_sample("samp")), False),
    ("tilt_on", lambda ex, a: (ex.set_filter_param(TILT, "tilt_x", 2.0),
                               ex.set_filter_param(TILT, "tilt_y", 1.0),
                               ex.set_filter_active(TILT, True)), False),
    ("tilt_changed", _tilt(3.0, -2.0), False),
    ("td_bandpass_clamped", lambda ex, a: (
        ex.set_filter_param("time_band_pass_before_fft", "low", -100.0),
        ex.set_filter_param("time_band_pass_before_fft", "high", 100.0),
        ex.set_filter_active("time_band_pass_before_fft", True)), False),
    ("fd_filters", lambda ex, a: ex.set_filter_active("frequency_band_pass", True), False),
    ("window", lambda ex, a: ex.set_fft_window_low(1.4), False),
    ("click", lambda ex, a: (ex.set_sample("Selected Pixel"), ex.set_selected_pixel(13, 4)),
     False),
    ("tilt_off", lambda ex, a: ex.set_filter_active(TILT, False), False),
    ("tilt_on_again", lambda ex, a: ex.set_filter_active(TILT, True), False),
    ("psf", lambda ex, a: (ex.apply_psf(a["psf"]), [
        ex.set_filter_param(DEC, k, v) for k, v in
        (("n_filters", 5.0), ("n_iterations", 8.0), ("start_freq", 0.25), ("end_freq", 4.0))],
        ex.set_filter_active(DEC, True)), False),
    ("apply_after_tilt", lambda ex, a: ex.update_filter(DEC, force=True), True),
    ("downscale", lambda ex, a: ex.set_downscaling(2), False),
]

_SERIES = [f.name for f in dataclasses.fields(PlotData)]


def _snapshot(ex):
    plot = {}
    for name in _SERIES:
        v = getattr(ex.plot, name)
        if isinstance(v, dict):
            v = {u: (n, np.array(a)) for u, (n, a) in v.items()}
        elif isinstance(v, np.ndarray):
            v = np.array(v)
        plot[name] = v
    return plot, np.array(ex.image)


@pytest.fixture(scope="module")
def tilt_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tilt")
    t, raw = synthetic_scan(width=20, height=18, n_time=64, seed=6)
    path = write_scan_thz(str(tmp / "s.thzimg"), t, raw, dx=1.0, dy=1.0)
    jpsf, tpsf = psf_pair(tmp)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("THZ_SHAPE_BUCKET", "1")
        for key, ex, psf in (("jax", JaxExplorer(), jpsf), ("port", Explorer(device="cpu"), tpsf)):
            args = {"path": path, "psf": psf}
            out[key] = [(step(ex, args), _snapshot(ex))[1] for _n, step, _d in STEPS_TILT]
    return out


def _close(got, ref, deconvolved, msg):
    if deconvolved:
        atol, rtol = DECONV_REL * float(np.nanmax(np.abs(ref), initial=0.0)), 0.0
    else:
        atol, rtol = ATOL, RTOL
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("step", range(len(STEPS_TILT)), ids=[s[0] for s in STEPS_TILT])
def test_tilt_steps_match_jax_explorer(tilt_runs, step):
    (jplot, jimg), (tplot, timg) = tilt_runs["jax"][step], tilt_runs["port"][step]
    deconvolved = STEPS_TILT[step][2]
    _close(timg, jimg, deconvolved, "image")
    for name in _SERIES:
        j, t = jplot[name], tplot[name]
        if isinstance(j, dict):
            assert list(t) == list(j), name
            for uuid in j:
                assert t[uuid][0] == j[uuid][0]
                _close(t[uuid][1], j[uuid][1], deconvolved, f"{name}[{uuid}]")
        elif isinstance(j, np.ndarray):
            assert t.shape == j.shape, name
            # n/alpha/kappa divide by omega = 0 at the DC bin in both
            _close(np.nan_to_num(t), np.nan_to_num(j), deconvolved, name)
        else:
            assert t == j, name


def test_tilt_steps_reach_their_state(tilt_runs):
    """The steps are not vacuous: T grows with the tilt and changes with
    it, the band-pass and the Apply change the image, tilt off restores the
    scan's axis."""
    names = [s[0] for s in STEPS_TILT]
    snaps = tilt_runs["port"]

    def at(name):
        return snaps[names.index(name)]

    lengths = {n: at(n)[0]["filtered_time"].shape[0] for n in names}
    assert lengths["open"] == 64 < lengths["tilt_on"] < lengths["tilt_changed"]
    assert lengths["tilt_off"] == 64 and lengths["tilt_on_again"] == lengths["tilt_changed"]
    assert at("td_bandpass_clamped")[0]["filtered_time"][0] < 0.0
    assert not np.allclose(at("apply_after_tilt")[1], at("psf")[1])
    assert np.isfinite(at("apply_after_tilt")[0]["refractive_index"][1:]).all()
