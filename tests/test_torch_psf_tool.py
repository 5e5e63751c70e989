"""The PSF tool in the port against the JAX package, on the CPU.

``ops/firapply``: the band filtering and its intensities against JAX's at
atol 1e-4 (the tolerance of ``tests/test_psf_tool.py``) and against a float64
direct correlation. The fits: given JAX's intensities the port's warm-started
Nelder-Mead chain is JAX's bit for bit; end to end, the chain carries JAX's
float32 filtering differences (~3e-7 of the traces' scale) forward, and
``PSF_CASES`` states how far each input's fits move and their tolerances.
The curve fits, the diagnostics and the 28
``.npz`` arrays from the same widths equal JAX's to 1e-12. Then the loader,
the app's thread (device passed in, cancellation, stale results, shutdown,
persistence only where asked) and the knife-edge -> PSF tool -> ``apply_psf``
-> Apply chain against the JAX package doing the same (1e-3 of max).
"""

import dataclasses
import os
import threading

import numpy as np
import pytest

import chip_smoke
from make_sample import synthetic_scan, write_scan_thz
from test_psf_tool import _synthetic_knife_edge
from thz_image_explorer_tpu.io import psf_npz as jpsf_npz
from thz_image_explorer_tpu.ops import firapply as jfir
from thz_image_explorer_tpu.ops.firdesign import create_filter_bank
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu.psf_tool import app as japp
from thz_image_explorer_tpu.psf_tool import curve_fitting as jcf
from thz_image_explorer_tpu.psf_tool import data_loader as jdl
from thz_image_explorer_tpu.psf_tool import diagnostics as jdiag
from thz_image_explorer_tpu.psf_tool import fitting as jfit
from thz_image_explorer_tpu.psf_tool import visualize as jvis
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch.io import psf_npz as tpsf_npz
from thz_image_explorer_tpu_torch.ops import firapply as tfir
from thz_image_explorer_tpu_torch.pipeline import Explorer
from thz_image_explorer_tpu_torch.psf_tool import app as tapp
from thz_image_explorer_tpu_torch.psf_tool import curve_fitting as tcf
from thz_image_explorer_tpu_torch.psf_tool import data_loader as tdl
from thz_image_explorer_tpu_torch.psf_tool import diagnostics as tdiag
from thz_image_explorer_tpu_torch.psf_tool import fitting as tfit
from thz_image_explorer_tpu_torch.psf_tool import visualize as tvis

FIR_ATOL = 1e-4
DECONV_REL = 1e-3


def _direct_correlation(traces, taps):
    """float64 'same' correlation, the definition (``fitting.rs:266-284``)."""
    b, n_taps = taps.shape
    mid = n_taps // 2
    padded = np.pad(traces, ((0, 0), (mid, n_taps - 1 - mid)))
    win = np.lib.stride_tricks.sliding_window_view(padded, n_taps, axis=1)
    return np.einsum("ptl,bl->bpt", win, taps)


FIR_SHAPES = [(5, 200, 3, 21), (7, 150, 4, 33), (12, 256, 4, 499), (3, 1001, 2, 499),
              (1, 64, 1, 1), (9, 97, 2, 8)]


@pytest.mark.parametrize("shape", FIR_SHAPES, ids=[f"p{p}_t{t}_b{b}_l{l}"
                                                   for p, t, b, l in FIR_SHAPES])
def test_fir_matches_jax_and_the_definition(shape):
    p, t, b, n_taps = shape
    rng = np.random.default_rng(sum(shape))
    traces = rng.normal(size=(p, t))
    taps = rng.normal(size=(b, n_taps)) / np.sqrt(n_taps)
    got = tfir.fir_correlate_bands(traces, taps, device="cpu")
    np.testing.assert_allclose(got, _direct_correlation(traces, taps), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got, jfir.fir_correlate_bands(traces, taps), atol=FIR_ATOL)
    filt, inten = tfir.fir_correlate_bands_device(traces, taps, device="cpu")
    jfilt, jinten = jfir.fir_correlate_bands_device(traces, taps)
    assert filt.dtype.is_floating_point and filt.dtype.itemsize == 4 and filt.device.type == "cpu"
    np.testing.assert_allclose(filt.numpy(), np.asarray(jfilt), atol=FIR_ATOL)
    np.testing.assert_allclose(inten, jinten, atol=FIR_ATOL)
    np.testing.assert_allclose(
        inten, np.stack([jfit.compute_intensity(x) for x in _direct_correlation(traces, taps)]),
        atol=1e-9)


@pytest.mark.parametrize("n", [1, 2, 7, 97, 1499, 1500, 1537, 4097])
def test_fft_length_is_the_next_5_smooth(n):
    m = tfir.fft_length(n)
    assert m == next(k for k in range(n, 2 * n + 2) if _is_5_smooth(k))


def _is_5_smooth(k):
    for p in (2, 3, 5):
        while k % p == 0:
            k //= p
    return k == 1


def test_average_pair_and_take_band():
    a = tfir.fir_correlate_bands_device(np.ones((2, 8)), np.ones((3, 3)), device="cpu")[0]
    b = a * 3
    np.testing.assert_array_equal(tfir.average_pair(a, b).numpy(), (2 * a).numpy())
    assert tfir.take_band(a, 1).shape == (2, 8)


# ------------------------------------------------------------------ fits
def _halves(seed=0):
    m = _synthetic_knife_edge(seed=seed)
    return m, jdl.split_and_flip(m)


def test_fit_chain_is_jax_given_jax_intensities(monkeypatch):
    """The port's warm-started, bounds-moving Nelder-Mead chain on JAX's
    own intensities gives JAX's fits bit for bit."""
    m, (_left, right) = _halves()
    taps, _ = create_filter_bank(6, 0.3, 3.0, 0.5, m.times)
    jmean = jfit.fit_mean_beam(right.positions, right.positions, right.time_traces,
                               right.time_traces)
    want = jfit.fit_beam_widths(jmean, right.positions, right.positions, right.time_traces,
                                right.time_traces, taps, jfit.BeamFitParams())
    monkeypatch.setattr(tfit, "filter_and_intensity_all_bands", lambda tr, tp, dev: (
        None, jfit.filter_and_intensity_all_bands(tr, tp)[1]))
    tmean = tfit.fit_mean_beam(right.positions, right.positions, right.time_traces,
                               right.time_traces)
    assert dataclasses.astuple(tmean) == dataclasses.astuple(jmean)
    got = tfit.fit_beam_widths(tmean, right.positions, right.positions, right.time_traces,
                               right.time_traces, taps, tfit.BeamFitParams())
    np.testing.assert_array_equal(got.popt_xs, want.popt_xs)
    np.testing.assert_array_equal(got.popt_ys, want.popt_ys)
    # JAX's warm start carried across: the same chain
    carried = convert.mean_beam_fit_from_numpy(jmean.x0, jmean.y0, jmean.popt_x, jmean.popt_y)
    again = tfit.fit_beam_widths(carried, right.positions, right.positions, right.time_traces,
                                 right.time_traces, taps, tfit.BeamFitParams())
    np.testing.assert_array_equal(again.popt_xs, want.popt_xs)


def test_curve_fits_of_jax_beam_fits_equal_jax(tmp_path):
    """JAX's per-band fits carried across as numpy: the port's curve fits of
    them are JAX's, single-axis and two-axis."""
    m = _synthetic_knife_edge(seed=2)
    jres = japp.compute_psf(m, m, japp.FilterParams(n_filters=6, start_freq=0.3, end_freq=3.0))

    def carried(b):
        return convert.beam_width_fits_from_numpy(
            b.popt_xs, b.popt_ys, np.asarray(b.filtered_traces_x), np.asarray(b.filtered_traces_y),
            b.x_positions, b.y_positions, device="cpu")

    bx, by = carried(jres.x.beam_fits), carried(jres.y.beam_fits)
    assert bx.filtered_traces_x.dtype.itemsize == 4
    f = np.linspace(0.1, 10.0, 50)
    for args in ((bx, by), (bx, None), (None, by)):
        jargs = [None if a is None else b for a, b in zip(args, (jres.x.beam_fits,
                                                                 jres.y.beam_fits))]
        got = tapp.compute_curve_fits(jres.center_frequencies, *args)
        want = japp.compute_curve_fits(jres.center_frequencies, *jargs)
        for name in ("wx_fit", "wy_fit"):
            np.testing.assert_array_equal(getattr(got, name).evaluate(f),
                                          getattr(want, name).evaluate(f))
        for name in ("x0_fit", "y0_fit"):
            np.testing.assert_array_equal(getattr(got, name).evaluate_const_extrap(f),
                                          getattr(want, name).evaluate_const_extrap(f))
    assert tapp.compute_curve_fits(jres.center_frequencies, None, None) is None


def test_fit_chain_dedupes_identical_axes():
    m, (_left, right) = _halves()
    taps, _ = create_filter_bank(3, 0.5, 2.0, 0.5, m.times)
    mean = tfit.fit_mean_beam(right.positions, right.positions, right.time_traces,
                              right.time_traces)
    fits = tfit.fit_beam_widths(mean, right.positions, right.positions, right.time_traces,
                                right.time_traces, taps, tfit.BeamFitParams(), device="cpu")
    assert fits.filtered_traces_x is fits.filtered_traces_y
    np.testing.assert_array_equal(fits.popt_ys, fits.popt_xs)


def _synthetic(seed):
    m = _synthetic_knife_edge(seed=seed)
    tm = convert.knife_edge_from_numpy(m.positions, m.time_traces, m.times)
    return (m, m), (tm, tm)


def _knife(seed):
    mx = chip_smoke.knife_edge_traces(60, 512, seed=seed)
    my = chip_smoke.knife_edge_traces(60, 512, seed=seed + 10, width_scale=1.2)
    return ((jdl.KnifeEdgeMeasurement(*mx), jdl.KnifeEdgeMeasurement(*my)),
            (convert.knife_edge_from_numpy(*mx), convert.knife_edge_from_numpy(*my)))


#: (name, inputs, FilterParams, (x0, w, width-curve) atol in mm). On
#: tests/test_psf_tool.py's synthetic knife edge the left half's width sits
#: at the w_max bound, where x0 is ill-determined and moved by up to 1.6e-2
#: mm (3.0e-5 mm in the other fits); w moved by up to 1.6e-5 mm and the
#: width curves by 2.1e-4 mm. On the smoke's knife edge (widths 1.4-4.5 mm
#: falling with frequency) x0 and w moved by up to 3.8e-6 mm, the curves
#: by 1.8e-5 mm (four seeds each, both band settings).
PSF_CASES = [
    ("synthetic_bands4", _synthetic, 0, dict(n_filters=4, start_freq=0.5, end_freq=2.0),
     (2e-2, 1e-4, 1e-3)),
    ("synthetic_defaults", _synthetic, 1, {}, (2e-2, 1e-4, 1e-3)),
    ("knife_edge_bands4", _knife, 0, dict(n_filters=4, start_freq=0.5, end_freq=2.0),
     (1e-4, 1e-4, 1e-4)),
    ("knife_edge_defaults", _knife, 1, {}, (1e-4, 1e-4, 1e-4)),
]


@pytest.fixture(scope="module", params=PSF_CASES, ids=[c[0] for c in PSF_CASES])
def psf_pair(request):
    _name, make, seed, params, tol = request.param
    (jx, jy), (tx, ty) = make(seed)
    return (japp.compute_psf(jx, jy, japp.FilterParams(**params)),
            tapp.compute_psf(tx, ty, tapp.FilterParams(**params), device="cpu"), tol)


def test_compute_psf_fits_match_jax(psf_pair):
    jres, tres, (x0_atol, w_atol, curve_atol) = psf_pair
    np.testing.assert_array_equal(tres.filters, jres.filters)
    np.testing.assert_array_equal(tres.center_frequencies, jres.center_frequencies)
    for ax in ("x", "y"):
        for side in ("beam_fits_left", "beam_fits_right", "beam_fits"):
            j, t = getattr(getattr(jres, ax), side), getattr(getattr(tres, ax), side)
            np.testing.assert_allclose(t.popt_xs[:, 0], j.popt_xs[:, 0], atol=x0_atol, rtol=0)
            np.testing.assert_allclose(t.popt_xs[:, 1], j.popt_xs[:, 1], atol=w_atol, rtol=0)
            np.testing.assert_allclose(t.filtered_traces_x.numpy(),
                                       np.asarray(j.filtered_traces_x), atol=FIR_ATOL)
        jm, tm = getattr(jres, ax).mean_fit, getattr(tres, ax).mean_fit
        np.testing.assert_allclose(dataclasses.astuple(tm)[:2], dataclasses.astuple(jm)[:2],
                                   atol=x0_atol)
    f = np.linspace(0.1, 10.0, 200)
    for name, ev in (("wx_fit", "evaluate"), ("wy_fit", "evaluate"),
                     ("x0_fit", "evaluate_const_extrap"), ("y0_fit", "evaluate_const_extrap")):
        atol = curve_atol if name[0] == "w" else x0_atol
        np.testing.assert_allclose(getattr(getattr(tres.curve_fits, name), ev)(f),
                                   getattr(getattr(jres.curve_fits, name), ev)(f),
                                   atol=atol, err_msg=name)
    assert tres.warnings == jres.warnings


def test_curve_fits_npz_and_diagnostics_equal_jax_from_the_same_widths(psf_pair, tmp_path):
    """From the port's fitted widths and centres, both packages' curve fits,
    diagnostics and exported arrays agree to 1e-12: the 28-key schema."""
    _jres, tres, _tol = psf_pair
    bx, by = tres.x.beam_fits, tres.y.beam_fits
    args = (tres.center_frequencies, np.abs(bx.popt_xs[:, 1]), np.abs(by.popt_ys[:, 1]),
            bx.popt_xs[:, 0], by.popt_ys[:, 0])
    jfits, tfits = jcf.CurveFits.fit_from_data(*args), tcf.CurveFits.fit_from_data(*args)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jpsf_npz.save_psf(jpath, jfits.to_runtime_psf())
    tpsf_npz.save_psf(tpath, tfits.to_runtime_psf())
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files) and len(tz.files) == 28
        for key in jz.files:
            np.testing.assert_allclose(tz[key], jz[key], atol=1e-12, rtol=1e-12, err_msg=key)
    freqs = 0.1 + np.arange(200) / 199.0 * 9.9
    jd = jdiag.DiagnosticResults.compute(freqs, jfits.wx_fit.evaluate(freqs),
                                         jfits.wy_fit.evaluate(freqs))
    td = tdiag.DiagnosticResults.compute(freqs, tfits.wx_fit.evaluate(freqs),
                                         tfits.wy_fit.evaluate(freqs))
    for field in dataclasses.fields(jd):
        a, b = getattr(td, field.name), getattr(jd, field.name)
        if isinstance(b, (bool, np.bool_)):
            assert a == b, field.name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=field.name)
    assert td.summary() == jd.summary()
    img, ext = tvis.psf_image(tfits, 1.3, resolution=64)
    jimg, jext = jvis.psf_image(jfits, 1.3, resolution=64)
    np.testing.assert_allclose(img, jimg, atol=1e-12)
    np.testing.assert_allclose(ext, jext, atol=1e-12)


def test_cancellation_returns_none():
    m = _synthetic_knife_edge()
    calls = {"n": 0}

    def progress(_axis, _cur, _tot):
        calls["n"] += 1
        return calls["n"] < 3

    assert tapp.compute_psf(m, m, tapp.FilterParams(n_filters=4, start_freq=0.5, end_freq=2.0),
                            progress=progress, device="cpu") is None
    assert calls["n"] == 3


# ---------------------------------------------------------------- loader
def _write_knife_edge(path, positions, traces, times):
    import h5py

    with h5py.File(path, "w") as f:
        for pos, tr in zip(positions, traces):
            g = f.create_group(f"Beam Width Measurement x={pos:.2f}")
            g.create_dataset("ds1", data=np.stack([times, tr], axis=1))
    return path


def test_loader_and_split_match_jax(tmp_path):
    pos, traces, t = chip_smoke.knife_edge_traces(n_pos=21, n_time=128, seed=3)
    order = np.random.default_rng(0).permutation(21)  # groups out of order
    path = _write_knife_edge(str(tmp_path / "k.thz"), pos[order], traces[order], t)
    jm, tm = jdl.KnifeEdgeMeasurement.from_thz_file(path), tdl.KnifeEdgeMeasurement.from_thz_file(path)
    for name in ("positions", "time_traces", "times"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    for a, b in zip(tdl.split_and_flip(tm), jdl.split_and_flip(jm)):
        assert len(a.positions) == 10
        for name in ("positions", "time_traces"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# ---------------------------------------------------------------- the app
def _app_files(tmp_path, n_pos=60, n_time=512):
    paths = []
    for axis, scale in (("x", 1.0), ("y", 1.2)):
        pos, traces, t = chip_smoke.knife_edge_traces(n_pos, n_time, seed=len(paths),
                                                      width_scale=scale)
        paths.append(_write_knife_edge(str(tmp_path / f"{axis}.thz"), pos, traces, t))
    return paths


def test_app_runs_on_the_device_it_was_given(tmp_path, monkeypatch):
    seen = []
    real = tapp.compute_psf
    monkeypatch.setattr(tapp, "compute_psf", lambda *a: (seen.append(a[-1]), real(*a))[1])
    tool = tapp.PsfToolApp(device="cpu")
    tool.x_path, tool.y_path = _app_files(tmp_path)
    tool.filter_params.n_filters = 5
    assert tool.maybe_recompute() and not tool.maybe_recompute()
    tool.wait(120)
    assert not tool._thread.is_alive() and tool.error is None
    assert [d.type for d in seen] == ["cpu"]
    assert tool.result.curve_fits is not None and tool.diagnostics is not None
    assert tool.progress == {"x": (10, 10), "y": (10, 10)}
    out = str(tmp_path / "tool_psf")  # no suffix: the exact path is written
    assert tool.export_npz(out) and os.path.exists(out)
    psf = tpsf_npz.load_psf(out)
    assert psf.is_loaded and psf.fingerprint() == tool.runtime_psf().fingerprint()


def test_app_needs_cuda_unless_asked_for_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.PsfToolApp()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.compute_psf(_synthetic_knife_edge(), None, tapp.FilterParams(n_filters=3))


def test_app_stale_result_and_shutdown(tmp_path, monkeypatch):
    """A superseded run's result is dropped, and _shutdown cancels and joins
    every live compute thread."""
    gate = threading.Event()
    real = tapp.compute_psf

    def slow(x, y, fp, bp, progress, device):
        def gated(axis, cur, total):
            gate.wait(10)
            return progress(axis, cur, total)
        return real(x, y, fp, bp, gated, device)

    monkeypatch.setattr(tapp, "compute_psf", slow)
    tool = tapp.PsfToolApp(device="cpu")
    tool.x_path, _ = _app_files(tmp_path)
    tool.filter_params.n_filters = 3
    done = []
    tool.on_complete.append(done.append)
    tool.start_computation()
    first = tool._thread
    tool.filter_params.n_filters = 4
    tool.start_computation()  # cancels the first run
    gate.set()
    tool.wait(120)
    first.join(30)
    assert not first.is_alive() and not tool._thread.is_alive()
    assert len(done) == 1 and done[0].filters.shape[0] == 4
    assert tool.result.filters.shape[0] == 4
    gate.clear()
    tool.start_computation()
    tool._shutdown()  # the run waits on the gate, is cancelled and joined
    gate.set()
    tool._thread.join(30)
    assert not tool._thread.is_alive()
    assert tool.result.filters.shape[0] == 4  # the cancelled run set nothing


def test_app_persists_only_where_asked(tmp_path):
    tool = tapp.PsfToolApp(device="cpu")
    tool.filter_params.n_filters = 7
    tool.save_state()
    assert not os.path.exists(os.path.join(os.environ["XDG_CONFIG_HOME"]))
    d = str(tmp_path / "state")
    os.makedirs(d)
    tool = tapp.PsfToolApp(persist_dir=d, device="cpu")
    tool.filter_params.n_filters = 7
    tool.x_path = "/data/x.thz"
    tool.save_state()
    again = tapp.PsfToolApp(persist_dir=d, device="cpu")
    assert again.filter_params.n_filters == 7 and again.x_path == "/data/x.thz"
    tool.reset_parameters()
    assert tapp.PsfToolApp(persist_dir=d, device="cpu").filter_params == tapp.FilterParams()


def test_clamp_filter_params_matches_jax():
    for start, end, lo, hi in [(0.01, 30.0, 0.1, 10.0), (12.0, 0.0, 0.5, 4.0)]:
        j, t = japp.PsfToolApp(), tapp.PsfToolApp(device="cpu")
        for tool in (j, t):
            f = tool.filter_params
            f.start_freq, f.end_freq, f.low_cut, f.high_cut = start, end, lo, hi
            tool.clamp_filter_params()
        assert dataclasses.astuple(t.filter_params) == dataclasses.astuple(j.filter_params)


# -------------------------------------------- knife edge -> tool -> Apply
def test_knife_edge_to_apply_matches_jax(tmp_path):
    """Both packages fit a PSF from the same knife-edge traces, export and
    reload it, and Apply it to the same scan: the deconvolved image and
    series agree at 1e-3 of max."""
    mx = chip_smoke.knife_edge_traces(60, 512, seed=0)
    my = chip_smoke.knife_edge_traces(60, 512, seed=1, width_scale=1.2)
    params = dict(n_filters=8, start_freq=0.2, end_freq=3.0)
    jres = japp.compute_psf(jdl.KnifeEdgeMeasurement(*mx), jdl.KnifeEdgeMeasurement(*my),
                            japp.FilterParams(**params))
    tres = tapp.compute_psf(convert.knife_edge_from_numpy(*mx),
                            convert.knife_edge_from_numpy(*my), tapp.FilterParams(**params),
                            device="cpu")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jpsf_npz.save_psf(jpath, jres.curve_fits.to_runtime_psf())
    tpsf_npz.save_psf(tpath, tres.curve_fits.to_runtime_psf())
    t, raw = synthetic_scan(width=20, height=18, n_time=64, seed=9)
    scan = write_scan_thz(str(tmp_path / "s.thzimg"), t, raw, dx=1.0, dy=1.0)
    images, plots = [], []
    for ex, psf in ((JaxExplorer(), jpsf_npz.load_psf(jpath)),
                    (Explorer(device="cpu"), tpsf_npz.load_psf(tpath))):
        ex.open_file(scan)
        before = np.array(ex.image)
        ex.apply_psf(psf)
        for k, v in (("n_filters", 5.0), ("n_iterations", 10.0), ("start_freq", 0.25),
                     ("end_freq", 3.0)):
            ex.set_filter_param("deconvolution", k, v)
        ex.set_filter_active("deconvolution", True)
        ex.update_filter("deconvolution", force=True)
        assert not np.allclose(ex.image, before)
        images.append(np.array(ex.image))
        plots.append(ex.plot)
    (jimg, timg), (jp, tp) = images, plots
    np.testing.assert_allclose(timg, jimg, atol=DECONV_REL * np.abs(jimg).max(), rtol=0)
    for key in ("filtered_signal", "avg_signal", "avg_signal_fft", "filtered_signal_fft"):
        ref = getattr(jp, key)
        np.testing.assert_allclose(getattr(tp, key), ref, atol=DECONV_REL * np.abs(ref).max(),
                                   rtol=0, err_msg=key)
