"""The port's slice as a whole: dotTHz open -> filter chain -> publish ->
pixel click, through ``thz_image_explorer_tpu_torch``'s ``Explorer`` on the
CPU, against the JAX package's ``Explorer`` driven by the same commands.

Also the rules of the port itself: it imports nothing of JAX, its
entry point never falls back to the CPU, pass-through slots share tensors,
and a pixel click reuses the cached reductions.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from make_sample import synthetic_scan, write_scan_thz
from thz_image_explorer_tpu.io import dotthz as jdotthz
from thz_image_explorer_tpu.ops.windows import WindowType as JaxWindowType
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch.assets.water_lines import WATER_LINES_THZ
from thz_image_explorer_tpu_torch.io import dotthz as tdotthz
from thz_image_explorer_tpu_torch.ops import bandpass as bp
from thz_image_explorer_tpu_torch.ops.windows import WindowType as PortWindowType
from thz_image_explorer_tpu_torch.pipeline import Explorer, PlotData
from thz_image_explorer_tpu_torch.pipeline import publish as tpublish
from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline
from thz_image_explorer_tpu_torch.pipeline.stage import (
    FilterConfig,
    FilterDomain,
    FilterStage,
    instantiate_filters,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
# f32 chains through two different FFT libraries and summation orders
ATOL, RTOL = 5e-5, 1e-4

#: the command sequence: tests/test_specred.py's product sequence, then a
#: click, an ROI edit, the optical selection, avg-in-Fourier and 2x
#: downscaling; the published state is compared after every step
STEPS = [
    ("open", lambda ex, path: ex.open_file(path)),
    ("fd_filters", lambda ex, _: (ex.set_filter_active("frequency_band_pass", True),
                                  ex.set_filter_active("water_vapor_notch", True))),
    ("roi", lambda ex, _: ex.add_roi("u1", "r1", [(1, 1), (8, 1), (8, 8)])),
    ("pixel", lambda ex, _: ex.set_selected_pixel(3, 4)),
    ("window", lambda ex, _: ex.set_fft_window_low(1.1)),
    ("td_filters", lambda ex, _: (
        ex.set_filter_param("time_band_pass_before_fft", "low", 0.4),
        ex.set_filter_active("time_band_pass_before_fft", True),
        ex.set_filter_param("time_band_pass_after_fft", "high", 2.9),
        ex.set_filter_active("time_band_pass_after_fft", True))),
    ("optical", lambda ex, _: (
        ex.add_roi("u2", "r2", [(10, 2), (16, 2), (16, 9), (10, 9)]),
        ex.set_reference("r1"), ex.set_sample("Selected Pixel"))),
    ("click", lambda ex, _: ex.set_selected_pixel(12, 9)),
    ("roi_edit", lambda ex, _: ex.update_roi("u1", "r1", [(2, 2), (9, 1), (7, 10)])),
    ("optical_roi", lambda ex, _: (ex.set_sample("r2"), ex.set_material_thickness(0.002))),
    ("avg_fourier", lambda ex, _: ex.set_avg_in_fourier_space(True)),
    ("downscale", lambda ex, _: ex.set_downscaling(2)),
]


def _window(name):
    """``set_fft_window_type`` with each package's own enum member."""
    return lambda ex, _: ex.set_fft_window_type(
        (JaxWindowType if isinstance(ex, JaxExplorer) else PortWindowType)[name])


#: the commands STEPS skips, on a 19x13 scan (no 16-pixel multiple, and 3
#: divides neither side): the window's high edge and the four other window
#: types, an FD band-pass switched on, moved and switched off, two ROIs
#: of one name (the sample), clicks outside the grid, the reference ROI
#: deleted, downscaling by 3. The JAX loader runs without its shape buckets
#: here (THZ_SHAPE_BUCKET=1): with them it clamps a click to the padded
#: grid, keeps the scan's image shape after a downscale that does not divide
#: it, and gives another mean phase under the Blackman window (ROADMAP,
#: queue 3: JAX quirks the port does not follow).
STEPS_MORE = [
    ("open", lambda ex, path: ex.open_file(path)),
    ("rois_same_name", lambda ex, _: (
        ex.add_roi("u1", "ref", [(1, 1), (7, 1), (7, 6), (1, 6)]),
        ex.add_roi("u2", "twin", [(9, 2), (15, 2), (15, 9)]),
        ex.add_roi("u3", "twin", [(2, 8), (8, 8), (5, 12)]),
        ex.set_reference("ref"), ex.set_sample("twin"))),
    # the high edge of the adapted Blackman window (the other types span
    # the whole trace)
    ("window_high", lambda ex, _: ex.set_fft_window_high(2.6)),
    ("blackman", _window("BLACKMAN")),
    ("hanning", _window("HANNING")),
    ("hamming", _window("HAMMING")),
    ("flat_top", _window("FLAT_TOP")),
    ("fd_bandpass_on", lambda ex, _: ex.set_filter_active("frequency_band_pass", True)),
    ("fd_bandpass_param", lambda ex, _: (
        ex.set_filter_param("frequency_band_pass", "high", 1.5),
        ex.update_filter("frequency_band_pass"))),
    ("fd_bandpass_off", lambda ex, _: ex.set_filter_active("frequency_band_pass", False)),
    ("click_past_right", lambda ex, _: ex.set_selected_pixel(40, 5)),
    ("click_past_bottom", lambda ex, _: ex.set_selected_pixel(4, 30)),
    ("click_corner", lambda ex, _: (ex.set_sample("Selected Pixel"),
                                    ex.set_selected_pixel(18, 12))),
    ("delete_reference", lambda ex, _: ex.delete_roi("u1")),
    ("downscale_3", lambda ex, _: ex.set_downscaling(3)),
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
def scan_path(tmp_path_factory):
    t, raw = synthetic_scan(width=18, height=14, n_time=64)
    return write_scan_thz(str(tmp_path_factory.mktemp("scan") / "s.thzimg"), t, raw)


@pytest.fixture(scope="module")
def runs(scan_path):
    """Both Explorers driven through STEPS; a snapshot after each step."""
    out = {}
    for key, ex in (("jax", JaxExplorer()), ("port", Explorer(device="cpu"))):
        snaps = []
        for _name, step in STEPS:
            step(ex, scan_path)
            snaps.append(_snapshot(ex))
        out[key] = snaps
    return out


@pytest.fixture(scope="module")
def more_scan_path(tmp_path_factory):
    t, raw = synthetic_scan(width=19, height=13, n_time=64, seed=3)
    return write_scan_thz(str(tmp_path_factory.mktemp("scan") / "m.thzimg"), t, raw)


@pytest.fixture(scope="module")
def more_runs(more_scan_path):
    """Both Explorers driven through STEPS_MORE, the JAX one without its
    shape buckets; a snapshot after each step."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("THZ_SHAPE_BUCKET", "1")
        for key, ex in (("jax", JaxExplorer()), ("port", Explorer(device="cpu"))):
            snaps = []
            for _name, step in STEPS_MORE:
                step(ex, more_scan_path)
                snaps.append(_snapshot(ex))
            out[key] = snaps
    return out


@pytest.mark.parametrize("step", range(len(STEPS)), ids=[s[0] for s in STEPS])
def test_slice_matches_jax_explorer(runs, step):
    _assert_same(runs["jax"][step], runs["port"][step])


@pytest.mark.parametrize("step", range(len(STEPS_MORE)), ids=[s[0] for s in STEPS_MORE])
def test_more_commands_match_jax_explorer(more_runs, step):
    _assert_same(more_runs["jax"][step], more_runs["port"][step])


def test_more_commands_reach_their_state(more_runs):
    """The extra steps are not vacuous: the window's edge, each window type
    and the band-pass change the published spectra, the reference's
    deletion drops its trace, the out-of-grid clicks select different
    pixels, and the image keeps the downscale's 6x4 cells of 3x3."""
    names = [s[0] for s in STEPS_MORE]
    snaps = more_runs["port"]

    def at(name):
        return snaps[names.index(name)][0]

    for a, b in zip(names[1:6], names[2:7]):
        assert not np.array_equal(at(a)["avg_signal_fft"], at(b)["avg_signal_fft"]), (a, b)
    assert not np.array_equal(at("fd_bandpass_on")["filtered_signal_fft"],
                              at("fd_bandpass_param")["filtered_signal_fft"])
    assert set(at("rois_same_name")["roi_signal"]) == {"u1", "u2", "u3"}
    assert set(at("delete_reference")["roi_signal"]) == {"u2", "u3"}
    assert np.isfinite(at("rois_same_name")["refractive_index"][1:]).all()
    assert not np.array_equal(at("click_past_right")["signal"], at("click_past_bottom")["signal"])
    assert snaps[-1][1].shape == (18, 12)


def _assert_same(jsnap, tsnap):
    (jplot, jimg), (tplot, timg) = jsnap, tsnap
    np.testing.assert_allclose(timg, jimg, atol=ATOL, rtol=RTOL, err_msg="image")
    for name in _SERIES:
        j, t = jplot[name], tplot[name]
        if isinstance(j, dict):
            assert list(t) == list(j), name
            for uuid in j:
                assert t[uuid][0] == j[uuid][0]
                np.testing.assert_allclose(t[uuid][1], j[uuid][1], atol=ATOL,
                                           rtol=RTOL, err_msg=f"{name}[{uuid}]")
        elif isinstance(j, np.ndarray):
            assert t.shape == j.shape, name
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL, err_msg=name)
        else:
            assert t == j, name


def test_sequence_reaches_every_published_series(runs):
    """The parity steps are not vacuous: optical series and ROI traces
    are populated and the downscaled image keeps the scan's shape."""
    plot, img = runs["port"][-1]
    assert plot["refractive_index"].shape == (33,)
    assert set(plot["roi_signal"]) == {"u1", "u2"}
    assert img.shape == (18, 14)


# ------------------------------------------------------------ port rules
def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "thz_image_explorer_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "thz_image_explorer_tpu"), (path, name)


def test_explorer_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Explorer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Explorer(device="cuda")
    assert Explorer(device="cpu").device.type == "cpu"


def _opened(scan_path):
    ex = Explorer(device="cpu")
    ex.open_file(scan_path)
    return ex


def test_pass_through_slots_share_tensors(scan_path):
    p = _opened(scan_path).pipeline
    chain = p.chain
    assert chain == ["initial", "scaling", "tilt_compensation", "time_band_pass_before_fft",
                     "fft", "frequency_band_pass", "water_vapor_notch", "ifft",
                     "time_band_pass_after_fft", "deconvolution"]
    # scale 1 and every filter inactive: identity stages pass the object on
    for i in (1, 2, 3, 5, 6, 8, 9):
        assert p.slots[i] is p.slots[i - 1], chain[i]
    assert p.slots[7].fft is p.slots[4].fft  # the iFFT keeps the spectrum


def test_dirty_index_reruns_only_downstream(scan_path):
    p = _opened(scan_path).pipeline
    before, epoch = list(p.slots), p.run_epoch
    p.filters["frequency_band_pass"].active = True
    p.update_filter("frequency_band_pass")
    k = p.index_of("frequency_band_pass")
    assert all(p.slots[i] is before[i] for i in range(k))
    assert p.slots[k] is not before[k] and p.run_epoch == epoch + 1
    assert {"fft", "ifft", "frequency_band_pass"} <= set(p.timings_ms)


def test_click_reuses_the_cached_reductions(scan_path, monkeypatch):
    calls = []
    real = tpublish.reduce_slots

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tpublish, "reduce_slots", counting)
    ex = _opened(scan_path)
    ex.add_roi("u1", "r1", [(1, 1), (8, 1), (8, 8)])
    n = len(calls)
    first = ex.plot.signal.copy()
    ex.set_selected_pixel(9, 7)  # a click: gathers and optical math only
    ex.set_reference("r1")
    ex.set_sample("Selected Pixel")
    assert len(calls) == n
    assert not np.array_equal(ex.plot.signal, first)
    ex.update_roi("u1", "r1", [(2, 2), (8, 1), (8, 8)])  # new ROI set
    assert len(calls) == n + 1
    ex.set_fft_window_low(1.2)  # a chain run
    assert len(calls) == n + 2


def _fd_on(scan_path):
    """An opened pipeline with the FD band-pass and the notch on, each
    ``fd_weight_vector`` wrapped in a call counter, before their run."""
    p = _opened(scan_path).pipeline
    calls = {}
    for uuid, params in (("frequency_band_pass", dict(low=0.3, high=2.0)),
                         ("water_vapor_notch", dict(notch_width=0.05, depth=0.8))):
        stage = p.filters[uuid]
        for key, value in params.items():
            setattr(stage, key, value)
        stage.active = True
        calls[uuid] = 0

        def counted(freq, _real=stage.fd_weight_vector, _uuid=uuid):
            calls[_uuid] += 1
            return _real(freq)

        stage.fd_weight_vector = counted
    return p, calls


def test_each_fd_weight_is_built_once_a_run(scan_path, monkeypatch):
    """One run calls each active FD stage's ``fd_weight_vector`` once, and
    ``ops/bandpass`` builds each weight once (not again for an ``apply``)."""
    p, calls = _fd_on(scan_path)
    for name in ("fd_bandpass_weights", "water_notch_weights"):
        calls[name] = 0

        def counted(*a, _real=getattr(bp, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(bp, name, counted)
    p.run_from(p.index_of("frequency_band_pass"))
    assert set(calls.values()) == {1}, calls
    p.run_from(1)
    assert set(calls.values()) == {2}, calls


def test_fd_slots_and_published_weight_are_the_weights_products(scan_path):
    """Bit for bit: the publish's weight is the product of freshly built
    weights, and each FD slot is its input's spectrum and amplitudes times
    its weight, as ``ops/bandpass``'s one-line products give them."""
    p, _ = _fd_on(scan_path)
    p.run_from(1)
    i, j = p.index_of("frequency_band_pass"), p.index_of("water_vapor_notch")
    fbp, notch = p.filters["frequency_band_pass"], p.filters["water_vapor_notch"]
    freq = p.slots[p.fft_index].freq
    w_fbp, w_notch = fbp.fd_weight_vector(freq), notch.fd_weight_vector(freq)
    assert not torch.equal(w_fbp, torch.ones_like(w_fbp))
    assert not torch.equal(w_notch, torch.ones_like(w_notch))
    spec, w = p.spectral_source()
    assert spec is p.slots[p.fft_index]
    assert torch.equal(w, torch.ones_like(w_fbp) * w_fbp * w_notch)
    for k, wk in ((i, w_fbp), (j, w_notch)):
        inp, out = p.slots[k - 1], p.slots[k]
        assert torch.equal(out.fft, inp.fft * wk) and torch.equal(out.amplitudes,
                                                                  inp.amplitudes * wk)
        assert out.phases is inp.phases and out.data is inp.data
    inp = p.slots[i - 1]
    want = bp.fd_bandpass(inp.fft, inp.amplitudes, inp.freq, fbp.low, fbp.high,
                          fbp.window_width)
    assert all(torch.equal(a, b) for a, b in zip((p.slots[i].fft, p.slots[i].amplitudes),
                                                 want))
    inp = p.slots[j - 1]
    lines = torch.as_tensor(np.asarray(WATER_LINES_THZ, np.float32))
    want = bp.water_notch(inp.fft, inp.amplitudes, inp.freq, lines, notch.notch_width,
                          notch.depth)
    assert all(torch.equal(a, b) for a, b in zip((p.slots[j].fft, p.slots[j].amplitudes),
                                                 want))


class _OpaqueFD(FilterStage):
    """A frequency-domain stage that does not expose its weight vector."""

    uuid = "opaque_fd"

    def __init__(self):
        self.active = True

    def config(self):
        return FilterConfig("Opaque", "test stage", FilterDomain.FREQUENCY)

    def apply(self, cube, context):
        return cube.replace(amplitudes=cube.amplitudes * 0.5, fft=cube.fft * 0.5)


def test_publish_refuses_an_fd_stage_without_weight_vector(scan_path):
    filters = instantiate_filters()
    filters["opaque_fd"] = _OpaqueFD()
    p = Pipeline("cpu", filters=filters)
    host = tdotthz.open_scan_host(scan_path)
    cube, _ = tdotthz.finalize_scan(host, "cpu")
    p.set_input(cube)
    masks = torch.zeros((0, 18, 14))
    with pytest.raises(NotImplementedError, match="fd_weight_vector"):
        tpublish.Publisher().publish(p, masks, (), (0, 0))


def test_filter_params_from_numpy():
    filters = convert.filter_params_from_numpy({
        "frequency_band_pass": {"low": np.float32(0.5), "active": np.bool_(True)},
        "water_vapor_notch": {"depth": np.asarray(0.25, np.float32)},
    })
    fbp = filters["frequency_band_pass"]
    assert (fbp.low, fbp.active) == (0.5, True) and type(fbp.low) is float
    assert filters["water_vapor_notch"].depth == 0.25
    with pytest.raises(AttributeError, match="no parameter"):
        convert.filter_params_from_numpy({"water_vapor_notch": {"bogus": 1.0}})


def test_dotthz_read_matches_jax_and_round_trips(scan_path, tmp_path, monkeypatch):
    monkeypatch.setenv("THZ_SHAPE_BUCKET", "1")  # the JAX loader's padding off
    jhost = jdotthz.open_scan_host(scan_path)
    thost = tdotthz.open_scan_host(scan_path)
    np.testing.assert_array_equal(thost.time, jhost.time)
    np.testing.assert_array_equal(thost.data, jhost.data)
    assert thost.valid_wh == tuple(jhost.valid_wh)
    assert (thost.dx, thost.dy, thost.x_min, thost.y_min) == (
        jhost.dx, jhost.dy, jhost.x_min, jhost.y_min)
    assert dataclasses.asdict(thost.metadata) == dataclasses.asdict(jhost.metadata)

    # save with ROIs, reopen: same scan, same ROIs, same published series
    ex = _opened(scan_path)
    ex.add_roi("u1", "r1", [(1, 1), (8, 1), (8, 8)])
    out = str(tmp_path / "saved.thzimg")
    ex.save_file(out)
    again = Explorer(device="cpu")
    again.open_file(out)
    assert [v for v in again.rois.values()] == [("r1", [(1, 1), (8, 1), (8, 8)])]
    np.testing.assert_array_equal(again.plot.avg_signal_fft, ex.plot.avg_signal_fft)

    # the in-memory open takes the same path as the file open
    mem = Explorer(device="cpu")
    mem.open_arrays(thost.time, thost.data, thost.metadata)
    np.testing.assert_array_equal(mem.image, _opened(scan_path).image)
    assert mem.housekeeping == _opened(scan_path).housekeeping
