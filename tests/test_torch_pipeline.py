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
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch.io import dotthz as tdotthz
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


@pytest.mark.parametrize("step", range(len(STEPS)), ids=[s[0] for s in STEPS])
def test_slice_matches_jax_explorer(runs, step):
    (jplot, jimg), (tplot, timg) = runs["jax"][step], runs["port"][step]
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
    assert chain == ["initial", "scaling", "time_band_pass_before_fft", "fft",
                     "frequency_band_pass", "water_vapor_notch", "ifft",
                     "time_band_pass_after_fft"]
    # scale 1 and every filter inactive: identity stages pass the object on
    for i in (1, 2, 4, 5, 7):
        assert p.slots[i] is p.slots[i - 1], chain[i]
    assert p.slots[6].fft is p.slots[3].fft  # the iFFT keeps the spectrum


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
