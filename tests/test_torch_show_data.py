"""The ``show_data`` preview hook on a pixel click, and the public names the
port shares with the JAX package, on the CPU.

* an overriding stage, registered in both packages for the test only (a
  fixture takes it out of both registries), sees the same pixel exactly and
  the same final slot (``data``, ``fft``, ``amplitudes``, ``phases``) at the
  main path's tolerance (atol 5e-5, rtol 1e-4) when the JAX ``Explorer``
  (at ``THZ_SHAPE_BUCKET=1``: no bucket padding) and the port's
  ``Explorer("cpu")`` take the same commands: clicks, a downscale to 3, a
  click past the grid's edge, a negative click;
* ``Pipeline.materialize_output`` returns the final slot itself: no stage
  runs and no stage's ms changes;
* with no overriding stage a click never calls ``materialize_output``, and
  the hook's presence makes a click no chain run;
* ``pipeline.stage.registered_filters`` (a copy of the registry, the JAX
  names), ``utils.settings.PsfToolState`` (also at its old import path).
"""

import numpy as np
import pytest

from make_sample import synthetic_scan, write_scan_thz
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu.pipeline import stage as jstage
from thz_image_explorer_tpu.utils import settings as jsettings
from thz_image_explorer_tpu_torch import pipeline as tpipeline
from thz_image_explorer_tpu_torch.pipeline import Explorer
from thz_image_explorer_tpu_torch.pipeline import stage as tstage
from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline

ATOL, RTOL = 5e-5, 1e-4
FIELDS = ("data", "fft", "amplitudes", "phases")
UUID = "show_data_probe"

#: the commands after the open (the FD band-pass and the notch on, so the
#: spectra differ from the raw FFT): each click calls the hook
STEPS = [
    ("click", lambda ex: ex.set_selected_pixel(5, 7)),
    ("downscale3", lambda ex: ex.set_downscaling(3)),
    ("click_downscaled", lambda ex: ex.set_selected_pixel(11, 4)),
    ("click_past_edge", lambda ex: ex.set_selected_pixel(40, 1000)),
    ("click_negative", lambda ex: ex.set_selected_pixel(-3, 8)),
]
#: the pixel each click must hand the hook: the final slot's downscaled
#: coordinates, clamped to its valid region (19x13 at scale 3: 6x4)
WANT_PIXELS = [(5, 7), (3, 1), (5, 3), (0, 2)]


def _probe(stage_module, record):
    """An inactive stage of ``stage_module``'s package whose ``show_data``
    records what it is given as numpy."""

    class ShowDataProbe(stage_module.FilterStage):
        uuid = UUID

        def __init__(self):
            self.active = False

        def config(self):
            return stage_module.FilterConfig("Show-data probe", "records show_data calls",
                                             stage_module.FilterDomain.TIME_AFTER_FFT)

        def apply(self, cube, context):
            return cube

        def show_data(self, cube, pixel):
            record.append((tuple(pixel), {f: np.array(getattr(cube, f)) for f in FIELDS}))

    return ShowDataProbe


@pytest.fixture()
def probes():
    """The probe registered in both packages; out of both registries after
    the test."""
    seen = {"jax": [], "port": []}
    jstage.register_filter(_probe(jstage, seen["jax"]))
    tstage.register_filter(_probe(tstage, seen["port"]))
    try:
        yield seen
    finally:
        jstage._REGISTRY.pop(UUID, None)
        tstage._REGISTRY.pop(UUID, None)


@pytest.fixture(scope="module")
def scan_path(tmp_path_factory):
    t, raw = synthetic_scan(width=19, height=13, n_time=64, seed=5)
    return write_scan_thz(str(tmp_path_factory.mktemp("scan") / "s.thzimg"), t, raw)


def _opened(ex, path):
    ex.open_file(path)
    ex.set_filter_active("frequency_band_pass", True)
    ex.set_filter_active("water_vapor_notch", True)
    return ex


def test_hook_gets_the_jax_pixel_and_slot(probes, scan_path, monkeypatch):
    monkeypatch.setenv("THZ_SHAPE_BUCKET", "1")
    for key, ex in (("jax", JaxExplorer()), ("port", Explorer(device="cpu"))):
        assert UUID in ex.pipeline.filters
        _opened(ex, scan_path)
        for _name, step in STEPS:
            step(ex)
    jax_seen, port_seen = probes["jax"], probes["port"]
    assert [p for p, _ in port_seen] == WANT_PIXELS
    assert [p for p, _ in jax_seen] == WANT_PIXELS
    for (_, j), (_, t), name in zip(jax_seen, port_seen, [s[0] for s in STEPS if "click" in s[0]]):
        for f in FIELDS:
            assert t[f].shape == j[f].shape, (name, f)
            np.testing.assert_allclose(t[f], j[f], atol=ATOL, rtol=RTOL, err_msg=f"{name} {f}")
    # the downscale reached the hook's slot
    assert port_seen[1][1]["data"].shape[:2] == (6, 4) and port_seen[0][1]["data"].shape[:2] == (19, 13)


def test_materialize_output_is_the_final_slot(scan_path, monkeypatch):
    ex = _opened(Explorer(device="cpu"), scan_path)
    p = ex.pipeline
    before, epoch, ms = list(p.slots), p.run_epoch, p.timings_ms
    runs = []
    monkeypatch.setattr(Pipeline, "_run_stage", lambda *a, **k: runs.append(a))
    out = p.materialize_output()
    assert out is p.output and out is before[-1]
    assert all(getattr(out, f) is not None for f in FIELDS)
    assert out.fft.shape == out.amplitudes.shape == out.phases.shape == (19, 13, 33)
    assert not runs and p.run_epoch == epoch and p.slots == before and p.timings_ms == ms


def test_click_without_hook_never_materializes(scan_path, monkeypatch):
    calls = []
    real = Pipeline.materialize_output
    monkeypatch.setattr(Pipeline, "materialize_output",
                        lambda self: (calls.append(1), real(self))[1])
    ex = _opened(Explorer(device="cpu"), scan_path)
    assert not any(type(f).show_data is not tstage.FilterStage.show_data
                   for f in ex.pipeline.filters.values())
    epoch = ex.pipeline.run_epoch
    for x, y in ((3, 4), (40, 2), (-1, 5)):
        ex.set_selected_pixel(x, y)
    assert calls == [] and ex.pipeline.run_epoch == epoch


def test_click_with_hook_materializes_once_and_runs_no_stage(probes, scan_path, monkeypatch):
    ex = _opened(Explorer(device="cpu"), scan_path)
    calls = []
    real = Pipeline.materialize_output
    monkeypatch.setattr(Pipeline, "materialize_output",
                        lambda self: (calls.append(1), real(self))[1])
    epoch = ex.pipeline.run_epoch
    ex.set_selected_pixel(2, 3)
    ex.set_selected_pixel(4, 1)
    assert calls == [1, 1] and ex.pipeline.run_epoch == epoch
    assert [p for p, _ in probes["port"]] == [(2, 3), (4, 1)]


# ------------------------------------------------------------ public names
def test_registered_filters_is_a_copy_with_the_jax_names():
    got = tstage.registered_filters()
    assert got == tstage._REGISTRY and got is not tstage._REGISTRY
    got.pop("deconvolution")
    assert "deconvolution" in tstage._REGISTRY
    assert set(tstage.registered_filters()) == set(jstage.registered_filters())
    assert tpipeline.registered_filters is tstage.registered_filters
    assert all(issubclass(c, tstage.FilterStage) for c in tstage.registered_filters().values())


def test_psf_tool_state_lives_in_settings(tmp_path):
    from thz_image_explorer_tpu_torch import utils
    from thz_image_explorer_tpu_torch.psf_tool import app
    from thz_image_explorer_tpu_torch.utils import settings

    assert settings.PsfToolState.__module__ == settings.__name__
    assert app.PsfToolState is settings.PsfToolState is utils.PsfToolState
    st = settings.PsfToolState(knife_edge_y_path="/x/y.thz", n_filters=12, win_width=0.75)
    st.save(str(tmp_path))
    assert settings.PsfToolState.load(str(tmp_path)) == st
    # the same fields and defaults as the JAX package's
    assert jsettings.PsfToolState().__dict__ == settings.PsfToolState().__dict__
