"""The Explorer's remaining commands in the port against the JAX package, on
the CPU: ``open_ref`` and pseudo-ROIs in the optical n/alpha/kappa (a loaded
pulse as the reference and as the sample, and its skip with one warning once
a tilt changes the scan's bin count), the metadata commands on a ``.thz``
file read back by JAX's I/O, sibling navigation, and the plot settings.

``STEPS_REF`` drives both Explorers (the JAX one at ``THZ_SHAPE_BUCKET=1``)
and compares every published series after each step at the main path's
tolerance (atol 5e-5, rtol 1e-4).
"""

import dataclasses
import logging
import os

import numpy as np
import pytest

from make_sample import synthetic_scan, write_pulse_thz, write_scan_thz
from thz_image_explorer_tpu.io import dotthz as jdotthz
from thz_image_explorer_tpu.io import files as jfiles
from thz_image_explorer_tpu.pipeline import Explorer as JaxExplorer
from thz_image_explorer_tpu.pipeline import explorer as jexplorer
from thz_image_explorer_tpu_torch.io import dotthz as tdotthz
from thz_image_explorer_tpu_torch.io import files as tfiles
from thz_image_explorer_tpu_torch.pipeline import Explorer, PlotData
from thz_image_explorer_tpu_torch.pipeline import explorer as texplorer
from thz_image_explorer_tpu_torch.pipeline import publish as tpublish

ATOL, RTOL = 5e-5, 1e-4
TILT = "tilt_compensation"
_SERIES = [f.name for f in dataclasses.fields(PlotData)]


def _pulses(tmp):
    """Two reference pulses: one on the scan's own axis, one that starts
    0.4 ps later and is 10 samples shorter (aligned by offset, zero-filled)."""
    t, raw = synthetic_scan(width=18, height=16, n_time=64, seed=8)
    trace = raw.mean(axis=(0, 1)) - raw.mean(axis=(0, 1))[0]
    p0 = write_pulse_thz(str(tmp / "ref0.thz"), t, 1.2 * trace)
    t1 = (t[8:-2]).astype(np.float32)
    p1 = write_pulse_thz(str(tmp / "ref1.thz"), t1, 0.8 * trace[8:-2])
    return t, raw, p0, p1


STEPS_REF = [
    ("open", lambda ex, a: ex.open_file(a["scan"])),
    ("rois", lambda ex, a: (ex.add_roi("u1", "r1", [(1, 1), (8, 1), (8, 7), (1, 7)]),
                            ex.add_roi("u2", "r2", [(10, 8), (16, 8), (13, 14)]))),
    ("open_ref", lambda ex, a: ex.open_ref(a["ref0"])),
    ("ref_pulse_pixel", lambda ex, a: (ex.set_reference("Reference File"),
                                       ex.set_sample("Selected Pixel"),
                                       ex.set_selected_pixel(12, 10))),
    ("sample_roi", lambda ex, a: ex.set_sample("r2")),
    ("open_second_ref", lambda ex, a: ex.open_ref(a["ref1"])),
    ("sample_pulse", lambda ex, a: (ex.set_reference("r1"), ex.set_sample("Reference File 1"))),
    ("both_pulses", lambda ex, a: (ex.set_reference("Reference File"),
                                   ex.set_material_thickness(0.002))),
    ("pseudo_entry", lambda ex, a: ex.add_roi("p1", "draft", None)),
    ("pseudo_deleted", lambda ex, a: ex.delete_roi("p1")),
    ("window", lambda ex, a: ex.set_fft_window_low(1.2)),
    ("tilt_skips_pulses", lambda ex, a: (ex.set_filter_param(TILT, "tilt_x", 3.0),
                                         ex.set_filter_active(TILT, True))),
    ("tilt_click", lambda ex, a: ex.set_selected_pixel(3, 3)),
    ("tilt_off", lambda ex, a: ex.set_filter_active(TILT, False)),
    ("fft_resolution", lambda ex, a: (ex.set_fft_resolution(0.5), ex.set_fft_log_plot(True))),
    ("material_update", lambda ex, a: ex.update_material_calculation()),
    ("delete_ref", lambda ex, a: ex.delete_roi(next(
        u for u, (n, _p) in ex.rois.items() if n == "Reference File"))),
]


def _snapshot(ex):
    """The published state; ROIs keyed by the uuid the steps gave them, and
    the pulses (whose uuids each Explorer draws at random) by their names."""
    plot = {}
    for name in _SERIES:
        v = getattr(ex.plot, name)
        if isinstance(v, dict):
            v = {(u if len(u) < 8 else n): (n, np.array(a)) for u, (n, a) in v.items()}
        elif isinstance(v, np.ndarray):
            v = np.array(v)
        plot[name] = v
    return plot, np.array(ex.image)


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    t, raw, p0, p1 = _pulses(tmp)
    args = {"scan": write_scan_thz(str(tmp / "s.thzimg"), t, raw, dx=1.0, dy=1.0),
            "ref0": p0, "ref1": p1}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("THZ_SHAPE_BUCKET", "1")
        for key, ex in (("jax", JaxExplorer()), ("port", Explorer(device="cpu"))):
            out[key] = [(step(ex, args), _snapshot(ex))[1] for _n, step in STEPS_REF]
    return out


@pytest.mark.parametrize("step", range(len(STEPS_REF)), ids=[s[0] for s in STEPS_REF])
def test_ref_steps_match_jax_explorer(ref_runs, step):
    (jplot, jimg), (tplot, timg) = ref_runs["jax"][step], ref_runs["port"][step]
    np.testing.assert_allclose(timg, jimg, atol=ATOL, rtol=RTOL, err_msg="image")
    for name in _SERIES:
        j, t = jplot[name], tplot[name]
        if isinstance(j, dict):
            assert sorted(t) == sorted(j), name
            for key in j:
                assert t[key][0] == j[key][0]
                np.testing.assert_allclose(t[key][1], j[key][1], atol=ATOL, rtol=RTOL,
                                           err_msg=f"{name}[{key}]")
        elif isinstance(j, np.ndarray):
            assert t.shape == j.shape, name
            # n/alpha/kappa divide by omega = 0 at the DC bin in both
            np.testing.assert_allclose(np.nan_to_num(t), np.nan_to_num(j), atol=ATOL,
                                       rtol=RTOL, err_msg=name)
        else:
            assert t == j, name


def test_ref_steps_reach_their_state(ref_runs):
    """The optical series exist where a pulse resolves and are empty where
    the tilt changed the bin count; the pulses are ROIs of the plot."""
    names = [s[0] for s in STEPS_REF]
    snaps = ref_runs["port"]

    def at(name):
        return snaps[names.index(name)][0]

    for name in ("ref_pulse_pixel", "sample_roi", "sample_pulse", "both_pulses", "tilt_off"):
        assert at(name)["refractive_index"].shape == (33,), name
        assert np.isfinite(at(name)["refractive_index"][1:]).all(), name
    assert at("tilt_skips_pulses")["refractive_index"].shape == (0,)
    assert at("tilt_click")["refractive_index"].shape == (0,)
    assert "Reference File 1" in at("open_second_ref")["roi_signal"]
    assert "draft" in at("pseudo_entry")["available_references"]
    assert "draft" not in at("pseudo_deleted")["available_references"]
    assert not np.allclose(at("sample_roi")["refractive_index"][1:],
                           at("both_pulses")["refractive_index"][1:])


def test_mismatched_pulse_warns_once(tmp_path, caplog):
    t, raw, p0, _p1 = _pulses(tmp_path)
    ex = Explorer(device="cpu")
    ex.open_arrays(t, raw, tdotthz.DotthzMetadata(md={"dx [mm]": "1.0", "dy [mm]": "1.0"}))
    ex.open_ref(p0)
    ex.add_roi("u1", "r1", [(1, 1), (8, 1), (8, 7)])
    ex.set_reference("Reference File")
    ex.set_sample("r1")
    assert ex.plot.refractive_index.shape == (33,)
    with caplog.at_level(logging.WARNING, logger=texplorer.__name__):
        ex.set_filter_param(TILT, "tilt_x", 3.0)
        ex.set_filter_active(TILT, True)
        for px in range(4):
            ex.set_selected_pixel(px, 1)
        ex.set_fft_window_low(1.3)
    skipped = [r for r in caplog.records if "skipped" in r.getMessage()]
    assert len(skipped) == 1 and "Reference File" in skipped[0].getMessage()
    assert ex.plot.refractive_index.shape == (0,)


def test_array_seam_equals_the_file_open(tmp_path):
    t, raw, p0, p1 = _pulses(tmp_path)
    by_file, by_array = Explorer(device="cpu"), Explorer(device="cpu")
    for ex in (by_file, by_array):
        ex.open_arrays(t, raw)
    by_file.open_ref(p1)
    time, signal, _md = tdotthz.open_pulse(p1)
    by_array.open_ref_arrays(time, signal)
    (u1, e1), (u2, e2) = list(by_file._datasets.items())[0], list(by_array._datasets.items())[0]
    for a, b in zip(e1, e2):
        np.testing.assert_array_equal(a, b)
    assert by_file.rois[u1] == by_array.rois[u2] == ("Reference File", None)


def test_open_ref_without_a_scan():
    """A pulse opened first bootstraps a 1x1 zero scan on its own axis, in
    both packages."""
    t = (np.arange(48) * 0.05).astype(np.float32)
    sig = np.exp(-((t - 1.0) ** 2) / 0.1).astype(np.float32)
    ex = Explorer(device="cpu")
    ex.open_ref_arrays(t, sig)
    assert ex.pipeline.input.data.shape == (1, 1, 48)
    assert list(ex.plot.roi_signal_fft.values())[0][1].shape == (25,)


ALIGN_CASES = {
    "same_axis": (np.arange(64) * 0.05, 64),
    "later_start": (np.arange(50) * 0.05 + 0.4, 64),
    "earlier_start": (np.arange(80) * 0.05 - 0.75, 64),
    "other_dt": (np.arange(40) * 0.07 + 0.1, 64),
    "longer": (np.arange(90) * 0.05, 64),
    "one_sample_scan": (np.arange(12) * 0.05, 1),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_align_reference_matches_jax(case):
    time, n_scan = ALIGN_CASES[case]
    time = time.astype(np.float32)
    scan_time = (np.arange(n_scan) * 0.05).astype(np.float32)
    signal = np.sin(np.arange(len(time)) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(texplorer._align_reference(signal, time, scan_time),
                                  jexplorer._align_reference(signal, time, scan_time))


# ------------------------------------------------------------- metadata
def test_metadata_round_trip_against_jax_io(tmp_path):
    t, raw = synthetic_scan(width=12, height=10, n_time=32, seed=2)
    path = write_scan_thz(str(tmp_path / "m.thz"), t, raw, extra_md={"T [C]": "21.5"})
    ex = Explorer(device="cpu")
    ex.open_file(path)
    assert dataclasses.asdict(ex.load_metadata(path)) == dataclasses.asdict(
        jdotthz.load_metadata(path))
    ex.set_metadata_field("description", "edited scan")
    ex.set_metadata_field("md", "ignored")  # the dict itself is not a field
    ex.set_metadata_attr("Operator", "A. N. Other")
    ex.delete_metadata_attr("T [C]")
    ex.add_roi("u1", "edge", [(1, 1), (5, 1), (5, 4)])
    ex.add_roi("p1", "draft", None)  # a pseudo entry is not written
    ex.update_metadata()
    ex.save_rois(path)
    back = jdotthz.load_metadata(path)
    assert back.description == "edited scan"
    assert back.md["Operator"] == "A. N. Other" and "T [C]" not in back.md
    assert back.get_rois() == [("edge", [(1, 1), (5, 1), (5, 4)])]
    assert dataclasses.asdict(tdotthz.load_metadata(path)) == dataclasses.asdict(back)
    # revert drops unsaved edits
    ex.set_metadata_attr("Operator", "someone else")
    ex.revert_metadata()
    assert ex.metadata.md["Operator"] == "A. N. Other"
    # a file whose only group is not "Image": both packages resolve the same
    other = str(tmp_path / "other.thz")
    import h5py

    with h5py.File(other, "w") as f:
        g = f.create_group("Measurement")
        tdotthz.write_group_metadata(g, tdotthz.DotthzMetadata(description="x", md={"a": "1"}))
    md = tdotthz.load_metadata(other)
    md.md["b"] = "2"
    tdotthz.update_metadata(other, md)
    assert jdotthz.load_metadata(other).md == {"a": "1", "b": "2"}


def test_open_pulse_matches_jax(tmp_path):
    t = (np.arange(30) * 0.05).astype(np.float32)
    path = write_pulse_thz(str(tmp_path / "p.thz"), t, np.cos(t).astype(np.float32))
    for a, b in zip(tdotthz.open_pulse(path)[:2], jdotthz.open_pulse(path)[:2]):
        np.testing.assert_array_equal(a, b)
    scan = write_scan_thz(str(tmp_path / "s.thz"), t, np.zeros((2, 2, 30), np.float32))
    with pytest.raises(ValueError, match="no 2-D dataset"):
        tdotthz.open_pulse(scan)


# ------------------------------------------------------------- siblings
def test_sibling_navigation(tmp_path):
    t, raw = synthetic_scan(width=10, height=8, n_time=32, seed=1)
    paths = [write_scan_thz(str(tmp_path / f"{c}.thzimg"), t, raw * (i + 1))
             for i, c in enumerate("bca")]
    (tmp_path / "notes.txt").write_text("not a scan")
    ex = Explorer(device="cpu")
    assert ex.sibling_files() == []
    ex.open_sibling(1)  # nothing open: no-op
    ex.open_file(paths[0])  # b
    want = jfiles.find_files_with_same_extension(paths[0])
    assert ex.sibling_files() == want == tfiles.find_files_with_same_extension(paths[0])
    assert [os.path.basename(p) for p in want] == ["a.thzimg", "b.thzimg", "c.thzimg"]
    ex.open_sibling(1)
    assert os.path.basename(ex.file_path) == "c.thzimg"
    ex.open_sibling(1)  # wraps around
    assert os.path.basename(ex.file_path) == "a.thzimg"
    ex.open_sibling(-1)
    assert os.path.basename(ex.file_path) == "c.thzimg"
    assert tfiles.find_files_with_same_extension(str(tmp_path / "noext")) == []


def test_plot_settings_and_publish_key(monkeypatch):
    t, raw = synthetic_scan(width=10, height=8, n_time=32, seed=1)
    ex = Explorer(device="cpu")
    ex.open_arrays(t, raw)
    epoch = ex.pipeline.run_epoch
    ex.set_fft_log_plot(True)
    ex.set_fft_resolution(0.25)
    ex.update_material_calculation()
    cfg = ex.pipeline.config
    assert (cfg.fft_log_plot, cfg.fft_df) == (True, 0.25) and ex.pipeline.run_epoch == epoch
    # a pseudo entry takes part in the key of the publisher's cache
    calls = []
    real = tpublish.reduce_slots
    monkeypatch.setattr(tpublish, "reduce_slots", lambda *a, **k: (calls.append(1),
                                                                    real(*a, **k))[1])
    ex.set_selected_pixel(2, 2)
    assert calls == []
    ex.add_roi("p1", "draft", None)
    ex.add_roi("p1", "renamed", None)
    ex.delete_roi("p1")
    assert len(calls) == 3
