"""Steps that return an output, on the CPU at tiny sizes: an output added by
files alone is read and limited; the page's 3-D view (``WebApp.voxels``)
agrees with the plain reference's voxels through ``outputs/view3d.py``, in
both fetch formats, with ties at the top and traces under the threshold;
its control does not; the publish's numbers are the ones read before
outputs existed."""

from __future__ import annotations

import base64
import json
import time

import numpy as np
import pytest
import torch
from conftest import REPO, SEED, tiny_config

from portbench import cell as cellmod
from portbench import check, control
from portbench.reference import Reference
from portbench.session import Session
from portbench.spec import Spec

#: a contrast slider step and a read-back of the Explorer's settings through
#: ``worker.call``, judged by a new output ``settings_echo``
ECHO_TRAFFIC = {
    "why": "the 3-D contrast set, then the settings read back",
    "steps": {"set": {"class": "set", "commands": [{"call": "set_3d_contrast", "args": ["$x"]}],
                      "state": {"echo": {"contrast": "$x"}}},
              "get": {"class": "echo", "call": "collect_settings", "via": "worker",
                      "output": "settings_echo"}},
    "cycle": ["set", "get"], "sweep": [1.5, 2.0, 2.5], "warmup_cycles": 1,
    "sample": {"echo": 3}}
ECHO_OUTPUT = '''
NUMBERS = ("echo_gap",)


def capture(result):
    return float(result.contrast_3d)


def reference(ref, state):
    return float(state["echo"]["contrast"])


def compare(got, want):
    return {"echo_gap": abs(got - want)}


def control(ctl, state, precision="tf32"):
    return None
'''


def _run(root, workload, traced=False, seconds=1.5):
    return cellmod.run_cell(Spec(root), workload, SEED, seconds, traced, "cpu",
                            time.perf_counter())


def _add_echo_cell(root):
    """The new output's module, traffic mix, limits and entries: new files
    and new entries only."""
    home = root / "portbench"
    (home / "outputs" / "settings_echo.py").write_text(ECHO_OUTPUT)
    (home / "traffic" / "echo.json").write_text(json.dumps(ECHO_TRAFFIC))
    (home / "limits" / "scan200.echo.json").write_text(json.dumps({"echo_gap": 1e-6}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "scan200.echo", "config": "scan-200x200x1024",
                               "traffic": "echo", "chips": 1, "why": "an output by files"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_output_added_by_files_alone_is_read_and_limited(tiny_root, monkeypatch):
    _add_echo_cell(tiny_root)
    result = _run(tiny_root, "scan200.echo")
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert result["checks"] == {"echo_gap": {"value": 0.0, "limit": 1e-6}}
    from thz_image_explorer_tpu_torch.pipeline.explorer import Explorer

    inner = Explorer.collect_settings

    def off(self):
        s = inner(self)
        s.contrast_3d += 0.1
        return s

    monkeypatch.setattr(Explorer, "collect_settings", off)
    result = _run(tiny_root, "scan200.echo")
    assert result["correct"] is False
    assert result["checks"]["echo_gap"]["value"] == pytest.approx(0.1)


def test_a_number_read_without_a_limit_is_a_fault_of_the_files(tiny_root):
    _add_echo_cell(tiny_root)
    (tiny_root / "portbench" / "limits" / "scan200.echo.json").write_text("{}")
    with pytest.raises(KeyError, match="echo_gap"):
        _run(tiny_root, "scan200.echo")


# ------------------------------------------------------------- the view
def _view_traffic(max_points, threshold, contrasts):
    view = {"contrast": "$x", "sigma": 3.0, "radius": 9, "threshold": threshold,
            "max_points": max_points}
    return {"why": "the 3-D view", "steps": {"view": {
        "class": "view3d", "call": "voxels", "via": "webapp", "kwargs": view,
        "output": "view3d", "state": {"view3d": view}}},
        "cycle": ["view"], "sweep": contrasts, "warmup_cycles": 1, "sample": {"view3d": 2}}


#: (max_points, opacity threshold, contrasts): the page's 120 000 over every
#: voxel the tiny cube draws; fewer points than kept traces, so the view is
#: all ties at 1; a threshold that drops most traces at the higher contrast
VIEWS = [(120_000, 0.01, [1.5, 3.0]), (600, 0.01, [1.5]), (20_000, 0.02, [1.5, 3.0])]


def _views(traffic, n_steps, monkeypatch=None, unpacked=False):
    """The program's page answers and the reference's views of ``n_steps``
    steps of ``traffic`` on the tiny 200² configuration."""
    out = Spec(REPO).output("view3d")
    if unpacked:
        from thz_image_explorer_tpu_torch.ops import voxel

        monkeypatch.setattr(voxel, "_PACK_IDX_LIMIT", 1000)
        monkeypatch.setattr(out, "PACKED_BELOW", 1000)
    cfg = tiny_config("scan-200x200x1024")
    s = Session(cfg, traffic, SEED, "cpu")
    s.open()
    steps = [s.next_step() for _ in range(n_steps)]
    s.close()
    assert all(st.ok for st in steps)
    ref = Reference(cfg, SEED, "cpu")
    return out, [(st.result, out.reference(ref, st.state)) for st in steps]


@pytest.mark.parametrize("unpacked", [False, True], ids=["packed", "float16"])
@pytest.mark.parametrize("max_points,threshold,contrasts", VIEWS,
                         ids=["all", "ties", "threshold"])
def test_view_matches_reference(monkeypatch, max_points, threshold, contrasts, unpacked):
    out, views = _views(_view_traffic(max_points, threshold, contrasts), len(contrasts),
                        monkeypatch, unpacked)
    for got, want in views:
        assert got["n"] > 0
        numbers = out.compare(got, want)
        assert numbers["view_count_gap"] == 0.0, numbers
        assert numbers["view_set_gap"] == 0.0, numbers
        assert numbers["view_alpha_gap"] <= 0.01, numbers
    wants = [w for _, w in views]
    ones = [int((w["a_hi"] == 1.0).sum()) for w in wants]
    if max_points == 600:
        assert min(ones) > 600  # the view is a choice among ties
    if threshold == 0.02:
        kept = [float((w["a_hi"].reshape(-1, w["shape"][2]).amax(-1) > 0).double().mean())
                for w in wants]
        assert min(kept) < 0.5 < max(kept)  # traces under the threshold are dropped


def _shifted(got: dict, axis: int) -> dict:
    """``got`` with every voxel moved off the voxel grid along ``axis``."""
    pos = np.frombuffer(base64.b64decode(got["positions"]), np.float32).reshape(-1, 3).copy()
    pos[:, axis] += np.float32(np.ptp(pos[:, axis]) / 100.0 + 1e-3)
    return dict(got, positions=base64.b64encode(pos.tobytes()).decode())


def test_view_compare_catches_wrong_answers():
    out, views = _views(_view_traffic(20_000, 0.02, [1.5]), 1)
    got, want = views[0]
    assert out.compare(dict(got, n=0, positions=None), want)["view_count_gap"] == 1.0
    assert out.compare(_shifted(got, 2), want)["view_set_gap"] > 0.5
    assert out.compare(dict(got, extent=[1.0, 1.0, 1.0]), want)["view_set_gap"] == 1.0
    rgba = np.frombuffer(base64.b64decode(got["rgba"]), np.uint8).reshape(-1, 4).copy()
    rgba[:, 3] = np.maximum(rgba[:, 3].astype(np.int64) - 9, 0).astype(np.uint8)
    assert out.compare(dict(got, rgba=base64.b64encode(rgba.tobytes()).decode()),
                       want)["view_alpha_gap"] > 1.0


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_view_control_fails_the_limits(tiny_root, precision):
    spec = Spec(tiny_root)
    cell = spec.workload("scan200.view3d")
    numbers = control.control_numbers(spec.config(cell["config"]),
                                      spec.traffic(cell["traffic"]), SEED, "cpu", 2, precision,
                                      spec)
    correct, checks = check.verdict(numbers, Spec(REPO).limits("scan200.view3d"))
    assert set(checks) == set(spec.output("view3d").NUMBERS)
    assert not correct, checks


# -------------------------------------------------- the publish unchanged
#: the numbers that the comparison read before steps could return outputs,
#: on six steps of each traffic at the tiny sizes (this machine's CPU)
RECORDED = {
    "scan512.drag": {"series_gap": 7.951830555344282e-07, "phase_gap": 4.180665976605269e-05,
                     "optical_gap": 1.944318818852324e-05, "apply_gap": None},
    "scan200.apply": {"series_gap": 1.4809783100112183e-06, "phase_gap": 1.093828859666246e-05,
                      "optical_gap": 5.759951540014878e-05, "apply_gap": 5.773306879015463e-07},
}


@pytest.mark.parametrize("workload", sorted(RECORDED))
def test_publish_numbers_unchanged(workload):
    spec = Spec(REPO)
    cell = spec.workload(workload)
    cfg = tiny_config(cell["config"])
    s = Session(cfg, spec.traffic(cell["traffic"]), SEED, "cpu")
    s.open()
    samples = []
    for _ in range(6):
        step = s.next_step()
        assert step.ok
        samples.append((step.state, None, check.capture(s.explorer, s.roi_ids)))
    s.close()
    numbers = cellmod.compare_samples(spec, cfg, SEED, "cpu", samples)
    assert list(numbers) == list(check.NUMBERS)
    for name, value in RECORDED[workload].items():
        if value is None:
            assert numbers[name] is None
        else:
            assert numbers[name] == pytest.approx(value, rel=1e-6), name
    correct, checks = check.verdict(numbers, spec.limits(workload))
    assert correct and set(checks) == {k for k, v in RECORDED[workload].items() if v is not None}


def test_reference_slots_are_shared_by_publish_and_view():
    cfg = tiny_config("scan-200x200x1024")
    ref = Reference(cfg, SEED, "cpu")
    state = dict(fft_window_low=1.0, fft_window_high=7.0, tilt=None, deconvolved=False)
    final, _ = ref.final(state)
    assert ref.final(state)[0] is final
    ref.published(state)
    assert ref.slots(state)["final"] is final
    applied, _ = ref.final(dict(state, deconvolved=True))
    assert applied.shape == final.shape and not torch.equal(applied, final)


def test_window_keeps_returned_outputs_only_in_the_sample():
    """A window of ``call`` steps holds what a call returned only in the
    seeded sample: no earlier view's answer stays in the step list."""
    cfg = tiny_config("scan-200x200x1024")
    s = Session(cfg, _view_traffic(600, 0.01, [1.5, 2.0, 2.5]), SEED, "cpu")
    s.open()
    try:
        _, steps, _ = s.window(1.0, sample={"view3d": 2})
    finally:
        s.close()
    assert len(steps) > 2 and all(st.ok for st in steps)
    assert all(st.result is None for st in steps)
    assert len(s.samples) == 2
    assert all(out == "view3d" and got["n"] > 0 and got["positions"]
               for _, out, got in s.samples)
