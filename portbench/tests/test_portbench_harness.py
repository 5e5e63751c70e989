"""The harness on the CPU, at tiny sizes: found by name, the result line, no
JAX, and ``correct`` false when the timed path is broken underneath."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time

import pytest
import torch
from conftest import HOME, REPO, SEED

from portbench import cell as cellmod
from portbench.spec import Spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
#: per-layer metrics read from a card's device trace alone: a CPU run's
#: trace holds no such kernel
CARD_ONLY = {"specred_roofline.drag", "polar_roofline.slider", "envelope_roofline.view3d",
             "topk_ms.view3d"}


def _run(root, workload, traced=False, seconds=1.5, device="cpu"):
    return cellmod.run_cell(Spec(root), workload, SEED, seconds, traced, device,
                            time.perf_counter())


def test_cell_traffic_and_metric_found_by_name_from_new_files(tiny_root):
    """A new cell with its own configuration, traffic mix, limits and
    per-layer metric needs new files and new entries only."""
    home = tiny_root / "portbench"
    cfg = json.loads((home / "configs" / "scan-200x200x1024.json").read_text())
    cfg["scan"]["dx_mm"] = cfg["scan"]["dy_mm"] = 0.4
    (home / "configs" / "scan-pitch04.json").write_text(json.dumps(cfg))
    (home / "traffic" / "high_edge.json").write_text(json.dumps({
        "why": "the FFT window's high edge dragged",
        "steps": {"edge": {"class": "slider", "reruns_from": "fft",
                           "commands": [{"call": "set_fft_window_high", "args": ["$x"]}],
                           "state": {"fft_window_high": "$x"}}},
        "cycle": ["edge"], "sweep": [6.0, 6.5, 7.0], "warmup_cycles": 2,
        "sample": {"slider": 3}}))
    (home / "limits" / "pitch04.edge.json").write_text(json.dumps(
        {"series_gap": 1e-4, "phase_gap": 0.05, "optical_gap": 1e-2}))
    (home / "metrics" / "steps_done.edge.py").write_text(
        "def read(run):\n    return float(len(run.window_steps()))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "scan-pitch04", "source": "https://example.org",
                             "file": "portbench/configs/scan-pitch04.json", "reduced": [],
                             "why": "another pitch"})
    bench["workloads"].append({"name": "pitch04.edge", "config": "scan-pitch04",
                               "traffic": "high_edge", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "steps_done.edge", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "client", "moves": "slider_ms",
                               "workloads": ["pitch04.edge"]})
    bench["end_to_end"][0]["workloads"].append("pitch04.edge")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = _run(tiny_root, "pitch04.edge")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"slider_ms", "setup_s"}
    traced = _run(tiny_root, "pitch04.edge", traced=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["steps_done.edge"]["value"] > 0


def _check_result_line(tiny_root, workload, traced):
    result = _run(tiny_root, workload, traced=traced)
    keys = list(result)
    assert keys[:5] == KEYS
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == traced
    assert set(keys) == set(KEYS) | {"checks"} | ({"breakdown"} if traced else set())
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer" if traced else "end_to_end"]
            if workload in m.get("workloads", [workload])}
    if traced:  # the trace-read metrics need a card's trace
        want -= CARD_ONLY
    assert set(result["metrics"]) == want
    for name, check in result["checks"].items():
        assert set(check) == {"value", "limit"}, name
    json.dumps(result)
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    return result


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tiny_root, traced):
    _check_result_line(tiny_root, "scan512.drag", traced)


@pytest.mark.parametrize("traced", [False, True])
def test_view_result_line_keys(tiny_root, traced):
    result = _check_result_line(tiny_root, "scan200.view3d", traced)
    assert set(result["checks"]) == {"view_count_gap", "view_set_gap", "view_alpha_gap"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    forbidden = set(cellmod.FORBIDDEN)
    for path in HOME.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in forbidden, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (HOME / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "thz_image_explorer_tpu_torch", (path, name)


def test_benchmark_process_loads_no_jax(tiny_root):
    """The names are compared whole: the port's own name begins with the
    JAX package's."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from portbench.cell import run_cell, forbidden_modules\n"
        "from portbench.spec import Spec\n"
        f"r = run_cell(Spec({str(tiny_root)!r}), 'scan200.apply', 5, 1.0, False, 'cpu',"
        " time.perf_counter())\n"
        "assert 'thz_image_explorer_tpu_torch' in sys.modules\n"
        "print(r['correct'], forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def _stale_step(monkeypatch):
    """A step that returns its state unchanged: the slider moves, nothing
    is re-run, the old series are published again."""
    from thz_image_explorer_tpu_torch.pipeline.explorer import Explorer

    def stale(self, low):
        self.pipeline.config.fft_window[0] = low
        self.publish()

    monkeypatch.setattr(Explorer, "set_fft_window_low", stale)


def _half_batch(monkeypatch):
    """Half of the pixels left out of the means, the mean taken over the rest."""
    from thz_image_explorer_tpu_torch.pipeline import publish

    inner = publish.reduce_slots

    def half(pipeline, masks, extra=()):
        masks = masks.clone()
        masks[:, masks.shape[1] // 2:] = 0
        return inner(pipeline, masks, extra)

    monkeypatch.setattr(publish, "reduce_slots", half)


def _altered_answer(monkeypatch):
    """One published value altered where it is produced."""
    from thz_image_explorer_tpu_torch.pipeline.publish import Publisher

    inner = Publisher.publish

    def altered(self, *a, **k):
        out = dict(inner(self, *a, **k))
        out["avg_signal"] = out["avg_signal"] * 1.01
        return out

    monkeypatch.setattr(Publisher, "publish", altered)


def _apply_unchanged(monkeypatch):
    """An Apply that returns its input: the deconvolution's state unchanged."""
    from thz_image_explorer_tpu_torch.ops import deconvolution

    monkeypatch.setattr(deconvolution, "deconvolve_cube", lambda data, *a, **k: data.clone())


def _stale_view(monkeypatch):
    """A 3-D view update that returns the view it returned first."""
    from thz_image_explorer_tpu_torch.web import WebApp

    inner, first = WebApp.voxels, []

    def stale(self, *a, **k):
        if not first:
            first.append(inner(self, *a, **k))
        return first[0]

    monkeypatch.setattr(WebApp, "voxels", stale)


def _half_view(monkeypatch):
    """Half of the traces left out of the view's opacities."""
    from thz_image_explorer_tpu_torch.ops import voxel

    inner = voxel._normalized_opacities

    def half(data, *a, **k):
        out = inner(data, *a, **k).clone()
        out[out.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(voxel, "_normalized_opacities", half)


def _altered_view(monkeypatch):
    """Each voxel's opacity one step higher where the fetch packs it."""
    from thz_image_explorer_tpu_torch.ops import voxel

    inner = voxel._pack

    def altered(vals, idx):
        return inner(torch.clamp(vals + 1.0 / 63, max=1.0), idx)

    monkeypatch.setattr(voxel, "_pack", altered)


FAULTS = [("scan512.drag", _stale_step), ("scan512.drag", _half_batch),
          ("scan512.drag", _altered_answer), ("scan200.apply", _altered_answer),
          ("scan200.apply", _apply_unchanged), ("scan200.drag", _stale_step),
          ("scan200.drag", _half_batch), ("scan200.drag", _altered_answer),
          ("scan200.view3d", _stale_view), ("scan200.view3d", _half_view),
          ("scan200.view3d", _altered_view)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = _run(tiny_root, workload)
    print(workload, fault.__name__, result["checks"])
    assert result["correct"] is False, result["checks"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(HOME / "run.py"), "--workload", "scan200.apply",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for workload in ("scan200.apply", "scan512.drag", "scan512.apply", "scan200.drag",
                     "scan200.view3d"):
        result = _run(tiny_root, workload, traced=True, device="cuda")
        assert result["correct"], (workload, result["checks"])
        assert result["device"]["busy_s"] > 0
