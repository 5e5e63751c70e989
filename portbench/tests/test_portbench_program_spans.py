"""The per-layer metrics read from the program's spans, on the CPU at tiny
sizes: each reads a value in its own traced cell and agrees with the
benchmark's own readings it is a part of; each reads nothing from a program
without spans; and a program span and the device trace share one clock."""

from __future__ import annotations

import json
import sys
import time

import pytest
import torch
from conftest import SEED

from portbench import cell as cellmod
from portbench import program_spans
from portbench.devtrace import Tracer

SPANS_MODULE = "thz_image_explorer_tpu_torch.utils.spans"
CELLS = ["scan200.apply", "scan512.apply", "scan512.drag"]


def _new_metrics(root, workload):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    metrics = root / "portbench" / "metrics"
    return {m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", [])
            and "program_spans" in (metrics / f"{m['name']}.py").read_text()}


def _traced(root, workload):
    spec = program_spans.Capture(root)
    result = cellmod.run_cell(spec, workload, SEED, 1.5, True, "cpu", time.perf_counter())
    return result, spec.record


@pytest.mark.parametrize("workload", CELLS)
def test_each_span_metric_reads_a_value_in_its_cell(tiny_root, workload):
    want = _new_metrics(tiny_root, workload)
    assert len(want) == {"scan200.apply": 4, "scan512.apply": 6, "scan512.drag": 5}[workload]
    result, run = _traced(tiny_root, workload)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert want <= set(got), want - set(got)
    assert all(got[k] >= 0 for k in want)
    # the parts lie inside the wholes the benchmark already reads
    cls = "slider" if workload == "scan512.drag" else "apply"
    tag = {"scan512.drag": "drag", "scan200.apply": "apply200", "scan512.apply": "apply512"}
    tag = tag[workload]
    assert got[f"publish_host_ms.{tag}"] + got[f"publish_copy_ms.{tag}"] <= \
        got[f"publish_ms.{tag}"]
    if workload == "scan512.apply":
        phases = sum(got[f"deconv_{p}_ms.apply512"] for p in ("spectra", "energy", "rl",
                                                                 "bandsum"))
        assert phases <= got["deconv_stage_ms.apply512"]
    if workload == "scan512.drag":
        step_ms = [s.ms for s in run.traced_steps(cls)]
        assert got["chain_enqueue_ms.drag"] <= max(step_ms)
    report = program_spans.gap_report(run)
    assert set(report) == {"gaps", "idle_ms_per_step", "device_ms_per_step", "traced_steps"}
    assert 0 < len(report["gaps"]) <= 10
    for prog, bench, ms in report["gaps"]:
        assert bench in {"command", "publish", "client"} and ms >= 0
        assert prog == program_spans.NO_SPAN or prog in report["idle_ms_per_step"]


def test_a_program_without_spans_reads_nothing(tiny_root, monkeypatch):
    """As on a checkout before the span module: the new metrics are left
    out of the result line, and nothing raises. The program's modules are
    imported first: run alone, the test would otherwise find them importing
    the span module it hides."""
    import thz_image_explorer_tpu_torch.ops.deconvolution  # noqa: F401
    import thz_image_explorer_tpu_torch.pipeline.worker  # noqa: F401

    monkeypatch.setitem(sys.modules, SPANS_MODULE, None)
    assert program_spans._module() is None
    result, run = _traced(tiny_root, "scan512.drag")
    assert result["correct"], result["checks"]
    assert not _new_metrics(tiny_root, "scan512.drag") & set(result["metrics"])
    assert "chain_ms.drag" in result["metrics"]
    assert program_spans.name_gaps(run) is None and program_spans.gap_report(run) == {}


def test_innermost_names_the_shortest_holding_interval():
    intervals = [("outer", 0.0, 10.0), ("inner", 2.0, 4.0), ("late", 6.0, 7.0)]
    assert program_spans.innermost(intervals, [1.0, 3.0, 5.0, 6.5, 11.0]) == \
        ["outer", "inner", "outer", "late", program_spans.NO_SPAN]


def test_a_span_and_the_trace_share_one_clock():
    """An aten operation run inside a program span on the tracing thread
    lands inside the span after devtrace's alignment. The first
    ``record_function`` of a process spends about 1 ms after its timestamp
    on this CPU build, which shifts that process's first trace by as much
    (PERF.md): a first tracer takes that cost here, so that the
    second checks the clock."""
    spans = program_spans._module()
    first = Tracer("cpu")
    first.start()
    first.stop()
    spans.clear()
    tracer = Tracer("cpu")
    tracer.start()
    x = torch.arange(4096, dtype=torch.float32)
    with spans.span("probe"):
        y = torch.cumsum(x, 0)
        z = y * 2.0  # more work after the probe inside the span
    trace = tracer.stop()
    del z
    probe = [s for s in spans.spans() if s.name == "probe"]
    spans.clear()
    assert len(probe) == 1
    ops = trace.kernels(r"^aten::cumsum$")
    assert ops
    for _name, start, dur in ops:
        assert probe[0].t0 <= start and start + dur <= probe[0].t1
