"""Readings of the program's own spans (``thz_image_explorer_tpu_torch.utils.
spans``), for the per-layer metrics of a ``--trace 1`` run.

The program records its spans while the run's profiler records, on
``time.perf_counter``: the clock of the steps (``session.Step``) and of the
device trace (``devtrace.Trace``, aligned through its ``pb.window`` mark).
A reading keeps the spans that started inside the traced stretch, gives
each to the step during which it started (from its send to the worker's
report), and sets them against the trace's idle gaps. Where the program
records no spans (a program without that module), every reading returns
None.

    python3 -m portbench.program_spans --workload scan512.drag --seed 7 --seconds 10

runs one traced cell on the card and prints one JSON line: its per-layer
metrics, its end-to-end metrics over the traced steps alone (the window
while the profiler and the program's spans record), the ten longest idle
gaps each named after the innermost program span open at its middle beside
the benchmark's own name for it (``devtrace.breakdown``'s ``command``,
``publish`` or ``client``), the idle ms per traced step under each
innermost span name, and the device ms of the operations started under
each.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import sys
import time

from portbench.devtrace import clean_name
from portbench.spec import Spec

#: the name of a gap that no program span holds
NO_SPAN = "none"


def _module():
    """The program's span module, or None where the program has none."""
    try:
        return importlib.import_module("thz_image_explorer_tpu_torch.utils.spans")
    except ImportError:
        return None


def traced_spans(run):
    """The program's spans that started inside the traced stretch, by
    start; None without a trace or without spans."""
    mod = _module()
    if mod is None or run.trace is None:
        return None
    t = run.trace
    got = sorted((s for s in mod.spans() if t.t0 <= s.t0 <= t.t1), key=lambda s: s.t0)
    return got or None


def step_spans(run, cls: str) -> list:
    """``[(step, spans)]`` for the traced steps of class ``cls``: the spans
    that started between the step's send and its report."""
    got = traced_spans(run)
    if got is None:
        return []
    starts = [s.t0 for s in got]
    return [(step, got[bisect.bisect_left(starts, step.t_send):
                       bisect.bisect_right(starts, step.t_done)])
            for step in run.traced_steps(cls)]


def _per_step(run, cls: str, value):
    """The mean over the traced steps of class ``cls`` of ``value(spans)``,
    leaving out the steps where it is None."""
    vals = [v for _step, sp in step_spans(run, cls) if (v := value(sp)) is not None]
    return sum(vals) / len(vals) if vals else None


def _named(sp, name: str) -> list:
    return [s for s in sp if s.name == name]


def _summed(name: str, of):
    """``spans -> sum of of(span)`` over the spans ``name`` (None where
    none is, or none gives a value)."""
    def value(sp):
        vals = [v for s in _named(sp, name) if (v := of(s)) is not None]
        return sum(vals) if vals else None

    return value


def host_ms(run, cls: str, name: str):
    """Host ms of the spans ``name`` per step of class ``cls`` that has one."""
    return _per_step(run, cls, _summed(name, lambda s: (s.t1 - s.t0) * 1e3))


def device_ms(run, cls: str, name: str):
    """Device ms (``Span.device_ms``: CUDA events, host time on the CPU) of
    the spans ``name`` per step of class ``cls`` that has one."""
    return _per_step(run, cls, _summed(name, lambda s: s.device_ms))


def _idle_s(gaps: list, starts: list, t0: float, t1: float) -> float:
    """Seconds of the sorted idle ``gaps`` (``starts``: their starts) that
    lie in ``[t0, t1]``."""
    i = max(bisect.bisect_right(starts, t0) - 1, 0)
    total = 0.0
    while i < len(gaps) and gaps[i][0] < t1:
        total += max(0.0, min(gaps[i][1], t1) - max(gaps[i][0], t0))
        i += 1
    return total


def idle_ms(run, cls: str, name: str):
    """Device-idle ms inside the spans ``name`` per step of class ``cls``
    that has one."""
    if run.trace is None:
        return None
    gaps = run.trace.gaps()
    starts = [g[0] for g in gaps]
    return _per_step(run, cls, _summed(name, lambda s: _idle_s(gaps, starts, s.t0, s.t1) * 1e3))


def wait_us(run, cls: str):
    """The mean ``worker.wait`` (a command's put to its take) of the
    commands of the traced steps of class ``cls``, in µs."""
    waits = [s.t1 - s.t0 for _step, sp in step_spans(run, cls) for s in _named(sp, "worker.wait")]
    return sum(waits) / len(waits) * 1e6 if waits else None


def publish_host_ms(run, cls: str):
    """Host ms of ``publish`` spans outside their ``publish.to_host``
    children per step of class ``cls``."""
    def value(sp):
        pubs = _named(sp, "publish")
        if not pubs:
            return None
        ids = {p.id for p in pubs}
        copies = sum(s.t1 - s.t0 for s in _named(sp, "publish.to_host") if s.parent in ids)
        return (sum(p.t1 - p.t0 for p in pubs) - copies) * 1e3

    return _per_step(run, cls, value)


def innermost(intervals: list, points: list) -> list:
    """For each of the increasing ``points``, the name of the shortest of
    ``intervals`` (``(name, t0, t1)``, by ``t0``) that holds it, or
    :data:`NO_SPAN`."""
    out, active, i = [], [], 0
    for p in points:
        while i < len(intervals) and intervals[i][1] <= p:
            active.append(intervals[i])
            i += 1
        active = [iv for iv in active if iv[2] >= p]
        out.append(min(active, key=lambda iv: iv[2] - iv[1])[0] if active else NO_SPAN)
    return out


def name_gaps(run):
    """Every idle gap of the traced stretch as ``(start, seconds, name)``,
    named after the innermost program span open at its middle; None
    without a trace or spans."""
    got = traced_spans(run)
    if got is None:
        return None
    gaps = run.trace.gaps()
    names = innermost([(s.name, s.t0, s.t1) for s in got], [0.5 * (a + b) for a, b in gaps])
    return [(a, b - a, n) for (a, b), n in zip(gaps, names)]


def gap_report(run) -> dict:
    """The ten longest idle gaps, each as ``[program name, benchmark name,
    ms]``; the idle ms per traced step under each program name; and the
    device ms per traced step of the operations that started under each
    (all, and the four busiest by name)."""
    named = name_gaps(run)
    if named is None:
        return {}
    # the benchmark's own spans, as portbench/cell.py gives them to the breakdown
    bench = sorted([("command", s.t_send, s.t_done) for s in run.steps if s.ok]
                   + [("publish", a, b) for s in run.steps for a, b in s.publishes],
                   key=lambda iv: iv[1])
    longest = sorted(named, key=lambda g: -g[1])[:10]
    by_start = sorted(longest)
    labels = dict(zip(by_start, innermost(bench, [a + 0.5 * d for a, d, _n in by_start])))
    per_name: dict = {}
    for _a, d, n in named:
        per_name[n] = per_name.get(n, 0.0) + d
    n_steps = max(len(run.traced_steps()), 1)
    # each device operation under the innermost span open at its start
    ops = sorted(run.trace.ops, key=lambda o: o[1])
    spans = [(s.name, s.t0, s.t1) for s in traced_spans(run)]
    by_span: dict = {}
    for (op, _s, d), n in zip(ops, innermost(spans, [o[1] for o in ops])):
        key = clean_name(op)
        by_span.setdefault(n, {})[key] = by_span.get(n, {}).get(key, 0.0) + d
    return {
        "gaps": [[n, labels[(a, d, n)].replace(NO_SPAN, "client"), d * 1e3]
                 for a, d, n in longest],
        "idle_ms_per_step": {n: v * 1e3 / n_steps
                             for n, v in sorted(per_name.items(), key=lambda kv: -kv[1])},
        "device_ms_per_step": {
            n: {"all": sum(v.values()) * 1e3 / n_steps,
                **{k: t * 1e3 / n_steps for k, t in sorted(v.items(), key=lambda kv: -kv[1])[:4]}}
            for n, v in sorted(by_span.items(), key=lambda kv: -sum(kv[1].values()))},
        "traced_steps": len(run.traced_steps()),
    }


class Capture(Spec):
    """The benchmark, keeping the run record its readers are given."""

    record = None

    def reader(self, name):
        fn = super().reader(name)

        def read(run):
            self.record = run
            return fn(run)

        return read


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One traced cell's idle gaps by program span.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    from portbench import run as runmod

    runmod._caches()
    import torch

    from portbench.cell import run_cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = Capture(runmod.ROOT)
    result = run_cell(spec, args.workload, args.seed, args.seconds, True, "cuda", t_start)
    run = spec.record
    # the cell's step times while the profiler (and the program's spans) recorded
    traced = type(run)(**{**vars(run), "steps": run.traced_steps(),
                          "seconds": run.trace.window_s})
    out = {"workload": args.workload, "seed": args.seed, "correct": result["correct"],
           "device": result["device"]["kind"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "traced_end_to_end": {m["name"]: spec.reader(m["name"])(traced)
                                 for m in spec.metrics(args.workload, False)
                                 if m["name"] != "setup_s"}}
    out.update(gap_report(run))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
