"""One run of one cell: set-up, the measured window, the readings, the check.

:func:`run_cell` returns the result line's object; ``portbench/run.py`` is
the command that calls it on the card.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import torch

from portbench import check
from portbench.reference import Reference
from portbench.session import RunRecord, Session
from portbench.devtrace import Tracer, breakdown

#: top-level module names that must not be loaded in the process that
#: prints the result: JAX and the JAX package (the port's own name begins
#: with the latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "thz_image_explorer_tpu")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def run_cell(spec, workload: str, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """Set up the cell's session, measure ``seconds`` of its traffic, read
    its metrics, free the program, and compare the sampled publishes and
    outputs with the plain reference. ``t_start``: the process's start on the
    perf_counter clock (set-up runs from there to the window)."""
    device = torch.device(device)
    cell = spec.workload(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    session = Session(cfg, traffic, seed, device, traced=traced)
    session.open()
    tracer = Tracer(device) if traced else None
    setup_s = time.perf_counter() - t_start
    t0, steps, trace = session.window(seconds, tracer, sample=traffic["sample"])
    info = _device_info(device, cell["chips"])
    record = RunRecord(workload=workload, cfg=cfg, traffic=traffic, seconds=seconds,
                       setup_s=setup_s, window_t0=t0, steps=steps, trace=trace,
                       device_name=info["kind"])
    metrics = {}
    for m in spec.metrics(workload, traced):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": False, "attempted": len(steps),
              "failed": sum(1 for s in steps if not s.ok), "metrics": metrics, "device": info}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
        spans = [("command", s.t_send, s.t_done) for s in steps if s.ok]
        spans += [("publish", a, b) for s in steps for a, b in s.publishes]
        result["breakdown"] = breakdown(trace, spans)
    samples, split = session.samples, session.setup_split
    split["before_open_s"] = setup_s - sum(split.values())
    session.close()
    del session, record, steps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare_samples(spec, cfg, seed, device, samples, spec.numbers(traffic))
    split["reference_s"] = time.perf_counter() - t_ref
    print(json.dumps({"setup_split": split, "samples": len(samples)}), file=sys.stderr)
    correct, checks = check.verdict(numbers, limits)
    result["correct"] = correct and result["failed"] == 0
    result["checks"] = checks
    return result


def compare_samples(spec, cfg: dict, seed: int, device, samples: list,
                    names=check.NUMBERS) -> dict:
    """The comparison numbers ``names`` of the samples ``(state, output,
    what the step left)`` against the plain reference: a publish (output
    None) by ``check.compare``, a step's returned output by its module's
    ``compare``; each number the widest over the samples."""
    ref = Reference(cfg, seed, device)
    readings = []
    # one chain per state: visit the samples grouped by state
    for state, output, got in sorted(samples, key=lambda it: repr(sorted(it[0].items()))):
        if output is None:
            readings.append(check.compare(got, ref.published(state),
                                          bool(state.get("deconvolved")), cfg["reference_roi"]))
        else:
            mod = spec.output(output)
            readings.append(mod.compare(mod.capture(got), mod.reference(ref, state)))
    ref.close()
    return check.worst(readings, names)
