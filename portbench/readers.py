"""Readings that several metrics take, each from a ``session.RunRecord``.

A metric's file (``metrics/<name>.py``) says which steps it reads; where two
cells report the same quantity under metrics of their own (so that each
metric's bound fits its one cell's spread), both files call the same reading
here. Each returns None where the run holds nothing to read.
"""

from __future__ import annotations

import numpy as np

from portbench import peaks, scan
from portbench.reference import deconv


def mean_step_ms(run, cls: str):
    """The summed time of every step of class ``cls`` completed in the
    window over their number."""
    ms = [s.ms for s in run.window_steps(cls)]
    return sum(ms) / len(ms) if ms else None


def p95_step_ms(run, cls: str):
    """The 95th percentile of every step of class ``cls`` completed in the
    window, from its first send to the worker's report."""
    ms = [s.ms for s in run.window_steps(cls)]
    return float(np.percentile(ms, 95)) if ms else None


def stage_ms(run, cls: str, stage: str):
    """A chain stage's device ms (``Pipeline.timings_ms``, CUDA events) per
    step of class ``cls`` that ran it."""
    per = [s.timings[stage] for s in run.window_steps(cls)
           if s.timings is not None and stage in s.timings]
    return sum(per) / len(per) if per else None


def publish_ms(run, cls: str):
    """Host ms of ``Explorer.publish`` (a span around the call, which ends in
    its device-to-host copies: two after a chain run, one after a click) per
    step of class ``cls``."""
    per = [sum(b - a for a, b in s.publishes) * 1e3
           for s in run.window_steps(cls) if s.publishes]
    return sum(per) / len(per) if per else None


def device_idle(run):
    """The share of the traced window in which no operation ran on the
    card, in %."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


#: the device operations of the Apply's Richardson-Lucy kernels
RL_KERNELS = r"rl_cluster|rl_half"


def rl_roofline(run):
    """The Apply's Richardson-Lucy bound (its operations from the plan's band
    geometry over the f32 peak) over the device time of the RL kernels in
    each traced Apply, in % of the card's roofline."""
    if run.trace is None or run.device_name == "cpu":
        return None
    s_cfg = run.cfg["scan"]
    shape = (s_cfg["width"], s_cfg["height"])
    plan = deconv.plan(run.cfg, scan.time_axis(run.cfg).numpy(), shape)
    if plan is None:
        return None
    bound_one = peaks.rl_bound_s(plan, shape, run.device_name)
    bound = spent = 0.0
    for step in run.traced_steps("apply"):
        ops = run.ops_in(step, RL_KERNELS)
        if ops:
            bound += bound_one
            spent += sum(o[2] for o in ops)
    return 100.0 * bound / spent if spent > 0 else None
