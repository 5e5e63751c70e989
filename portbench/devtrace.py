"""The device trace of a ``--trace 1`` run.

``torch.profiler`` (CUPTI) records the first seconds of the window. From its
events this module keeps what the per-layer readers and the result line need:
each device operation (kernel, copy, set) with its start and length on the
host's clock (``time.perf_counter`` seconds, aligned through an annotation
entered at a known instant), the busy time (the union of the operations),
and the longest idle gaps, each named after the host span that was open at
its middle (``portbench.session`` records the spans).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

#: the annotation that marks the traced window (and aligns the clocks)
_MARK = "pb.window"


@dataclass
class Trace:
    """Device operations ``(name, start_s, dur_s)`` on the perf_counter
    clock, within ``[t0, t1]``."""

    t0: float
    t1: float
    ops: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _name, s, d in sorted(self.ops, key=lambda o: o[1]):
            e = s + d
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(max(s, self.t0), min(e, self.t1)) for s, e in merged
                if e > self.t0 and s < self.t1]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernels(self, pattern: str) -> list:
        """The operations whose name matches ``pattern`` (a regex)."""
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o[0])]

    def gaps(self) -> list[tuple[float, float]]:
        """Idle intervals of the device inside the window."""
        out, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                out.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            out.append((prev, self.t1))
        return out


class Tracer:
    """Start and stop the profiler around a stretch of the window."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self._mark = None
        self._pc0 = self._pc1 = 0.0

    def start(self):
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(_MARK)
        self._mark.__enter__()
        self._pc0 = time.perf_counter()

    def stop(self) -> Trace:
        self._pc1 = time.perf_counter()
        self._mark.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        mark = next(e for e in events if e.name() == _MARK and e.device_type() == DeviceType.CPU)
        offset_s = mark.start_ns() * 1e-9 - self._pc0
        trace = Trace(self._pc0, self._pc1)
        # on a CPU run (the tests) the host's aten operations stand in
        on_cpu = self.device.type == "cpu"
        for e in events:
            if e.is_user_annotation():
                continue
            name = e.name()
            if on_cpu:
                if e.device_type() != DeviceType.CPU or not name.startswith("aten::"):
                    continue
            elif e.device_type() != DeviceType.CUDA or name.startswith("pb."):
                continue
            trace.ops.append((name, e.start_ns() * 1e-9 - offset_s, e.duration_ns() * 1e-9))
        return trace


def clean_name(name: str) -> str:
    """A device operation's name as the breakdown gives it."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name)[:64]


def breakdown(trace: Trace, spans: list[tuple[str, float, float]]) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named after the innermost host span open at its middle
    (``client`` where none was)."""
    by_name: dict[str, float] = {}
    for name, s, d in trace.ops:
        lo, hi = max(s, trace.t0), min(s + d, trace.t1)
        if hi > lo:
            key = clean_name(name)
            by_name[key] = by_name.get(key, 0.0) + (hi - lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        open_spans = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        label = min(open_spans, key=lambda sp: sp[2] - sp[1])[0] if open_spans else "client"
        named.append([label, e - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
