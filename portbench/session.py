"""A user's session driven through the program's command worker.

Every command goes through ``ExplorerWorker`` (``pipeline/worker.py``) to the
``Explorer`` (``pipeline/explorer.py``), as the page and the CLI send them,
without HTTP and without the page's state build. One client, a closed loop:
a step's commands are sent with ``send`` and the next step goes only after
the worker has reported the last of them done (its ``on_update`` callback,
which runs once the command's publish has ended in its device-to-host
copies: two after a chain run, one after a click). A step's time runs from
its first ``send`` to that report.

A step of kind ``call`` instead calls one method and keeps what it returns:
a ``WebApp`` method on this (the client's) thread, as the page's HTTP
handler calls it (``"via": "webapp"``; the session then builds one
``thz_image_explorer_tpu_torch.web.WebApp`` over its worker, without HTTP),
or an ``Explorer`` method on the worker's thread through ``worker.call``
(``"via": "worker"``). Its time runs from the call to its return; the output
it names (``portbench/outputs/<output>.py``) judges what it returned.

The steps, their commands and the state each leaves the session in come from
the traffic file (``portbench/traffic/<name>.json``); the scan, the filters,
the ROIs, the PSF and the deconvolution's parameters from the configuration
file (``portbench/configs/<name>.json``).
"""

from __future__ import annotations

import copy
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from portbench import check, scan

#: seconds a step may take before the run gives up on the worker
STEP_TIMEOUT_S = 300.0
#: how many of the window's first seconds a ``--trace 1`` run traces
TRACE_SECONDS = 5.0


@dataclass
class Step:
    kind: str
    cls: str  # "slider", "apply", ...: which end-to-end metrics count it
    state: dict
    t_send: float
    t_done: Optional[float] = None
    ok: bool = False
    n_time: int = 0
    #: ``--trace 1`` only: the executor's per-stage ms, the stages the step
    #: ran, and its publishes as (start, end) on the perf_counter clock
    timings: Optional[dict] = None
    stages: tuple = ()
    publishes: list = field(default_factory=list)
    #: a ``call`` step's output name and what the call returned
    output: Optional[str] = None
    result: Any = None

    @property
    def ms(self) -> float:
        return (self.t_done - self.t_send) * 1e3


@dataclass
class RunRecord:
    """What a run's readers (``portbench/metrics/<name>.py``) read."""

    workload: str
    cfg: dict
    traffic: dict
    seconds: float
    setup_s: float
    window_t0: float
    steps: list
    trace: object = None  # ``portbench.devtrace.Trace`` of a --trace 1 run
    device_name: str = ""

    def window_steps(self, cls: Optional[str] = None) -> list:
        """The steps completed inside the window (of class ``cls``)."""
        end = self.window_t0 + self.seconds
        return [s for s in self.steps if s.ok and s.t_done <= end
                and (cls is None or s.cls == cls)]

    def traced_steps(self, cls: Optional[str] = None) -> list:
        """The window's steps that lie wholly inside the traced stretch."""
        if self.trace is None:
            return []
        return [s for s in self.window_steps(cls)
                if s.t_send >= self.trace.t0 and s.t_done <= self.trace.t1]

    def ops_in(self, step: Step, pattern: str) -> list:
        """The traced device operations matching ``pattern`` that started
        during ``step``."""
        return [o for o in self.trace.kernels(pattern) if step.t_send <= o[1] <= step.t_done]


def program_psf(cfg: dict):
    """The configuration's PSF as the program's model object: widths
    ``a/f + b`` mm along x and y, constant centres, a spline whose
    correction terms are zero (``chip_smoke.synthetic_psf``'s form)."""
    from thz_image_explorer_tpu_torch.models.psf import PSF, CubicSplineCoeffs, HybridFit

    p = cfg["psf"]
    knots = np.geomspace(*p["knots_thz"])
    zeros = np.zeros_like(knots)

    def const(v):
        c = np.full_like(knots, v)
        return CubicSplineCoeffs(knots, c, c, zeros, zeros, zeros)

    return PSF(wx_fit=HybridFit(*p["wx_a_b"], const(0.0)),
               wy_fit=HybridFit(*p["wy_a_b"], const(0.0)),
               x0_spline=const(p["x0_mm"]), y0_spline=const(p["y0_mm"]))


def _bounce(values: list) -> list:
    """``values`` forth and back: the order a slider is dragged over."""
    return list(values) + list(values[-2:0:-1])


def _fill(obj, x):
    """``obj`` with every ``"$x"`` replaced by ``x``."""
    if obj == "$x":
        return x
    if isinstance(obj, list):
        return [_fill(o, x) for o in obj]
    if isinstance(obj, dict):
        return {k: _fill(v, x) for k, v in obj.items()}
    return obj


def outputs_of(traffic: dict) -> list[str]:
    """The outputs that the traffic's steps name, in order."""
    names = [spec["output"] for spec in traffic["steps"].values() if "output" in spec]
    return list(dict.fromkeys(names))


def _uses_x(obj) -> bool:
    if obj == "$x":
        return True
    if isinstance(obj, list):
        return any(_uses_x(o) for o in obj)
    if isinstance(obj, dict):
        return any(_uses_x(v) for v in obj.values())
    return False


class TrafficPlan:
    """The traffic file's steps in order, with the session state each leaves
    (``fft_window_low``, ``fft_window_high``, ``tilt``, ``deconvolved``):
    what the program is sent and what the reference is asked for. The
    sweep's starting point is drawn from the seed; every seed visits the
    same values."""

    def __init__(self, traffic: dict, seed: int):
        self.traffic = traffic
        self.state = dict(fft_window_low=1.0, fft_window_high=7.0, tilt=None, deconvolved=False)
        sweep = _bounce(traffic["sweep"])
        start = int(np.random.default_rng([int(seed), 2]).integers(len(sweep)))
        self._sweep = sweep[start:] + sweep[:start]
        self._sweep_pos = self._cycle_pos = 0

    def setup_commands(self) -> list:
        """The traffic's set-up commands; the state they leave is taken."""
        out = []
        for entry in self.traffic.get("setup", []):
            out.append((entry["call"], entry.get("args", []), entry.get("kwargs", {})))
            self.state.update(entry.get("state", {}))
        return out

    def next(self):
        """``(kind, step spec, commands, state after it)`` of the next step;
        a ``call`` step's one call is its one command."""
        cycle = self.traffic["cycle"]
        kind = cycle[self._cycle_pos % len(cycle)]
        self._cycle_pos += 1
        spec = self.traffic["steps"][kind]
        x = None
        if _uses_x(spec):
            x = self._sweep[self._sweep_pos % len(self._sweep)]
            self._sweep_pos += 1
        commands = [(c["call"], _fill(c.get("args", []), x), _fill(c.get("kwargs", {}), x))
                    for c in ([spec] if "call" in spec else spec["commands"])]
        self.state.update(_fill(spec.get("state", {}), x))
        return kind, spec, commands, copy.deepcopy(self.state)

    def period(self) -> int:
        """Steps after which the sequence of states repeats."""
        n_cycle = len(self.traffic["cycle"])
        uses = sum(_uses_x(self.traffic["steps"][k]) for k in self.traffic["cycle"])
        return n_cycle * (len(self._sweep) if uses else 1)


class Session:
    """The program, opened on the configuration's scan and set up as the
    traffic's steps need, driven one step at a time."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, traced: bool = False):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.traced = traced
        self.plan = TrafficPlan(traffic, seed)
        self._done = []
        self._done_lock = threading.Lock()
        self.publish_spans: list = []
        self.samples: list = []
        #: seconds of each part of ``open`` (build, scan, open, session, the
        #: page's ``WebApp`` where a step calls it, warm-up)
        self.setup_split: dict = {}
        self.worker = None
        #: the page's ``WebApp`` over the worker, for ``"via": "webapp"`` calls
        self.webapp = None
        #: formatted exceptions of the ``call`` steps that raised
        self.call_failures: list = []
        self.roi_ids = [f"roi-{i}" for i in range(len(cfg["rois"]))]

    # ----------------------------------------------------------- set-up
    def open(self):
        """Build, open, set up and warm up: everything before the window."""
        from thz_image_explorer_tpu_torch import kernels
        from thz_image_explorer_tpu_torch.io.dotthz import DotthzMetadata
        from thz_image_explorer_tpu_torch.pipeline.worker import ExplorerWorker

        mark = time.perf_counter()

        def split(name):
            nonlocal mark
            now = time.perf_counter()
            self.setup_split[name] = now - mark
            mark = now

        if self.device.type == "cuda":
            kernels.build()
            torch.cuda.synchronize()
        split("build_s")
        t, cube = scan.make_scan(self.cfg, self.seed, self.device)
        cube_host = cube.cpu().numpy()
        del cube
        split("scan_s")
        s = self.cfg["scan"]
        md = DotthzMetadata(md={"dx [mm]": str(s["dx_mm"]), "dy [mm]": str(s["dy_mm"])})
        self.worker = ExplorerWorker(device=self.device)
        self.explorer = self.worker.explorer
        self.worker.on_update(self._report)
        if self.traced:
            self._wrap_publish()
        # the open defers its device phase through the queue: one more report
        opened = self._send([("open_arrays", [t.numpy(), cube_host, md], {})], "open", "setup")
        del cube_host
        if self.worker.failures or not opened.t_done:
            raise RuntimeError(f"the scan did not open: {list(self.worker.failures)}")
        split("open_s")
        commands = []
        for uuid, active in self.cfg["filters"].items():
            if active:
                commands.append(("set_filter_active", [uuid, True], {}))
        for i, poly in enumerate(self.cfg["rois"]):
            commands.append(("add_roi", [self.roi_ids[i], f"ROI {i}", poly], {}))
        commands += [("set_reference", [f"ROI {self.cfg['reference_roi']}"], {}),
                     ("set_sample", ["Selected Pixel"], {}),
                     ("set_selected_pixel", list(scan.selected_pixel(self.cfg, self.seed)), {}),
                     ("apply_psf", [program_psf(self.cfg)], {})]
        for key, value in self.cfg["deconvolution"].items():
            commands.append(("set_filter_param", ["deconvolution", key, value], {}))
        commands += self.plan.setup_commands()
        if not self._send(commands, "setup", "setup").ok:
            raise RuntimeError(f"the session's set-up failed: {list(self.worker.failures)}")
        split("session_s")
        if any(spec.get("via") == "webapp" for spec in self.traffic["steps"].values()):
            from thz_image_explorer_tpu_torch.web import WebApp

            # its one state build; its on_update hook does nothing once the
            # open has published
            self.webapp = WebApp(worker=self.worker)
            split("webapp_s")
        for _ in range(int(self.traffic["warmup_cycles"]) * len(self.traffic["cycle"])):
            if not self.next_step().ok:
                raise RuntimeError(f"a warm-up step failed: {list(self.worker.failures)} "
                                   f"{self.call_failures}")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        split("warmup_s")

    def _wrap_publish(self):
        """A span around every ``Explorer.publish`` (the instance's own
        attribute: the Explorer's commands call ``self.publish``); only in a
        ``--trace 1`` run, whose synchronize before it costs the window."""
        inner = self.explorer.publish
        spans = self.publish_spans
        sync = self.device.type == "cuda"

        def publish():
            # the device's queue first, so that the span holds the publish's
            # own work and not the wait for the stages before it
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return inner()
            finally:
                spans.append((t0, time.perf_counter()))

        self.explorer.publish = publish

    def _report(self, _explorer):
        with self._done_lock:
            self._done.append(time.perf_counter())

    # ------------------------------------------------------------ steps
    def _send(self, commands, kind, cls) -> Step:
        with self._done_lock:
            self._done.clear()
        n_spans = len(self.publish_spans)
        step = Step(kind, cls, {}, time.perf_counter())
        for call, args, kwargs in commands:
            self.worker.send(call, *args, **kwargs)
        if not self.worker.join_idle(STEP_TIMEOUT_S):
            raise RuntimeError(f"step {kind!r} did not finish in {STEP_TIMEOUT_S} s")
        with self._done_lock:
            done = list(self._done)
        step.ok = len(done) == len(commands)
        step.t_done = done[-1] if done else time.perf_counter()
        step.publishes = self.publish_spans[n_spans:]
        return step

    def _call(self, spec, command, kind) -> Step:
        """One call, on this thread through the page's ``WebApp`` or on the
        worker's through ``worker.call``; the step keeps what it returned."""
        name, args, kwargs = command
        step = Step(kind, spec["class"], {}, time.perf_counter(), output=spec.get("output"))
        try:
            if spec["via"] == "webapp":
                step.result = getattr(self.webapp, name)(*args, **kwargs)
            else:
                step.result = self.worker.call(lambda ex: getattr(ex, name)(*args, **kwargs),
                                               timeout=STEP_TIMEOUT_S)
            step.ok = True
        except Exception:  # noqa: BLE001 - counted as a failed step, the run goes on
            self.call_failures.append(traceback.format_exc())
        step.t_done = time.perf_counter()
        return step

    def next_step(self) -> Step:
        """Send the traffic's next step and wait for its report (a ``call``
        step: for its return)."""
        kind, spec, commands, state = self.plan.next()
        if "call" in spec:
            step = self._call(spec, commands[0], kind)
        else:
            step = self._send(commands, kind, spec["class"])
            if self.traced:
                step.timings = self.explorer.pipeline.timings_ms
                step.stages = self._stages_run(spec)
        step.state = state
        step.n_time = len(self.explorer.plot.filtered_time)
        return step

    def _stages_run(self, spec) -> tuple:
        """The chain stages a step re-ran: from its ``reruns_from`` stage on,
        the active filters and the transforms; the deconvolution only where
        the step is an Apply (the executor suppresses it otherwise)."""
        p = self.explorer.pipeline
        start = spec.get("reruns_from")
        if start is None:
            return ()
        first = p.fft_index if start == "fft" else p.index_of(start)
        out = []
        for name in p.chain[first:]:
            f = p.filters.get(name)
            if f is None:
                out.append(name)
            elif f.active and (not f.is_deconvolution or start == "deconvolution"):
                out.append(name)
        return tuple(out)

    # ----------------------------------------------------------- window
    def window(self, seconds: float, tracer=None, sample: Optional[dict] = None):
        """Steps back to back for ``seconds``; returns ``(t0, steps,
        trace)``. ``sample`` ({class: k}) keeps, drawn from the seed, k of
        each class's steps completed in the window, each as ``(state,
        output, what it left)``: a ``call`` step's output name and returned
        value, else None and the publish (``check.capture``)
        (``self.samples``)."""
        rng = np.random.default_rng([self.seed, 3])
        sample = sample or {}
        reservoir = {cls: [] for cls in sample}
        seen = {cls: 0 for cls in sample}
        steps, trace = [], None
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter()
        end = t0 + seconds
        trace_end = t0 + min(TRACE_SECONDS, seconds)
        while time.perf_counter() < end:
            step = self.next_step()
            steps.append(step)
            if tracer is not None and trace is None and step.t_done >= trace_end:
                trace = tracer.stop()
            # what a call returned stays only in the sample's reservoir
            result, step.result = step.result, None
            if not step.ok or step.t_done > end or step.cls not in sample:
                continue
            i, k = seen[step.cls], sample[step.cls]
            seen[step.cls] += 1
            slot = i if i < k else int(rng.integers(i + 1))
            if slot < k:
                item = ((step.state, step.output, result) if step.output is not None
                        else (step.state, None, check.capture(self.explorer, self.roi_ids)))
                if i < k:
                    reservoir[step.cls].append(item)
                else:
                    reservoir[step.cls][slot] = item
        if tracer is not None and trace is None:
            trace = tracer.stop()
        self.samples = [item for cls in reservoir for item in reservoir[cls]]
        return t0, steps, trace

    def close(self):
        self.webapp = None
        if self.worker is not None:
            self.worker.close()
        self.worker = self.explorer = None
