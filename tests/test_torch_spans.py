"""The port's spans (``utils/spans.py``) through its command worker.

Spans record only while a ``torch.profiler`` session records, which here is
started after the worker's thread, as a benchmark's tracer starts it. A
slider step and an Apply are sent to an ``ExplorerWorker`` on a 20x18x64
scan: off they record nothing; on, every span of a command nests in time
inside its parent, shares the command's request id and lies between the
command's send and its report. No test asserts a duration.
"""

import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from make_sample import synthetic_scan
from test_torch_deconv import synthetic_psf_arrays
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch.io.dotthz import DotthzMetadata
from thz_image_explorer_tpu_torch.pipeline.worker import CommandQueue, ExplorerWorker
from thz_image_explorer_tpu_torch.utils import spans

WAIT = 60.0
DEC = "deconvolution"
PHASES = ["deconv.plan", "deconv.spectra", "deconv.energy", "deconv.rl", "deconv.band_sum"]
#: (step, commands): a slider step re-runs the chain from the FFT with the
#: deconvolution suppressed; an Apply re-runs the deconvolution
STEPS = {
    "slider": [("set_fft_window_low", (1.1,), {})],
    "apply": [("update_filter", (DEC,), {"force": True})],
}


class Session:
    """A worker on a small scan with ROIs, a PSF and the deconvolution on;
    :meth:`step` sends commands and returns their send time and the time
    of the last ``on_update`` report."""

    def __init__(self):
        self.worker = ExplorerWorker(device="cpu")
        self.reports = []
        self.worker.on_update(lambda _ex: self.reports.append(time.perf_counter()))
        t, cube = synthetic_scan(width=20, height=18, n_time=64)
        md = DotthzMetadata(md={"dx [mm]": "1.0", "dy [mm]": "1.0"})
        self.step([("open_arrays", (t, cube, md), {}),
                   ("add_roi", ("u1", "r1", [(1, 1), (9, 1), (9, 8)]), {}),
                   ("set_reference", ("r1",), {}),
                   ("set_sample", ("Selected Pixel",), {}),
                   ("apply_psf", (convert.psf_from_numpy(synthetic_psf_arrays()),), {})]
                  + [("set_filter_param", (DEC, k, v), {}) for k, v in
                     (("n_filters", 3), ("n_iterations", 4), ("start_freq", 0.25),
                      ("end_freq", 4.0))]
                  + [("set_filter_active", (DEC, True), {})])
        self.step(STEPS["apply"])
        assert not self.worker.failures, list(self.worker.failures)

    def step(self, commands):
        self.reports.clear()
        t_send = time.perf_counter()
        for method, args, kwargs in commands:
            self.worker.send(method, *args, **kwargs)
        assert self.worker.join_idle(WAIT)
        assert len(self.reports) >= len(commands)
        return t_send, self.reports[-1]


@pytest.fixture(scope="module")
def session():
    s = Session()
    yield s
    s.worker.close()


def _traced(session, commands):
    """``commands`` sent under a profiler started now, after the worker's
    thread; ``(send, report, spans)``."""
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        t_send, t_report = session.step(commands)
    got = spans.spans()
    spans.clear()
    return t_send, t_report, got


def test_profiler_is_off_on_the_worker_thread_it_predates(session):
    """The condition the module's switch works around: the worker thread
    started before the session sees the C++ flag off."""
    import torch

    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        session.worker.call(lambda _ex: seen.append(
            (torch._C._autograd._profiler_enabled(), spans.recording())), timeout=WAIT)
    assert seen == [(False, True)]


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_off_records_nothing(session, kind):
    spans.clear()
    session.step(STEPS[kind])
    assert spans.spans() == []
    assert spans.span("publish") is spans.NO_SPAN
    assert spans.span("deconv.rl", object(), attrs={"method": "x"}) is spans.NO_SPAN


def test_slider_command_spans(session):
    _, _, got = _traced(session, STEPS["slider"])
    names = [s.name for s in got]
    p = session.worker.explorer.pipeline
    ran = {"stage." + name for i, name in enumerate(p.chain)
           if i > p.fft_index - 1 and p.slots[i] is not p.slots[i - 1]}
    stages = [n for n in names if n.startswith("stage.")]
    assert sorted(stages) == sorted(ran) and len(stages) == len(set(stages))
    assert "stage.fft" in ran and "stage." + DEC not in ran
    for name in ("worker.wait", "worker.command", "executor.run", "publish",
                 "publish.masks"):
        assert names.count(name) == 1, (name, names)
    assert names.count("publish.to_host") == 2  # the reductions, then the selection
    command = next(s for s in got if s.name == "worker.command")
    assert command.attrs == {"method": "set_fft_window_low"}
    run = next(s for s in got if s.name == "executor.run")
    assert all(s.parent == run.id for s in got if s.name.startswith("stage."))


def test_apply_phases_in_order_under_the_stage(session):
    _, _, got = _traced(session, STEPS["apply"])
    stage = [s for s in got if s.name == "stage." + DEC]
    assert len(stage) == 1
    under = sorted((s for s in got if s.parent == stage[0].id), key=lambda s: s.t0)
    assert [s.name for s in under] == PHASES
    assert all(s.device_ms is not None for s in under[1:])  # host time on the CPU
    assert under[0].device_ms is None  # the plan is host work only


def test_rl_span_carries_the_wide_launches(session, monkeypatch):
    """The ``deconv.rl`` span's attributes: the Apply's launches on the wide
    route and each one's blocks per band, none on the CPU; through a
    stand-in for the kernel's wrapper that reports two such launches, those
    two. ``annotate`` on the no-op span does nothing."""
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import rlsep

    _, _, got = _traced(session, STEPS["apply"])
    rl = [s for s in got if s.name == "deconv.rl"]
    assert len(rl) == 1 and rl[0].attrs == {"wide_launches": 0, "sms_per_band": []}
    real = rlsep.rl_bands_separable

    def wide(*args, **kwargs):
        out = real(*args, **kwargs)
        real.launches_wide += 2
        real.wide_blocks = [(37, 20), (69,)]
        return out

    monkeypatch.setattr(real, "launches_wide", 5)
    monkeypatch.setattr(real, "wide_blocks", [])
    monkeypatch.setattr(dec, "rl_bands_separable", wide)
    _, _, got = _traced(session, STEPS["apply"])
    rl = [s for s in got if s.name == "deconv.rl"]
    assert rl[0].attrs == {"wide_launches": 2, "sms_per_band": [(37, 20), (69,)]}
    spans.NO_SPAN.annotate(wide_launches=1)
    assert spans.span("deconv.rl") is spans.NO_SPAN


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_spans_nest_share_the_request_and_lie_inside_the_step(session, kind):
    t_send, t_report, got = _traced(session, STEPS[kind])
    assert got
    by_id = {s.id: s for s in got}
    command = [s for s in got if s.name == "worker.command"]
    assert len(command) == 1
    request = command[0].request
    assert request is not None
    for s in got:
        assert s.request == request, s
        assert s.t0 <= s.t1, s
        assert t_send <= s.t0, s
        if s.name != "worker.command":  # it also holds the on_update callbacks
            assert s.t1 <= t_report, s
        if s.name == "worker.wait":
            assert s.parent is None and s.t1 <= command[0].t0
        elif s.name != "worker.command":
            parent = by_id[s.parent]
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1, (s, parent)
            root = s
            while root.parent is not None:
                root = by_id[root.parent]
            assert root is command[0], s


def test_stage_spans_read_the_timings_of_the_executor(session):
    """The stage spans and ``timings_ms`` share their timers: equal values."""
    _, _, got = _traced(session, STEPS["apply"] + STEPS["slider"])
    timings = session.worker.explorer.pipeline.timings_ms
    last = {}
    for s in got:
        if s.name.startswith("stage."):
            last[s.name[len("stage."):]] = s.device_ms
    assert DEC in last and "fft" in last
    for name, ms in last.items():
        assert timings[name] == ms, name


def test_timings_keys_equal_with_and_without_spans():
    """Two fresh sessions, one traced: the same commands give the same
    ``timings_ms`` keys."""
    keys = []
    for traced in (False, True):
        s = Session()
        try:
            if traced:
                _traced(s, STEPS["slider"] + STEPS["apply"])
            else:
                s.step(STEPS["slider"] + STEPS["apply"])
            keys.append(sorted(s.worker.explorer.pipeline.timings_ms))
        finally:
            s.worker.close()
    assert keys[0] == keys[1] and DEC in keys[0]


def test_coalesced_put_keeps_the_first_stamp():
    q = CommandQueue()
    with profile(activities=[ProfilerActivity.CPU]):
        t_before = time.perf_counter()
        q.put(("set_fft_window_low", (1.0,), {}), key=("set_fft_window_low",))
        t_first = time.perf_counter()
        q.put(("set_fft_window_low", (1.2,), {}), key=("set_fft_window_low",))
        assert q.take(timeout=1) == ("set_fft_window_low", (1.2,), {})
    assert t_before <= q.pop_stamp <= t_first
    q.put(("publish", (), {}), key=("publish",))
    assert q.take(timeout=1) is not None and q.pop_stamp is None


def test_spans_of_threads_nest_per_thread():
    """Each thread's spans take their parents from that thread alone."""
    spans.clear()
    barrier = threading.Barrier(2, timeout=WAIT)

    def work(tag):
        with spans.span("outer", request=tag):
            barrier.wait()
            with spans.span("inner"):
                barrier.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(tag,)) for tag in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    got = spans.spans()
    spans.clear()
    outer = {s.request: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner":
            assert s.parent == outer[s.request].id


def test_the_deque_stays_bounded():
    spans.clear()
    extra = 10
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(spans.MAX_SPANS + extra):
            spans.record("worker.wait", float(i), float(i), request=i)
    got = spans.spans()
    spans.clear()
    assert len(got) == spans.MAX_SPANS
    assert got[0].request == extra and got[-1].request == spans.MAX_SPANS + extra - 1
    assert np.all(np.diff([s.request for s in got]) == 1)
