"""The port's spans: named stretches of its work, on ``time.perf_counter``.

A span records its name, its start and end on ``time.perf_counter`` (the
clock a benchmark's client and its device-trace alignment use, so spans,
steps and device operations compare with no conversion), its own id, the id
of the span that caused it (the innermost span open on the same thread when
it opened), a request id (the worker's command sequence number, which a
command's spans inherit from its ``worker.command`` span) and optional
attributes. A span opened with ``device=`` also times the device work it
enqueued: a pair of CUDA events on the current stream (host time on the
CPU), read when :attr:`Span.device_ms` is first read.

Spans are recorded exactly while a ``torch.profiler`` session records in
the process, and on every thread: the check reads
``torch.autograd.profiler._is_profiler_enabled``, which the profiler sets
for the process (``torch._C._autograd._profiler_enabled()`` is False on a
thread started before the session). Otherwise :func:`span` returns one
shared no-op context and records nothing. Finished spans are kept in a
bounded deque (the newest :data:`MAX_SPANS`); :func:`spans` returns them.

Span names and where they are opened: ``worker.wait`` (a command's put to
its take) and ``worker.command`` in ``pipeline/worker.py``;
``executor.run`` and ``stage.<chain name>`` in ``pipeline/executor.py``;
``publish`` and ``publish.masks`` in ``pipeline/explorer.py``;
``publish.to_host`` in ``pipeline/publish.py``; ``deconv.plan`` in
``pipeline/filters.py``; ``deconv.spectra``, ``deconv.energy``,
``deconv.rl`` and ``deconv.band_sum`` in ``ops/deconvolution.py``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

#: finished spans kept; older ones are dropped
MAX_SPANS = 65536

_finished: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)


class _Open(threading.local):
    def __init__(self):
        self.stack: list = []


_open = _Open()


def recording() -> bool:
    """True while a ``torch.profiler`` session records in this process."""
    return _profiler._is_profiler_enabled


class Timer:
    """The device time of the work enqueued between its creation and
    :meth:`stop`: a pair of CUDA events on the current stream on a CUDA
    ``device``, two ``time.perf_counter`` readings (host time) on any
    other."""

    __slots__ = ("start", "end", "_ms")

    def __init__(self, device: torch.device):
        if device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter()
        self.end = None
        self._ms: Optional[float] = None

    def stop(self):
        if isinstance(self.start, float):
            self.end = time.perf_counter()
        else:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()

    def ms(self) -> Optional[float]:
        """Milliseconds from the start to :meth:`stop` (None before it);
        on CUDA this waits for the end event the first time."""
        if self._ms is None and self.end is not None:
            if isinstance(self.start, float):
                self._ms = (self.end - self.start) * 1e3
            else:
                self.end.synchronize()
                self._ms = self.start.elapsed_time(self.end)
            self.start = self.end = 0.0  # the events are no longer needed
        return self._ms


class Span:
    """One span (see the module's docstring); a context manager that
    records itself on exit unless :meth:`discard` was called."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "request", "attrs", "_device",
                 "_timer", "_keep")

    def __init__(self, name: str, device=None, timer: Optional[Timer] = None,
                 request=None, attrs: Optional[dict] = None):
        self.name, self.request, self.attrs = name, request, attrs
        self.id = next(_ids)
        self.parent = None
        self.t0 = self.t1 = 0.0
        self._device, self._timer, self._keep = device, timer, True

    def __enter__(self) -> "Span":
        stack = _open.stack
        if stack:
            self.parent = stack[-1].id
            if self.request is None:
                self.request = stack[-1].request
        stack.append(self)
        self.t0 = time.perf_counter()
        if self._device is not None:
            self._timer = Timer(self._device)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._device is not None:
            self._timer.stop()
        self.t1 = time.perf_counter()
        _open.stack.pop()
        if self._keep:
            _finished.append(self)
        return False

    def discard(self):
        """Record nothing of this span (work that turned out not to run)."""
        self._keep = False

    @property
    def device_ms(self) -> Optional[float]:
        """The span's device time in ms: its own events' (``device=``) or
        its timer's; None where it has neither or the timer never stopped."""
        return None if self._timer is None else self._timer.ms()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, {(self.t1 - self.t0) * 1e3:.3f} ms)")


class _NoSpan:
    """What :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def discard(self):
        pass


NO_SPAN = _NoSpan()


def span(name: str, device=None, *, timer: Optional[Timer] = None, request=None,
         attrs: Optional[dict] = None):
    """A context that records the span ``name`` while a profiler session
    records, else :data:`NO_SPAN`. ``device`` (a ``torch.device``): also
    time the device work enqueued inside it; ``timer``: take the device
    time from this :class:`Timer` instead (its owner starts and stops it);
    ``request``: the request id (else the enclosing span's); ``attrs``:
    the span's attributes."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return Span(name, device, timer, request, attrs)


def record(name: str, t0: float, t1: float, *, request=None, attrs: Optional[dict] = None):
    """Record a span that has already ended, from ``t0`` to ``t1`` on
    ``time.perf_counter``, while a profiler session records."""
    if not _profiler._is_profiler_enabled:
        return
    s = Span(name, None, None, request, attrs)
    stack = _open.stack
    if stack:
        s.parent = stack[-1].id
    s.t0, s.t1 = t0, t1
    _finished.append(s)


def spans() -> list[Span]:
    """The finished spans, oldest first (at most :data:`MAX_SPANS`)."""
    return list(_finished.copy())  # one C call: no append can interleave


def clear():
    """Forget every finished span."""
    _finished.clear()
