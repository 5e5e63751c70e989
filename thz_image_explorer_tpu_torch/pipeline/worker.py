"""Asynchronous pipeline worker with per-key command coalescing.

Port of ``thz_image_explorer_tpu/pipeline/worker.py``: the host-threading
equivalent of the reference's two-thread architecture, where the GUI
thread sends commands to ``main_thread`` (``data_thread.rs:148``), which
owns all compute. The reference has two channels: a bounded(1)
latest-wins channel for config commands (``config.rs:41-51``) and an
unbounded one for ROI operations, consumed losslessly
(``config.rs:296-299``). Here both lanes live in ONE FIFO with per-key
coalescing on top: a command with a coalescing key (slider moves, pixel clicks,
per-filter updates) replaces a still-queued command of the same key in
place, keeping its queue position; one-shot commands (ROI edits,
open/save, Apply) get unique keys and are never dropped.

Abort follows the reference: it cancels the stage in flight and drains
the pending commands (``data_thread.rs:163-172``).

Two differences from the JAX worker, both deliberate:

* no idle housekeeping: the port's executor times every stage with CUDA
  events, so there is no shadow timing pass to debounce, and idle is
  signalled as soon as the queue is empty;
* a pending two-phase open is finalized before every mutating command
  except the three that supersede it: ``open_file``, ``open_sibling`` and
  ``open_arrays`` (and the finalize itself).
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Optional

from thz_image_explorer_tpu_torch.pipeline.explorer import Explorer
from thz_image_explorer_tpu_torch.utils import spans

log = logging.getLogger(__name__)

#: Explorer methods that coalesce per method name: continuous controls
#: where only the latest value matters (the reference's latest-wins set,
#: ``config.rs:58-164``)
COALESCE_BY_METHOD = frozenset(
    {
        "set_fft_window_low",
        "set_fft_window_high",
        "set_fft_window_type",
        "set_fft_log_plot",
        "set_avg_in_fourier_space",
        "set_fft_resolution",
        "set_downscaling",
        "set_selected_pixel",
        "set_reference",
        "set_sample",
        "set_material_thickness",
        "update_material_calculation",
        "set_3d_contrast",
        "set_kernel_sigma",
        "set_kernel_radius",
        "set_opacity_threshold",
        "publish",
    }
)

#: per (method, first positional arg): per-filter updates and per-name
#: metadata edits
COALESCE_BY_METHOD_AND_ARG = frozenset(
    {"update_filter", "set_filter_active", "set_metadata_field", "set_metadata_attr"}
)

#: per (method, first two args): one pending value per (filter, parameter)
COALESCE_BY_METHOD_AND_TWO_ARGS = frozenset({"set_filter_param"})

#: commands that supersede a pending open instead of finalizing it first
SUPERSEDES_OPEN = frozenset({"_finalize_open", "open_file", "open_sibling", "open_arrays"})


def coalesce_key(method: str, args: tuple, kwargs: Optional[dict] = None
                 ) -> Optional[tuple]:
    """Coalescing key for a command, or None for a lossless one-shot. A
    command sent with kwargs is always a one-shot: the key is made from
    positional args only, so two kwarg-sent commands with different
    payloads would otherwise collapse and the first be dropped."""
    if kwargs:
        return None
    if method in COALESCE_BY_METHOD:
        return (method,)
    if method in COALESCE_BY_METHOD_AND_ARG:
        return (method, args[0] if args else None)
    if method in COALESCE_BY_METHOD_AND_TWO_ARGS:
        return (method,) + tuple(args[:2])
    return None


class CommandQueue:
    """Unbounded FIFO with per-key latest-wins coalescing.

    Payloads are keyed by a sequence number that rides the FIFO; coalescing
    replaces a queued key's payload in place (same seq, same position), so
    the queue holds at most one command per distinct key. While spans
    record (``utils.spans``), a put is stamped on ``time.perf_counter``; a
    coalesced put keeps the first put's stamp.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: abort bookkeeping, both changed only under ``_lock``:
        #: ``abort_epoch`` counts drains; ``pop_epoch`` is the epoch at the
        #: moment take() committed its payload (the critical section a
        #: concurrent drain would have removed it in). A popped command with
        #: ``pop_epoch == abort_epoch`` was enqueued after the last drain;
        #: one with less escaped a drain in flight and must honour that abort
        self.abort_epoch = 0
        self.pop_epoch = 0
        #: the sequence number and put stamp (None: not stamped) of the
        #: payload the last take() returned
        self.pop_seq = 0
        self.pop_stamp: Optional[float] = None
        self._seq = 0
        self._by_key: dict[Any, list] = {}  # key -> [seq, payload, put stamp]
        self._seq2key: dict[int, Any] = {}
        self._fifo: deque[int] = deque()
        self._closed = False

    def put(self, command: Any, key: Optional[Any] = None):
        """Enqueue; a non-None ``key`` coalesces against a queued command
        with the same key (the newer payload wins, the position is kept)."""
        with self._cv:
            if key is not None and key in self._by_key:
                self._by_key[key][1] = command
                return
            self._seq += 1
            seq = self._seq
            if key is None:
                key = ("#oneshot", seq)
            stamp = time.perf_counter() if spans.recording() else None
            self._by_key[key] = [seq, command, stamp]
            self._seq2key[seq] = key
            self._fifo.append(seq)
            self._cv.notify()

    def take(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocking FIFO take; None on timeout or close."""
        with self._cv:
            if not self._fifo and not self._closed:
                self._cv.wait(timeout)
            if not self._fifo:
                return None
            key = self._seq2key.pop(self._fifo.popleft())
            self.pop_epoch = self.abort_epoch
            self.pop_seq, command, self.pop_stamp = self._by_key.pop(key)
            return command

    def empty(self) -> bool:
        with self._lock:
            return not self._by_key

    def drain(self) -> int:
        """Drop every pending command (abort)."""
        with self._lock:
            had = len(self._by_key)
            self._by_key.clear()
            self._seq2key.clear()
            self._fifo.clear()
            self.abort_epoch += 1
            return had

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class ExplorerWorker:
    """Worker thread owning an Explorer; commands are (method, args).

    ``ExplorerWorker(explorer=None, device=None)`` builds an Explorer on
    ``device`` (None: the card) unless one is given."""

    def __init__(self, explorer: Optional[Explorer] = None, device=None):
        self.explorer = explorer if explorer is not None else Explorer(device=device)
        self.queue = CommandQueue()
        self.abort_flag = threading.Event()
        # Serializes abort() against _run's stale-flag clear: holding it
        # across both the (drain, flag.set) pair and the (epoch compare,
        # flag.clear) pair makes the decision atomic, so no interleaving
        # clears a fresh abort or cancels a command sent after it
        self._abort_lock = threading.Lock()
        self.explorer.pipeline.cancelled = self._cancelled
        # the two-phase open defers its device phase through the queue, so
        # state reads between the phases are served the preview
        self.explorer.defer = self._defer
        self._on_update: list[Callable[[Explorer], None]] = []
        #: (method, formatted exception) of the last commands that raised:
        #: they are logged and the worker goes on, so callers that must
        #: know every outcome read this
        self.failures: deque = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="thz-worker")
        self._idle = threading.Event()
        self._idle.set()
        # clearing idle and publishing a command happen atomically with
        # respect to the worker's "queue empty -> idle" decision
        self._idle_lock = threading.Lock()
        self._thread.start()

    def send(self, method, *args, **kwargs):
        """Enqueue a command: an Explorer method's name, or a callable run
        as ``method(explorer)``. Slider-type commands coalesce against a
        pending command of the same key; the rest (ROI edits, open/save,
        Apply, callables) are lossless FIFO (``config.rs:41-51`` vs
        ``:296-299``)."""
        with self._idle_lock:
            self._idle.clear()
            self.queue.put((method, args, kwargs), key=coalesce_key(method, args, kwargs))

    def call(self, fn: Callable[[Explorer], Any], *, timeout: float = 2.0):
        """Run ``fn(explorer)`` on the worker thread and return its result:
        request threads never touch the Explorer themselves (the
        reference's ``Arc<RwLock>`` discipline, ``config.rs:219-304``).
        Raises ``TimeoutError`` when the worker is busy for longer (a long
        Apply); callers fall back to their last snapshot, as the reference
        GUI's ``try_read`` skips a frame (``center_panel.rs:32``)."""
        done = threading.Event()
        box: dict[str, Any] = {}

        def run(ex):
            try:
                box["result"] = fn(ex)
            except Exception as e:  # noqa: BLE001 - re-raised in the caller
                box["error"] = e
            finally:
                done.set()

        with self._idle_lock:
            self._idle.clear()
            self.queue.put((run, (), {}))
        if not done.wait(timeout):
            raise TimeoutError("worker busy")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _defer(self, method: str, *args):
        """Enqueue a follow-up from inside a running command (the
        two-phase open): a lossless one-shot after everything already
        queued, so ``call()`` closures sent during phase 1 see the preview
        before the device phase blocks the worker."""
        self.queue.put((method, args, {}))

    def _cancelled(self) -> bool:
        return self.abort_flag.is_set()

    def abort(self):
        """Abort the work in flight and drain the pending commands
        (``data_thread.rs:163-172``): drain first (bumping the abort epoch
        under the queue's lock), then raise the flag, so a command popped
        concurrently carries a pre-drain pop epoch and is cancelled too."""
        with self._abort_lock:
            self.queue.drain()
            self.abort_flag.set()

    def on_update(self, callback: Callable[[Explorer], None]):
        self._on_update.append(callback)

    def join_idle(self, timeout: Optional[float] = None) -> bool:
        """Wait until the queue is empty and the worker is idle."""
        return self._idle.wait(timeout)

    def close(self):
        self._stop.set()
        self.queue.close()
        self._thread.join(timeout=5)

    def _run(self):
        while not self._stop.is_set():
            cmd = self.queue.take(timeout=0.1)
            if cmd is not None:
                seq = self.queue.pop_seq
                if self.queue.pop_stamp is not None:
                    spans.record("worker.wait", self.queue.pop_stamp, time.perf_counter(),
                                 request=seq)
                self._idle.clear()
                # clear only a provably stale abort: equal epochs mean no
                # drain ran after this command's payload lookup
                with self._abort_lock:
                    if self.queue.pop_epoch == self.queue.abort_epoch:
                        self.abort_flag.clear()
                with spans.span("worker.command", request=seq,
                                attrs={"method": getattr(cmd[0], "__name__", cmd[0])}):
                    self._execute(*cmd)
            if self._stop.is_set():
                continue  # close() woke the take(): start no device work
            # evaluated after every iteration, so a reader polling call()
            # faster than the take timeout cannot starve join_idle
            with self._idle_lock:
                if self.queue.empty():
                    self._idle.set()

    def _execute(self, method, args, kwargs):
        try:
            if callable(method):  # a closure from call()
                method(self.explorer)
                return
            if method not in SUPERSEDES_OPEN:
                # single-phase ordering for mutating commands: finalize a
                # pending open first, or its deferred finalize would reset
                # the filters under e.g. a queued set_filter_param. A
                # finalize failure rolls back and consumes the open, so the
                # command still runs, against the previous scan
                try:
                    self.explorer._ensure_open_finalized()
                except Exception:  # noqa: BLE001 - logged; the command runs
                    log.exception("deferred open failed")
                    self.failures.append(("_finalize_open", traceback.format_exc()))
            getattr(self.explorer, method)(*args, **kwargs)
            for cb in self._on_update:
                cb(self.explorer)
        except Exception:  # noqa: BLE001 - the worker survives bad commands
            log.exception("command %r failed", method)
            self.failures.append((getattr(method, "__name__", method), traceback.format_exc()))
