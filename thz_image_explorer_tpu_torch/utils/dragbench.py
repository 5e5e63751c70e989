"""Sustained slider-drag replay through the live HTTP API.

The port's own copy of ``thz_image_explorer_tpu/utils/dragbench.py``. The
reference's latest-wins config channel (``config.rs:41-51``) exists
so a drag can never build a queue: a newer slider value replaces the
pending one and the GUI's next frame shows the newest state the compute
thread reached. This module measures that contract AT THE PRODUCT SEAM
— real HTTP POSTs against a live ``ThreadingHTTPServer`` + worker, a
concurrent ``/api/state`` poller playing the browser — and reports:

* ``drag_p50_ms`` / ``drag_p99_ms``: end-to-end staleness latency per
  event — the time from POSTing a slider value until a state poll first
  OBSERVES that value or a newer one (latest-wins: an event superseded
  by a newer value is satisfied the moment the newer update is visible,
  exactly what the user sees during a drag);
* ``drag_updates_per_s``: chain updates the worker actually executed
  per second (coalescing makes this less than the offered event rate);
* ``drag_p99_ms`` bounded ≈ one in-flight update + one pending
  coalesced update + a state build — independent of the event count —
  is the no-queue-blowup evidence.

Used by ``chip_smoke.py``'s shell phase (a 100-event drag at 200x200x1024
on the card) and ``tests/test_torch_web.py`` (a small scan on the CPU).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Optional

#: Methods this harness can observe through /api/state, mapped to the
#: state-JSON extractor the poller uses to decide an event is satisfied.
#: The drag values must be strictly increasing for the latest-wins
#: satisfaction rule to hold, which both window bounds respect.
_OBSERVERS = {
    "set_fft_window_low":
        lambda s: (s.get("config") or {}).get("fft_window", [None, None])[0],
    "set_fft_window_high":
        lambda s: (s.get("config") or {}).get("fft_window", [None, None])[1],
}


def _post_command(host: str, port: int, method: str, args: list,
                  timeout: float = 30.0) -> float:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request(
            "POST", "/api/command",
            body=json.dumps({"method": method, "args": args}),
            headers={
                "Host": f"localhost:{port}",
                "Content-Type": "application/json",
                "Origin": f"http://localhost:{port}",
            },
        )
        r = conn.getresponse()
        body = r.read()
        if r.status != 200 or not json.loads(body).get("ok"):
            raise RuntimeError(f"command {method} failed: {r.status} {body!r}")
        return time.perf_counter() - t0
    finally:
        conn.close()


def replay_drag(
    port: int,
    *,
    n_events: int = 100,
    lo: float = 1.0,
    hi: float = 1.5,
    interval_s: float = 0.008,
    settle_timeout_s: float = 120.0,
    host: str = "127.0.0.1",
    app=None,
    method: str = "set_fft_window_low",
) -> dict:
    """Replay an ``n_events`` drag of ``method`` from ``lo`` to ``hi``
    (strictly increasing values — the monotonicity is what lets a poll
    observation satisfy every not-yet-seen older event) at ~125 Hz mouse
    cadence, with a concurrent ``/api/state`` poller.

    ``app`` (optional, in-process ``WebApp``): when given, the worker's
    ``pipeline.run_from`` (``pipeline/executor.py``) is wrapped for the
    duration to count the chain updates actually executed — the honest
    ``drag_updates_per_s`` numerator (HTTP-only observers undercount when
    polls are slower than updates).

    ``method`` must be one the poller knows how to observe in the state
    JSON (``_OBSERVERS``) — anything else would silently time out every
    event instead of measuring, so it raises.
    """
    observe = _OBSERVERS.get(method)
    if observe is None:
        raise ValueError(
            f"replay_drag cannot observe {method!r} through /api/state; "
            f"supported: {sorted(_OBSERVERS)}")
    values = [lo + (hi - lo) * (i + 1) / n_events for i in range(n_events)]

    # poller: full /api/state GETs back to back — each one rides the
    # worker queue (single-writer discipline) like the browser's poll
    polls: list = []  # (t_done, observed_value)
    stop = threading.Event()

    def poll_loop():
        while not stop.is_set():
            conn = http.client.HTTPConnection(host, port, timeout=30)
            try:
                conn.request("GET", "/api/state",
                             headers={"Host": f"localhost:{port}"})
                r = conn.getresponse()
                s = json.loads(r.read())
                v = observe(s)
                if v is not None:
                    polls.append((time.perf_counter(), float(v)))
            except Exception:  # noqa: BLE001 — poller must survive races
                pass
            finally:
                conn.close()

    n_updates = 0
    orig_run_from = None
    pipeline = None
    if app is not None:
        pipeline = app.worker.explorer.pipeline
        orig_run_from = pipeline.run_from

        def counting_run_from(*a, **kw):
            nonlocal n_updates
            n_updates += 1
            return orig_run_from(*a, **kw)

        pipeline.run_from = counting_run_from

    poller = threading.Thread(target=poll_loop, daemon=True)
    sends: list = []  # (t_sent, value)
    post_ms: list = []
    try:
        poller.start()
        t_start = time.perf_counter()
        for v in values:
            t_due = time.perf_counter()
            post_ms.append(_post_command(host, port, method, [v]) * 1e3)
            sends.append((t_due, v))
            rest = interval_s - (time.perf_counter() - t_due)
            if rest > 0:
                time.sleep(rest)
        send_loop_s = time.perf_counter() - t_start
        # settle: keep polling until the LAST value is observed
        deadline = time.perf_counter() + settle_timeout_s
        while time.perf_counter() < deadline:
            if polls and polls[-1][1] >= values[-1] - 1e-9:
                break
            time.sleep(0.002)
        t_end = time.perf_counter()
    finally:
        stop.set()
        poller.join(timeout=10)
        if pipeline is not None:
            pipeline.run_from = orig_run_from

    # per-event latency: first poll at/after the event's value
    snapshot = list(polls)
    latencies = []
    unsatisfied = 0
    for t_sent, v in sends:
        sat = [t for (t, ov) in snapshot if ov >= v - 1e-9 and t >= t_sent]
        if sat:
            latencies.append((min(sat) - t_sent) * 1e3)
        else:
            unsatisfied += 1
    latencies.sort()

    def pct(p):
        if not latencies:
            return None
        return round(latencies[min(len(latencies) - 1,
                                   int(p / 100.0 * len(latencies)))], 2)

    duration = t_end - t_start
    out = {
        "drag_events": n_events,
        "drag_p50_ms": pct(50),
        "drag_p99_ms": pct(99),
        "drag_posts_per_s": round(n_events / max(send_loop_s, 1e-9), 1),
        "drag_post_p99_ms": round(sorted(post_ms)[int(0.99 * len(post_ms))
                                                  if len(post_ms) > 1 else 0],
                                  2),
        "drag_duration_s": round(duration, 3),
        "drag_polls": len(snapshot),
        "drag_unsatisfied_events": unsatisfied,
        "drag_note": (
            "p50/p99 = time from HTTP POST of a slider value until "
            "/api/state first shows that value or a newer one "
            "(latest-wins staleness, config.rs:41-51); updates/s = chain "
            "dispatches the worker executed / drag duration (coalescing "
            "keeps it below the offered event rate by design)"
        ),
    }
    if app is not None:
        out["drag_chain_updates"] = n_updates
        out["drag_updates_per_s"] = round(n_updates / max(duration, 1e-9), 1)
    return out
