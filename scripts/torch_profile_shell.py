#!/usr/bin/env python3
"""Where the web shell's time goes on the card.

    python3 scripts/torch_profile_shell.py [--reps 20] [--seed 0]

Opens the README's 200x200x1024 scan (``chip_smoke.synthetic_scan``, the
smoke's filters, ROIs and optical selection) in a ``WebApp`` on the card
and times, each as the median of ``--reps`` runs with host clocks:

* a slider step's chain update and publish on the worker
  (``Explorer.set_fft_window_low``, a synchronize on each side);
* one state build (``WebApp._build_state``) with the PNG cache hit, and its
  parts: the plot series' rounding (``web._series``) and, for a cache miss,
  the colormap and the pure-Python PNG encode of the image;
* the JSON encode of a state, and a ``GET /api/state`` round trip through
  ``make_handler`` on loopback;
* the worker's command FIFO (``pipeline/worker.CommandQueue``): the
  put-to-take hand-off between two threads, median and p99 of
  ``--handoffs``.

Prints one JSON line with the card's name and power limit and writes it to
``chiprun_out/profile_shell.json``. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def median_ms(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def handoff_us(queue, n):
    """Median and p99 (µs) of the time from ``queue.put`` in one thread
    until ``queue.take`` returns it in another, one item in flight."""
    got = threading.Event()
    lat = []

    def consume():
        while len(lat) < n:
            t_put = queue.take(timeout=0.1)
            if t_put is not None:
                lat.append((time.perf_counter() - t_put) * 1e6)
                got.set()

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    for _ in range(n):
        got.clear()
        queue.put(time.perf_counter())
        assert got.wait(5), "the consumer took nothing"
    consumer.join(timeout=5)
    lat.sort()
    return statistics.median(lat), lat[int(0.99 * (len(lat) - 1))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--handoffs", type=int, default=2000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_shell: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from thz_image_explorer_tpu_torch import web
    from thz_image_explorer_tpu_torch.viz import intensity_image_rgba

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t, cube = cs.synthetic_scan(200, 200, 1024, seed=args.seed)
    app = web.WebApp(device="cuda")
    server = ThreadingHTTPServer(("127.0.0.1", 0), web.make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        app.worker.send("open_arrays", t, cube, cs.scan_metadata(0.5))
        cs.shell_commands(app, 200, 200)
        assert app.worker.join_idle(300)
        ex = app.worker.explorer
        client = cs.ShellClient(server.server_address[1])
        client.fresh_state()
        step = iter(range(10 ** 6))

        def slider():
            torch.cuda.synchronize()
            ex.set_fft_window_low(1.0 + 0.001 * (next(step) % 500))
            torch.cuda.synchronize()

        out = {"card": smi, "shape": [200, 200, 1024], "reps": args.reps}
        out["chain_update_ms"] = app.worker.call(lambda _e: median_ms(slider, args.reps),
                                                 timeout=600)
        series_ms = []
        real_series = web._series

        def timed_series(*a, **k):
            t0 = time.perf_counter()
            r = real_series(*a, **k)
            series_ms[-1] += (time.perf_counter() - t0) * 1e3
            return r

        def build():
            series_ms.append(0.0)
            return app._build_state(ex)

        web._series = timed_series
        try:
            out["state_build_hit_ms"] = app.worker.call(
                lambda _e: median_ms(build, args.reps), timeout=600)
        finally:
            web._series = real_series
        out["series_rounding_ms"] = statistics.median(series_ms)
        out["series_values"] = sum(
            len(v) if isinstance(v, list) else sum(len(x["y"]) for x in v.values())
            for k, v in app.state()["plots"].items() if k != "water_lines")
        image = ex.image
        out["image_colormap_ms"] = median_ms(lambda: intensity_image_rgba(image), args.reps)
        rgba = intensity_image_rgba(image)
        out["png_encode_ms"] = median_ms(lambda: web.encode_png(rgba), args.reps)
        state = app.state()
        out["json_encode_ms"] = median_ms(lambda: json.dumps(state, allow_nan=False), args.reps)
        out["json_bytes"] = len(json.dumps(state))
        out["http_state_hit_ms"] = median_ms(client.state, args.reps)

        from thz_image_explorer_tpu_torch.pipeline.worker import CommandQueue

        q = CommandQueue()
        try:
            out["fifo_handoff_us"] = handoff_us(q, args.handoffs)
        finally:
            q.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        app.worker.close()
    line = json.dumps(out)
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "profile_shell.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
