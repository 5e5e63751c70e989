#!/usr/bin/env python3
"""Where a tilt-slider step's time goes on one NVIDIA GPU.

    python3 scripts/torch_profile_tilt.py [--seed 0] [--steps 4]

Opens ``chip_smoke.py``'s 200x200x1024 scan (dx = dy = 0.5 mm) through
``Explorer(device="cuda")`` with its filters and ROIs, switches tilt
compensation on at (2, 2) degrees, then traces with ``torch.profiler``
``--steps`` tilt-slider steps (each to a time length T no call has used
yet: the step makes cuFFT plans for it) and the same steps again (the plans
cached). Prints one JSON line per step: T, wall ms (host clock around the
command and a synchronize), device-busy ms and idle share, the host-side
rows with the most self time (operators and CUDA runtime calls: plan
creation, allocation, copies, waits) and the kernels with the most device
time; then the first-call cost of the water notch's reduction over its
lines at new frequency counts (``first_use_probe``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import drive_commands, scan_metadata, synthetic_scan  # noqa: E402

TILT = "tilt_compensation"


def traced_step(ex, tilt_x, card, label):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ex.set_filter_param(TILT, "tilt_x", tilt_x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.update_filter(TILT)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    device = sorted((e for e in rows if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    host = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    print(json.dumps({
        "phase": label, "card": card, "T": ex.pipeline.output.n_time, "tilt_x": tilt_x,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "stage_ms": {k: round(v, 3) for k, v in ex.pipeline.timings_ms.items()},
        "top_host": [{"name": e.key[:70], "calls": e.count,
                      "self_ms": e.self_cpu_time_total / 1e3} for e in host[:10]],
        "top_kernels": [{"name": e.key[:70], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in device[:6]],
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_tilt: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build(kernels.SOURCES)
    t, cube = synthetic_scan(200, 200, 1024, seed=args.seed)
    ex = Explorer(device="cuda")
    drive_commands(ex, lambda: ex.open_arrays(t, cube, scan_metadata(0.5)), cube, 2, 2,
                   np.random.default_rng(args.seed))
    ex.set_filter_param(TILT, "tilt_x", 2.0)
    ex.set_filter_param(TILT, "tilt_y", 2.0)
    ex.set_filter_active(TILT, True)
    tilts = [2.0 + 0.02 * (j + 1) for j in range(args.steps)]
    for tx in tilts:
        traced_step(ex, tx, card, "tilt_step_new_T")
    for tx in reversed(tilts):
        traced_step(ex, tx, card, "tilt_step_cached_T")
    first_use_probe(card)
    return 0


def first_use_probe(card):
    """The first call of a reduction over the water notch's (lines, F)
    table at frequency counts no call has used, against a second call: the
    notch's ``torch.prod`` over the lines, and a sum of logarithms in its
    place. Also the card's compiled architectures and module loading."""
    import os

    import torch

    from thz_image_explorer_tpu_torch.assets.water_lines import WATER_LINES_THZ

    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    n_lines = len(WATER_LINES_THZ)
    rows = {}
    for f in range(900, 908):
        x = torch.rand((n_lines, f), device="cuda") + 0.5
        y = torch.rand((n_lines, f + 20), device="cuda") + 0.5
        rows[f] = dict(prod_first_ms=ms(lambda: torch.prod(x, dim=0)),
                       prod_again_ms=ms(lambda: torch.prod(x, dim=0)),
                       logsum_first_ms=ms(lambda: torch.exp(torch.log(y).sum(dim=0))),
                       logsum_again_ms=ms(lambda: torch.exp(torch.log(y).sum(dim=0))))
    print(json.dumps({"phase": "first_use_probe", "card": card, "lines": n_lines,
                      "arch_list": torch.cuda.get_arch_list(), "cuda": torch.version.cuda,
                      "module_loading": os.environ.get("CUDA_MODULE_LOADING"),
                      "by_F": rows}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
