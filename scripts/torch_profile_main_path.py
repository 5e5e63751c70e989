#!/usr/bin/env python3
"""Where the port's main-path time goes on one NVIDIA GPU.

    python3 scripts/torch_profile_main_path.py [--seed 0] [--size 200]

Opens the synthetic size x size x 1024 scan of ``chip_smoke.py`` through
``Explorer(device="cuda")`` with the same filters and ROIs, warms up, then
traces 5 slider updates and 10 pixel clicks with ``torch.profiler``; then
the 3-D view of the final slot at ``chip_smoke.py``'s view settings: 5
traced live views (``extract_instances_topk`` as web.py serves it) and one
traced dense extraction (the VTU export's). Then the Apply path of
``chip_smoke.py`` (its synthetic PSF, default 25 bands / 500 iterations):
one untraced first Apply, which plans the bands on the host (the script
also times that host planning on its own: ``plan_bands`` and the energy
matrices), and 2 traced repeat Applies (plan cached). Prints one JSON line
per traced phase: wall ms per command (host clock around work that ends in a
synchronize), device-busy ms per command (the sum of the kernels' and
copies' own device time), the device's idle share, the kernels and copies
launched per command, and the 12 kernels with the most device time.
Needs a CUDA device.
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

from chip_smoke import (  # noqa: E402
    _VIEW_MAX_POINTS,
    _VIEW_OPACITY_THRESHOLD,
    roi_polygons,
    scan_metadata,
    synthetic_psf,
    synthetic_scan,
    view_args,
)


def traced(label, commands, card):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cmd in commands:
            cmd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): the operator rows above
    # them carry the same device time again
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    n = len(commands)
    print(json.dumps({
        "phase": label, "card": card, "commands": n,
        "wall_ms_per_command": wall_ms / n,
        "device_busy_ms_per_command": busy_ms / n,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_launches_per_command": sum(e.count for e in rows) / n,
        "top_kernels": [
            {"name": e.key[:80], "calls_per_command": e.count / n,
             "device_ms_per_command": e.self_device_time_total / 1e3 / n}
            for e in rows[:12]
        ],
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=200)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kernels.build()
    t, cube = synthetic_scan(args.size, args.size, 1024, seed=args.seed)
    ex = Explorer(device="cuda")
    ex.open_arrays(t, cube, scan_metadata(0.5))
    for uuid in ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch"):
        ex.set_filter_active(uuid, True)
    for i, poly in enumerate(roi_polygons(args.size, args.size)):
        ex.add_roi(f"roi-{i}", f"ROI {i}", poly)
    ex.set_reference("ROI 0")
    ex.set_sample("Selected Pixel")
    for i in range(3):  # warm-up
        ex.set_fft_window_low(1.0 + 0.01 * i)
        ex.set_selected_pixel(i, i)
    rng = np.random.default_rng(args.seed)
    traced("slider_update", [
        (lambda i=i: ex.set_fft_window_low(1.1 + 0.05 * i)) for i in range(5)
    ], card)
    traced("pixel_click", [
        (lambda: ex.set_selected_pixel(int(rng.integers(args.size)),
                                       int(rng.integers(args.size))))
        for _ in range(10)
    ], card)
    print(json.dumps({"stage_ms_last_run": ex.pipeline.timings_ms, "card": card}))

    from thz_image_explorer_tpu_torch.ops import voxel

    ex.set_opacity_threshold(_VIEW_OPACITY_THRESHOLD)
    data3d, kw3d = view_args(ex)

    def live():
        voxel.extract_instances_topk(data3d, max_points=_VIEW_MAX_POINTS, **kw3d)

    live()  # warm-up
    traced("view3d_live", [live] * 5, card)
    traced("view3d_dense", [lambda: voxel.extract_instances(data3d, **kw3d)], card)
    del data3d

    from thz_image_explorer_tpu_torch.ops import deconvolution as dec

    psf = synthetic_psf()
    params = ex.pipeline.filters["deconvolution"].params
    t0 = time.perf_counter()
    geometry = dec.plan_bands(params, psf, t, (args.size, args.size), 0.5, 0.5)
    t1 = time.perf_counter()
    n_taps = geometry.taps.shape[1]
    dec._energy_matrices(geometry.taps, dec._conv_len(1024 + n_taps - 1), 1024)
    t2 = time.perf_counter()
    print(json.dumps({"host_plan_bands_ms": (t1 - t0) * 1e3,
                      "host_energy_matrices_ms": (t2 - t1) * 1e3, "card": card}), flush=True)
    ex.apply_psf(psf)
    ex.set_filter_active("deconvolution", True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.update_filter("deconvolution", force=True)
    torch.cuda.synchronize()
    print(json.dumps({"first_apply_wall_ms": (time.perf_counter() - t0) * 1e3,
                      "card": card}), flush=True)
    traced("apply_again", [
        (lambda: ex.update_filter("deconvolution", force=True)) for _ in range(2)
    ], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
