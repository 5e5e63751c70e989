#!/usr/bin/env python3
"""Host ms of the single-device commands at several downscale factors.

    python3 scripts/torch_time_single_device.py [--seed 0] [--size 200] [--scales 1 3 10]
        [--tilt X Y] [--apply]

Opens the synthetic size x size x 1024 scan of ``chip_smoke.py`` through
``Explorer(device="cuda")`` with the main path's filters (TD band-pass
before the FFT, FD band-pass, water notch), its 4 polygon ROIs, ROI 0 as
the reference and the selected pixel as the sample; with ``--tilt X Y``
tilt compensation at (X°, Y°) on top (``--tilt 3 2``: T = 1606 at scale 1,
1600 at scale 3). For each factor it times the downscale command
(``set_downscaling``), then 5 slider steps (``set_fft_window_low``) and 10
clicks (``set_selected_pixel``), each command with its publish and a
synchronize on each side. Prints one JSON line per factor (the downscale's
ms; slider: median of steps 2-5; click: median of clicks 2-10) and the
card's name and power limit. With ``--apply``, then at scale 1: 5 live 3-D
views (``chip_smoke.live_view``) and, with ``chip_smoke.synthetic_psf``, a
first Apply and 5 repeat Applies (``update_filter("deconvolution",
force=True)``), one more JSON line with the view's and the repeats'
medians. It takes its package and ``chip_smoke.py`` from the checkout it
sits in, so a copy of it run from another checkout times that tree. Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import (live_view, roi_polygons, scan_metadata, synthetic_psf,  # noqa: E402
                        synthetic_scan)


def host_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=200)
    ap.add_argument("--scales", type=int, nargs="+", default=[1, 3, 10])
    ap.add_argument("--label", default="")
    ap.add_argument("--tilt", type=float, nargs=2, default=None, metavar=("X", "Y"))
    ap.add_argument("--apply", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("timing: CUDA is not available", file=sys.stderr)
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
    if args.tilt:
        ex.set_filter_param("tilt_compensation", "tilt_x", args.tilt[0])
        ex.set_filter_param("tilt_compensation", "tilt_y", args.tilt[1])
        ex.set_filter_active("tilt_compensation", True)
    rng = np.random.default_rng(args.seed)
    for scale in args.scales:
        # the first visit of a factor makes its cuFFT plans: a warm-up
        # visit, then the timed one
        ex.set_downscaling(scale)
        ex.set_downscaling(1 if scale != 1 else 2)
        downscale_ms = host_ms(lambda: ex.set_downscaling(scale))
        slider = [host_ms(lambda i=i: ex.set_fft_window_low(1.05 + 0.05 * i)) for i in range(5)]
        clicks = [host_ms(lambda: ex.set_selected_pixel(int(rng.integers(args.size)),
                                                        int(rng.integers(args.size))))
                  for _ in range(10)]
        grid = ex.pipeline.output.grid_wh
        print(json.dumps({
            "label": args.label, "card": card, "size": args.size, "scale": scale,
            "tilt": args.tilt, "n_time": ex.pipeline.output.n_time,
            "grid": list(grid), "fft_rows": grid[0] * grid[1],
            "downscale_ms": downscale_ms, "slider_ms": statistics.median(slider[1:]),
            "click_ms": statistics.median(clicks[1:]), "slider_all_ms": slider,
            "click_all_ms": clicks,
        }), flush=True)
    if args.apply:
        ex.set_downscaling(1)
        views = [live_view(ex)[0] for _ in range(5)]
        ex.apply_psf(synthetic_psf())
        ex.set_filter_active("deconvolution", True)
        first = host_ms(lambda: ex.update_filter("deconvolution", force=True))
        again = [host_ms(lambda: ex.update_filter("deconvolution", force=True))
                 for _ in range(5)]
        print(json.dumps({
            "label": args.label, "card": card, "size": args.size, "tilt": args.tilt,
            "live_view_ms": statistics.median(views), "live_view_all_ms": views,
            "apply_first_ms": first, "apply_again_ms": statistics.median(again),
            "apply_again_all_ms": again,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
