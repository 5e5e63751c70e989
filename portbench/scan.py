"""The benchmark's inputs, made from ``--seed`` and a configuration file.

The scan is the recipe of ``chip_smoke.synthetic_scan`` (a THz-TDS pulse a
pixel, amplitude and delay depending on the position, a weaker disc for the
sample, noise and a DC bias), written in torch so that it is made on the
device in a few large calls. The same seed and device give the same cube,
so the plain reference makes it again after the window.
"""

from __future__ import annotations

import numpy as np
import torch


def time_axis(cfg: dict) -> torch.Tensor:
    """The (T,) f32 time axis in ps."""
    s = cfg["scan"]
    return torch.arange(s["n_time"], dtype=torch.float32) * np.float32(s["dt_ps"])


def make_scan(cfg: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(time (T,) on the host, raw cube (X, Y, T) f32 on device)``: the
    pulse table (X, T) scaled per pixel, plus Gaussian noise drawn from a
    generator on ``device`` seeded with ``seed``, plus the DC bias."""
    s, p = cfg["scan"], cfg["pulse"]
    x_n, y_n = s["width"], s["height"]
    t = time_axis(cfg)
    td = t.to(device)
    xs = torch.arange(x_n, dtype=torch.float32, device=device)[:, None]
    ys = torch.arange(y_n, dtype=torch.float32, device=device)[None, :]
    r2 = (xs - x_n / 2) ** 2 + (ys - y_n / 2) ** 2
    amp = 0.6 + 0.4 * torch.exp(-r2 / (x_n * y_n / 8))
    disc = r2 < (x_n * p["disc_radius"]) ** 2
    amp = torch.where(disc, amp * p["disc_gain"], amp)
    # the delay depends on x only, so the pulse is an (X, T) table
    tt = td[None, :] - (p["t0_ps"] + p["delay_ps_per_px"] * xs)
    pulse = torch.exp(-(tt ** 2) / p["width_ps2"]) * torch.sin(
        2 * np.pi * p["carrier_thz"] * tt)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    cube = torch.randn((x_n, y_n, s["n_time"]), generator=gen, device=device,
                       dtype=torch.float32)
    cube.mul_(p["noise"]).add_(np.float32(p["bias"]))
    cube.addcmul_(amp[:, :, None], pulse[:, None, :])
    return t, cube


def selected_pixel(cfg: dict, seed: int) -> tuple[int, int]:
    """The pixel the session selects, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    s = cfg["scan"]
    return int(rng.integers(s["width"])), int(rng.integers(s["height"]))
