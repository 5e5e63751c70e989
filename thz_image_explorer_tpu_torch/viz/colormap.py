"""Intensity-image colormap.

The port's own copy of ``thz_image_explorer_tpu/viz/colormap.py`` (host
numpy, the same values bit for bit).

Equivalent of ``color_from_intensity``
(``gui/matrix_plot.rs:68-122``): normalize to percent,
remap through the clipping cutoffs, then either a midpoint-warped grayscale
or a blue→green→red HSV ramp with a draggable midpoint. Vectorized over the
whole image.
"""

from __future__ import annotations

import numpy as np


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    h6 = (h % 1.0) * 6.0
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def _linear_to_srgb(x: np.ndarray) -> np.ndarray:
    """egui's ``gamma_from_linear`` (ecolor): the Hsva values the
    reference builds are linear and its ``Color32`` bytes are sRGB."""
    x = np.clip(x, 0.0, 1.0)
    return np.where(
        x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1.0 / 2.4) - 0.055
    )


def color_from_intensity(
    intensity,
    max_intensity: float,
    cut_off: tuple[float, float] = (0.0, 100.0),
    midpoint: float = 50.0,
    bw: bool = False,
) -> np.ndarray:
    """Color(s) for intensity value(s); returns float rgb in [0, 1] with
    shape ``intensity.shape + (3,)``."""
    y = np.clip(np.asarray(intensity, np.float64) / max_intensity, 0.0, 1.0) * 100.0
    lo, hi = cut_off
    remapped = np.where(
        y <= lo, 0.0, np.where(y >= hi, 1.0, (y - lo) / (hi - lo))
    )
    mid = midpoint / 100.0
    if bw:
        gray = np.where(
            remapped <= mid,
            (remapped / mid) * 0.5,
            0.5 + (remapped - mid) / (1.0 - mid) * 0.5,
        )
        return np.stack([gray, gray, gray], axis=-1)
    hue = np.where(
        remapped <= mid,
        0.667 - (remapped / mid) * 0.334,
        0.333 - (remapped - mid) / (1.0 - mid) * 0.333,
    )
    return _hsv_to_rgb(hue, np.ones_like(hue), np.ones_like(hue))


def colorbar_rgba(
    height: int = 100, midpoint: float = 50.0, bw: bool = False
) -> np.ndarray:
    """Midpoint-stretched colorbar column as uint8 RGBA ``(height, 1, 4)``
    — the gradient the reference regenerates every frame
    (``matrix_plot.rs:149-179``). Row 0 is the TOP of the displayed bar
    (0 %, blue end); the hue runs ``0.667 - stretch * 0.667`` — the
    colorbar ramp, which is NOT the image ramp's 0.334/0.333 two-segment
    split (``matrix_plot.rs:105-112`` vs ``:172``) — and the grayscale
    value equals the stretch. Same linear→sRGB encode as the image."""
    yn = np.arange(height, dtype=np.float64) / height  # ref: y/100, 100 rows
    mid = midpoint / 100.0
    stretch = np.where(
        yn <= mid, (yn / mid) * 0.5, 0.5 + (yn - mid) / (1.0 - mid) * 0.5
    )
    if bw:
        rgb = np.stack([stretch, stretch, stretch], axis=-1)
    else:
        ones = np.ones_like(stretch)
        rgb = _hsv_to_rgb(0.667 - stretch * 0.667, ones, ones)
    srgb = _linear_to_srgb(rgb)
    rgba = np.concatenate(
        [srgb, np.ones(srgb.shape[:-1] + (1,), srgb.dtype)], axis=-1
    )
    return np.round(rgba * 255).astype(np.uint8)[:, None, :]


def intensity_image_rgba(
    img: np.ndarray,
    cut_off: tuple[float, float] = (0.0, 100.0),
    midpoint: float = 50.0,
    bw: bool = False,
) -> np.ndarray:
    """Render the intensity image to uint8 RGBA in the reference's display
    orientation: screen row = data x, screen column = data y.

    The GUI builds a swapped texture ``img[(col=y, row=x)]``
    (``matrix_plot.rs:405-426``) whose row 0 renders at the TOP of a
    ``PlotImage`` centered at (w/2, h/2) in egui plot coordinates (y up,
    ``matrix_plot.rs:443-448``); the texture-top-first and plot-y-up flips
    cancel, so the net on-screen layout is ``screen[(r, c)] = data[(r, c)]``
    — the raw array, no transpose or flip. The click mapping confirms it:
    ``pixel_y = floor(val.x)`` (column) and ``pixel_x = (h-1)-floor(val.y)``
    (row) at ``matrix_plot.rs:610-613``.

    The HSV values are LINEAR in egui (``ecolor::Hsva`` docs); the
    reference's ``Hsva -> Color32`` conversion gamma-encodes to sRGB
    bytes with rounding, so the same encode happens here — without it
    every midtone renders visibly darker than the reference (linear 0.5
    is sRGB ~188, not 127)."""
    rgb = color_from_intensity(img, float(img.max()) or 1.0, cut_off, midpoint, bw)
    srgb = _linear_to_srgb(rgb)
    rgba = np.concatenate(
        [srgb, np.ones(srgb.shape[:-1] + (1,), srgb.dtype)], axis=-1
    )
    return np.round(rgba * 255).astype(np.uint8)
