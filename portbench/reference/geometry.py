"""Host geometry of the reference: ROI masks and the tilt's shifts.

Both are integer decisions that must be the program's exactly, or a pixel
lands in another ROI or another time step and the comparison reads a fault
where there is none. So they are frozen copies of the rules, not of the
program's code paths:

* the ROI mask is the reference application's ray cast with wrapping u64
  arithmetic, the x/y swap and the vertical flip (``math_tools.rs:574-661``),
  here in numpy ``uint64`` over the whole bounding box at once;
* the tilt's extension count, per-pixel shifts and extended time axis are
  the f32 host arithmetic of ``ops/tilt.py`` (the compiled JAX kernel's
  operation order, ``tilt_compensation.rs:97-226``), copied.
"""

from __future__ import annotations

import numpy as np


def polygon_mask(polygon, shape) -> np.ndarray:
    """(X, Y) bool mask of ``polygon`` (pixel vertices) on a grid of
    ``shape``: ``mask[shape[0] - 1 - y, x]`` for each in-polygon (x, y)."""
    y_size, x_size = int(shape[0]), int(shape[1])
    mask = np.zeros((y_size, x_size), bool)
    if not polygon:
        return mask
    u64 = np.uint64
    px = [u64(int(x) % (1 << 64)) for x, _ in polygon]
    py = [u64(int(y) % (1 << 64)) for _, y in polygon]
    x_lo, x_hi = min(int(min(px)), x_size - 1), min(int(max(px)), x_size - 1)
    y_lo, y_hi = min(int(min(py)), y_size - 1), min(int(max(py)), y_size - 1)
    if x_hi < x_lo or y_hi < y_lo:
        return mask
    ys, xs = np.meshgrid(np.arange(y_lo, y_hi + 1, dtype=u64),
                         np.arange(x_lo, x_hi + 1, dtype=u64), indexing="ij")
    inside = np.zeros(xs.shape, bool)
    j = len(polygon) - 1
    with np.errstate(over="ignore"):
        for i in range(len(polygon)):
            xi, yi, xj, yj = px[i], py[i], px[j], py[j]
            crosses = (yi > ys) != (yj > ys)
            if crosses.any():
                den = u64(yj - yi)
                t = (u64(xj - xi) * (ys - yi)) if den else np.zeros_like(ys)
                bound = (t // den + xi) if den else np.zeros_like(ys)
                inside ^= crosses & (xs < bound)
            j = i
    rows = (y_size - 1 - ys[inside].astype(np.int64))
    mask[rows, xs[inside].astype(np.int64)] = True
    return mask


# ------------------------------------------------------------------ tilt
C_MM_PER_PS = 0.299792458
DT_PS = 0.05
_F32 = np.float32
_DEG = _F32(_F32(1.0 / 180.0) * _F32(np.pi))
_INV_C = _F32(1.0 / C_MM_PER_PS)
_INV_DT = _F32(1.0 / DT_PS)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` in f32 with one rounding."""
    a = np.asarray(a, _F32).astype(np.float64)
    b = np.asarray(b, _F32).astype(np.float64)
    c = np.asarray(c, _F32).astype(np.float64)
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    r = s.astype(_F32)
    lo = np.where(r.astype(np.float64) > s, np.nextafter(r, _F32(-np.inf)), r)
    hi = np.nextafter(lo, _F32(np.inf))
    tie = (lo.astype(np.float64) + hi.astype(np.float64)) == 2.0 * s
    return np.where(tie & (err != 0), np.where(err > 0, hi, lo), r).astype(_F32)


def extension_steps(width, height, dx, dy, tilt_x_deg, tilt_y_deg) -> int:
    """Samples added on each side of the time axis."""
    tsx = np.float32(tilt_x_deg) / 180.0 * np.pi
    tsy = np.float32(tilt_y_deg) / 180.0 * np.pi
    center_x = np.float32(width) / 2.0 * np.float32(dx)
    center_y = np.float32(height) / 2.0 * np.float32(dy)
    max_off_x = np.float32(float(center_x) * abs(float(tsx)) / C_MM_PER_PS)
    max_off_y = np.float32(float(center_y) * abs(float(tsy)) / C_MM_PER_PS)
    extension = np.float32(
        np.floor((max_off_x + max_off_y) / np.float32(DT_PS)) * np.float32(DT_PS))
    return int(np.round(extension / np.float32(DT_PS)))


def pixel_shifts(width, height, dx, dy, tilt_x_deg, tilt_y_deg, num_steps) -> np.ndarray:
    """(X, Y) int64 insert offset of each pixel's trace in the extended axis."""
    tsx = _F32(tilt_x_deg) * _DEG
    tsy = _F32(tilt_y_deg) * _DEG
    i = np.arange(width, dtype=_F32)[:, None]
    j = np.arange(height, dtype=_F32)[None, :]
    x_pre = ((i - _F32(width) * _F32(0.5)) * _F32(dx)) * tsx
    y_pre = ((j - _F32(height) * _F32(0.5)) * _F32(dy)) * tsy
    x_off = np.broadcast_to(x_pre * _INV_C, (width, height))
    total = fma32(np.broadcast_to(y_pre, (width, height)), _INV_C, x_off)
    delta = np.floor(total * _INV_DT).astype(np.int64)
    return np.maximum(num_steps + delta, 0)


def _linspace(start, stop, num: int) -> np.ndarray:
    start, stop = _F32(start), _F32(stop)
    if num == 1:
        return np.asarray([start], _F32)
    div = num - 1
    r = _F32(1.0 / div)
    i = np.arange(div, dtype=_F32)
    head = fma32(i, stop * r, start * (_F32(1.0) - i * r))
    return np.concatenate([head, [stop]]).astype(_F32)


def extended_time(time: np.ndarray, num_steps: int) -> np.ndarray:
    """The (T + 2 num_steps,) f32 time axis after the extension."""
    time = np.asarray(time, _F32)
    if num_steps <= 0:
        return time
    ext = _F32(num_steps * DT_PS)
    first, last = time[0], time[-1]
    front = _linspace(first + (-ext), first + _F32(-DT_PS), num_steps)
    back = _linspace(last + _F32(DT_PS), last + ext, num_steps)
    return np.concatenate([front, time, back]).astype(_F32)
