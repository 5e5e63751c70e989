"""Tilt compensation: per-pixel time shifts for misaligned samples.

Port of ``thz_image_explorer_tpu/ops/tilt.py`` (reference
``tilt_compensation.rs:97-226``): the time axis is extended symmetrically
by ``extension_steps`` samples of ``DT_PS`` on each side, and each pixel's
trace, windowed by the adapted Blackman over [0, 7] ps, is inserted at its
own offset; the head is filled with the pixel's raw first sample and the
tail with zeros.

The geometry is host data. The extension count, the per-pixel offsets and
the new time axis are computed in numpy f32, operation for operation as
the JAX kernel runs once XLA has compiled it: divisions by constants are
multiplications by their f32 reciprocals, constant factors are folded, and
the sum of the two offsets is one fused multiply-add of the second
product (``fma32``): the integer shifts equal JAX's bit for bit, where a
different order flips a pixel's step at a step boundary. The new time axis
follows the same rules and lands within one f32 step of JAX's (which
product of a linspace sample XLA fuses varies with the program), its ends
exactly. The host time axis is also the stage's
``host_time_out``, so the executor never copies the new axis back from the
device. The device work is one ``torch.gather`` of the windowed cube.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.ops.windows import adapted_blackman_window

C_MM_PER_PS = 0.299792458  # speed of light (tilt_compensation.rs:119)
DT_PS = 0.05  # hard-coded extension step (tilt_compensation.rs:122)

_F32 = np.float32
#: the folded constants of the compiled JAX kernel: ``/ 180 * pi``,
#: ``/ C_MM_PER_PS`` and ``/ DT_PS`` as f32 multiplications
_DEG = _F32(_F32(1.0 / 180.0) * _F32(np.pi))
_INV_C = _F32(1.0 / C_MM_PER_PS)
_INV_DT = _F32(1.0 / DT_PS)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` in f32 with one rounding (a fused multiply-add). The
    product of two f32 values is exact in f64; the f64 sum's lost low part
    (TwoSum) settles a tie of the final f64 -> f32 rounding."""
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


def extension_steps(
    width: int, height: int, dx: float, dy: float, tilt_x_deg: float, tilt_y_deg: float
) -> int:
    """Host-side extension step count (``tilt_compensation.rs:104-143``),
    the JAX package's f32 arithmetic copied operation for operation."""
    tsx = np.float32(tilt_x_deg) / 180.0 * np.pi
    tsy = np.float32(tilt_y_deg) / 180.0 * np.pi
    center_x = np.float32(width) / 2.0 * np.float32(dx)
    center_y = np.float32(height) / 2.0 * np.float32(dy)
    max_off_x = np.float32(float(center_x) * abs(float(tsx)) / C_MM_PER_PS)
    max_off_y = np.float32(float(center_y) * abs(float(tsy)) / C_MM_PER_PS)
    extension = np.float32(
        np.floor((max_off_x + max_off_y) / np.float32(DT_PS)) * np.float32(DT_PS)
    )
    return int(np.round(extension / np.float32(DT_PS)))


def pixel_shifts(width: int, height: int, valid_wh, dx: float, dy: float,
                 tilt_x_deg: float, tilt_y_deg: float, num_steps: int,
                 origin: tuple[int, int] = (0, 0)) -> np.ndarray:
    """(W, H) int64 insert offset of each pixel's trace in the extended
    axis (``tilt_compensation.rs:156-175``): ``max(num_steps + floor((x_off
    + y_off) / DT_PS), 0)``, offsets from the tilt centre at half the valid
    width and height. ``origin`` is the grid position of pixel (0, 0) (a
    block of a sharded cube): each pixel's value depends on its own grid
    position only, so a block's shifts equal the whole grid's over it."""
    tsx = _F32(tilt_x_deg) * _DEG
    tsy = _F32(tilt_y_deg) * _DEG
    i = np.arange(origin[0], origin[0] + width, dtype=_F32)[:, None]
    j = np.arange(origin[1], origin[1] + height, dtype=_F32)[None, :]
    x_pre = ((i - _F32(valid_wh[0]) * _F32(0.5)) * _F32(dx)) * tsx
    y_pre = ((j - _F32(valid_wh[1]) * _F32(0.5)) * _F32(dy)) * tsy
    x_off = np.broadcast_to(x_pre * _INV_C, (width, height))
    total = fma32(np.broadcast_to(y_pre, (width, height)), _INV_C, x_off)
    delta = np.floor(total * _INV_DT).astype(np.int64)
    return np.maximum(num_steps + delta, 0)


def _linspace(start, stop, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` on f32 scalars as XLA computes it:
    ``fma(i, stop / div, start * (1 - i / div))`` with ``/ div`` a multiply
    by the f32 reciprocal, and the last sample ``stop`` itself."""
    start, stop = _F32(start), _F32(stop)
    if num == 1:
        return np.asarray([start], _F32)
    div = num - 1
    r = _F32(1.0 / div)
    i = np.arange(div, dtype=_F32)
    head = fma32(i, stop * r, start * (_F32(1.0) - i * r))
    return np.concatenate([head, [stop]]).astype(_F32)


def extended_time(time: np.ndarray, num_steps: int) -> np.ndarray:
    """The (T + 2 num_steps,) f32 time axis after the extension: ``num_steps``
    samples ending one step before ``time[0]`` and as many starting one step
    after ``time[-1]``."""
    time = np.asarray(time, _F32)
    if num_steps <= 0:
        return time
    ext = _F32(num_steps * DT_PS)
    first, last = time[0], time[-1]
    front = _linspace(first + (-ext), first + _F32(-DT_PS), num_steps)
    back = _linspace(last + _F32(DT_PS), last + ext, num_steps)
    return np.concatenate([front, time, back]).astype(_F32)


def geometry(cube: ScanCube, tilt_x_deg: float, tilt_y_deg: float,
             valid_wh=None) -> Optional[int]:
    """The extension step count for ``cube``, or None when dx/dy are unknown
    (the reference's no-op, ``tilt_compensation.rs:111``). The tilt centre
    and the extension come from the valid region ``valid_wh`` (the cube's
    whole grid when None): the same count on every rank of a mesh."""
    if cube.dx is None or cube.dy is None:
        return None
    vw, vh = valid_wh if valid_wh is not None else cube.grid_wh
    return extension_steps(vw, vh, cube.dx, cube.dy, tilt_x_deg, tilt_y_deg)


def tilt_compensate(cube: ScanCube, tilt_x_deg: float, tilt_y_deg: float,
                    valid_wh=None, host_time: Optional[np.ndarray] = None) -> ScanCube:
    """Apply tilt compensation; returns ``cube`` itself when dx/dy are
    unknown. ``host_time`` is the host copy of ``cube.time`` (read from the
    device when None). A block of a sharded cube is shifted at its
    ``origin`` in the grid, around the centre of the global valid region."""
    num_steps = geometry(cube, tilt_x_deg, tilt_y_deg, valid_wh)
    if num_steps is None:
        return cube
    if host_time is None:
        host_time = cube.time.cpu().numpy()
    vwh = valid_wh if valid_wh is not None else cube.grid_wh
    dev = cube.device
    n_time = cube.n_time
    new_time = extended_time(host_time, num_steps)
    insert = torch.as_tensor(
        pixel_shifts(cube.width, cube.height, vwh, cube.dx, cube.dy,
                     tilt_x_deg, tilt_y_deg, num_steps, cube.origin),
        device=dev,
    )
    win = adapted_blackman_window(cube.time, 0.0, 7.0)
    k = torch.arange(new_time.shape[0], device=dev)
    idx = k[None, None, :] - insert[:, :, None]
    head, inside = idx < 0, idx < n_time
    gathered = torch.gather(cube.data * win, 2, idx.clamp_(0, n_time - 1))
    data = torch.where(head, cube.data[:, :, :1],
                       torch.where(inside, gathered, gathered.new_zeros(())))
    return cube.replace(data=data, time=torch.as_tensor(new_time, device=dev))
