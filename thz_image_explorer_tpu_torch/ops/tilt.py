"""Tilt compensation: per-pixel time shifts for misaligned samples.

Port of ``thz_image_explorer_tpu/ops/tilt.py`` (reference
``tilt_compensation.rs:97-226``): the time axis is extended symmetrically
by ``extension_steps`` samples of ``DT_PS`` on each side, and each pixel's
trace, windowed by the adapted Blackman over [0, 7] ps, is inserted at its
own offset; the head is filled with the pixel's raw first sample and the
tail with zeros.

The extension count and the new time axis are host data, computed in numpy
f32; so are the per-pixel offsets of :func:`pixel_shifts` (the CPU route's
shifts and the card's oracle). All follow, operation for operation, the JAX
kernel as XLA compiles it: divisions by constants are
multiplications by their f32 reciprocals, constant factors are folded, and
the sum of the two offsets is one fused multiply-add of the second
product (``fma32``): the integer shifts equal JAX's bit for bit, where a
different order flips a pixel's step at a step boundary. The new time axis
follows the same rules and lands within one f32 step of JAX's (which
product of a linspace sample XLA fuses varies with the program), its ends
exactly. The host time axis is also the stage's
``host_time_out``, so the executor never copies the new axis back from the
device.

The insertion is :func:`tilt_insert`. On a CUDA tensor it launches
``csrc/tilt.cu`` (one launch a call, counted by ``tilt_insert.launches``),
which computes each pixel's shift on the card with the f32 operations of
:func:`pixel_shifts` in the same order, and the window with those of
``ops/windows.adapted_blackman_window``, each written as its rounding
intrinsic, and writes the extended cube in one pass: no W x H host array,
no index tensor, no launches for the window. On a CPU tensor it runs
:func:`tilt_insert_plain`, the window in PyTorch and the gather with the
host shifts; on any other device it raises. The two agree bit for bit on
the card: the same shifts, the same window, the same one-rounding
products.

Spans (``utils/spans.py``): ``tilt.geometry`` around the extension count
and the new axis (host work), ``tilt.insert`` around the insertion
(device-timed).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.ops.windows import adapted_blackman_window
from thz_image_explorer_tpu_torch.utils import spans

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


#: the adapted Blackman's taper of each trace before its insertion: the
#: first 0 and the last 7 ps of the input axis (``tilt_compensation.rs``)
WINDOW_PS = (0.0, 7.0)


def _check(data, time, num_steps, origin) -> None:
    if data.dtype != torch.float32 or data.ndim != 3 or data.shape[2] < 1:
        raise ValueError(f"data must be (W, H, T) float32 with T >= 1, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if time.dtype != torch.float32 or tuple(time.shape) != (data.shape[2],) \
            or not time.is_contiguous():
        raise ValueError(f"time must be a contiguous ({data.shape[2]},) float32 tensor, got "
                         f"{time.dtype} {tuple(time.shape)}")
    if time.device != data.device:
        raise ValueError(f"data on {data.device}, time on {time.device}")
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if origin[0] < 0 or origin[1] < 0:
        raise ValueError(f"origin must be >= 0, got {origin}")
    if data.shape[2] + 2 * num_steps >= 2**31 or max(origin) + max(data.shape[:2]) >= 2**24:
        raise ValueError("the extended trace or the grid position does not fit the kernel")


def tilt_insert_plain(data: torch.Tensor, time: torch.Tensor, num_steps: int, valid_wh,
                      dx: float, dy: float, tilt_x_deg: float, tilt_y_deg: float,
                      origin=(0, 0), shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The insertion in plain PyTorch (the CPU path, and the yardstick the
    kernel is checked against on the card): the window of ``time``, the
    host shifts of :func:`pixel_shifts`, an index per output sample, a
    gather of the windowed cube, and the head and tail selected around it."""
    _check(data, time, num_steps, origin)
    width, height, n_time = data.shape
    dev = data.device
    win = adapted_blackman_window(time, *WINDOW_PS)
    insert = torch.as_tensor(pixel_shifts(width, height, valid_wh, dx, dy, tilt_x_deg,
                                          tilt_y_deg, num_steps, tuple(origin)), device=dev)
    if shifts is not None:
        shifts.copy_(insert)
    k = torch.arange(n_time + 2 * num_steps, device=dev)
    idx = k[None, None, :] - insert[:, :, None]
    head, inside = idx < 0, idx < n_time
    gathered = torch.gather(data * win, 2, idx.clamp_(0, n_time - 1))
    return torch.where(head, data[:, :, :1],
                       torch.where(inside, gathered, gathered.new_zeros(())))


def tilt_insert(data: torch.Tensor, time: torch.Tensor, num_steps: int, valid_wh,
                dx: float, dy: float, tilt_x_deg: float, tilt_y_deg: float,
                origin=(0, 0), shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (W, H, T + 2 ``num_steps``) f32 extended cube of the contiguous
    (W, H, T) f32 ``data`` on its (T,) f32 axis ``time`` (module docstring):
    each pixel's trace times the adapted Blackman of ``time`` over
    :data:`WINDOW_PS`, inserted at its shift (:func:`pixel_shifts` of the
    block at ``origin`` in the grid, around the centre of ``valid_wh``), the
    head the raw first sample, the tail zeros. ``shifts``: an optional
    (W, H) int64 tensor on ``data``'s device that receives the shifts used.
    ``tilt_insert.launches`` counts kernel launches."""
    _check(data, time, num_steps, origin)
    if shifts is not None and (shifts.dtype != torch.int64 or shifts.device != data.device
                               or tuple(shifts.shape) != tuple(data.shape[:2])
                               or not shifts.is_contiguous()):
        raise ValueError(f"shifts must be a contiguous {tuple(data.shape[:2])} int64 tensor on "
                         f"{data.device}")
    if data.device.type == "cpu":
        return tilt_insert_plain(data, time, num_steps, valid_wh, dx, dy, tilt_x_deg,
                                 tilt_y_deg, origin, shifts)
    if data.device.type != "cuda":
        raise ValueError(f"no tilt kernel for device {data.device}")
    with torch.cuda.device(data.device):
        return _run_kernel(data, time, num_steps, valid_wh, dx, dy, tilt_x_deg, tilt_y_deg,
                           origin, shifts)


tilt_insert.launches = 0


#: csrc/tilt.cu's warps a block (a pixel each at a time) and resident blocks
#: an SM (its kWarps, kBlocksPerSm; the launch refuses more blocks than
#: pixels need)
WARPS, BLOCKS_PER_SM = 8, 8


def _run_kernel(data, time, num_steps, valid_wh, dx, dy, tilt_x_deg, tilt_y_deg, origin,
                shifts) -> torch.Tensor:
    width, height, n_time = data.shape
    out = torch.empty((width, height, n_time + 2 * num_steps), dtype=torch.float32,
                      device=data.device)
    n = width * height
    if n == 0:
        return out
    stream = torch.cuda.current_stream(data.device).cuda_stream
    # the persistent grid: a warp a pixel, up to the blocks the card holds at once
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    blocks = min(-(-n // WARPS), BLOCKS_PER_SM * sms)
    f32 = [float(_F32(v)) for v in (dx, dy, tilt_x_deg, tilt_y_deg, _DEG, _INV_C, _INV_DT,
                                    *WINDOW_PS)]
    err = kernels.load("tilt").thz_tilt_insert(
        data.data_ptr(), time.data_ptr(), out.data_ptr(),
        None if shifts is None else shifts.data_ptr(), n, height, n_time,
        n_time + 2 * num_steps, int(origin[0]), int(origin[1]), int(valid_wh[0]),
        int(valid_wh[1]), int(num_steps), *f32, blocks, stream)
    kernels.check_launch(err, "tilt")
    tilt_insert.launches += 1
    return out


def tilt_compensate(cube: ScanCube, tilt_x_deg: float, tilt_y_deg: float,
                    valid_wh=None, host_time: Optional[np.ndarray] = None) -> ScanCube:
    """Apply tilt compensation; returns ``cube`` itself when dx/dy are
    unknown. ``host_time`` is the host copy of ``cube.time`` (read from the
    device when None). A block of a sharded cube is shifted at its
    ``origin`` in the grid, around the centre of the global valid region."""
    with spans.span("tilt.geometry"):
        num_steps = geometry(cube, tilt_x_deg, tilt_y_deg, valid_wh)
        if num_steps is None:
            return cube
        if host_time is None:
            host_time = cube.time.cpu().numpy()
        new_time = extended_time(host_time, num_steps)
    dev = cube.device
    # the new axis goes to the card before the insertion is queued: a copy
    # from pageable memory waits for the stream
    time_out = torch.as_tensor(new_time, device=dev)
    with spans.span("tilt.insert", device=dev):
        data = tilt_insert(cube.data.contiguous(), cube.time.contiguous(), num_steps,
                           valid_wh if valid_wh is not None else cube.grid_wh,
                           cube.dx, cube.dy, tilt_x_deg, tilt_y_deg, cube.origin)
    return cube.replace(data=data, time=time_out)
