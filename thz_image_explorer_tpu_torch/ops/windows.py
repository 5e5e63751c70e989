"""FFT apodization windows as ``(T,)`` weight vectors.

Port of ``thz_image_explorer_tpu/ops/windows.py`` (reference
``math_tools.rs:35-198``): every window is one vector computed from the
time axis and broadcast-multiplied into the cube.
"""

from __future__ import annotations

import enum
import math

import torch


class WindowType(enum.Enum):
    """Window kinds supported by the reference (``math_tools.rs:35-46``)."""

    ADAPTED_BLACKMAN = "adapted_blackman"
    BLACKMAN = "blackman"
    HANNING = "hanning"
    HAMMING = "hamming"
    FLAT_TOP = "flat_top"


_TWO_PI = 2.0 * math.pi


def _blackman_value(n: torch.Tensor, m) -> torch.Tensor:
    """Blackman formula with the reference's NaN->1 and [0, 1] clamp
    (``math_tools.rs:81-90``). ``m == 0`` yields NaN -> 1.0, which is what
    makes bounds of ``[0, 0]`` disable the adapted window entirely."""
    res = (
        0.42
        - 0.5 * torch.cos(_TWO_PI * n / m)
        + 0.08 * torch.cos(2.0 * _TWO_PI * n / m)
    )
    return torch.where(torch.isnan(res), 1.0, torch.clamp(res, 0.0, 1.0))


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def adapted_blackman_window(time: torch.Tensor, lower, upper) -> torch.Tensor:
    """Adapted Blackman: tapers only the first ``lower`` / last ``upper``
    units of ``time``, leaving the centre at exactly 1
    (``math_tools.rs:102-122``); the head branch wins where both apply."""
    t0 = time[0]
    t_end = time[-1]
    lower = _scalar(lower, time)
    upper = _scalar(upper, time)
    head = time <= lower + t0
    tail = time >= t_end - upper
    head_w = _blackman_value(time - t0, 2.0 * lower)
    tail_w = _blackman_value(time - (t_end - 2.0 * upper), 2.0 * upper)
    return torch.where(head, head_w, torch.where(tail, tail_w, 1.0))


def _normalized_time(time: torch.Tensor) -> torch.Tensor:
    tmin = torch.min(time)
    tmax = torch.max(time)
    return (time - tmin) / (tmax - tmin)


def blackman_window(time: torch.Tensor) -> torch.Tensor:
    """Full Blackman over normalized time (``math_tools.rs:174-180``)."""
    t = _normalized_time(time)
    return 0.42 - 0.5 * torch.cos(_TWO_PI * t) + 0.08 * torch.cos(2 * _TWO_PI * t)


def hanning_window(time: torch.Tensor) -> torch.Tensor:
    """Hann window (``math_tools.rs:160-165``)."""
    t = _normalized_time(time)
    return 0.5 * (1.0 - torch.cos(_TWO_PI * t))


def hamming_window(time: torch.Tensor) -> torch.Tensor:
    """Hamming window (``math_tools.rs:145-150``)."""
    t = _normalized_time(time)
    return 0.54 - 0.46 * torch.cos(_TWO_PI * t)


def flat_top_window(time: torch.Tensor) -> torch.Tensor:
    """Flat-top window (``math_tools.rs:190-197``)."""
    t = _normalized_time(time)
    return (
        1.0
        - 1.93 * torch.cos(_TWO_PI * t)
        + 1.29 * torch.cos(2 * _TWO_PI * t)
        - 0.388 * torch.cos(3 * _TWO_PI * t)
        + 0.028 * torch.cos(4 * _TWO_PI * t)
    )


def window_array(time: torch.Tensor, window_type: WindowType,
                 lower=0.0, upper=0.0) -> torch.Tensor:
    """The ``(T,)`` window for a given type. ``lower``/``upper`` only apply
    to the adapted Blackman (bounds in the unit of ``time``)."""
    if window_type == WindowType.ADAPTED_BLACKMAN:
        return adapted_blackman_window(time, lower, upper)
    if window_type == WindowType.BLACKMAN:
        return blackman_window(time)
    if window_type == WindowType.HANNING:
        return hanning_window(time)
    if window_type == WindowType.HAMMING:
        return hamming_window(time)
    if window_type == WindowType.FLAT_TOP:
        return flat_top_window(time)
    raise ValueError(f"unknown window type: {window_type}")
