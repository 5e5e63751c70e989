"""Time- and frequency-domain band-passes and the water-vapor notch, as
weight vectors multiplied into the cube.

Port of ``thz_image_explorer_tpu/ops/bandpass.py``. The reference slices,
windows and zero-pads back (``band_pass_td_before_fft.rs:124-182``,
``band_pass_fd.rs:122-220``); a fixed-shape masked multiply is exactly
equivalent. The index selection stays on the device (no host sync per
slider step). Every ``*_weights`` vector is the stage's whole effect:
:func:`weigh_spectrum` applies an FD weight to a cube, and the publish
factors the FD weights out of its pixel sums
(``ops/specred.lean_spectral_outputs``).
"""

from __future__ import annotations

import torch

from thz_image_explorer_tpu_torch.ops.windows import _blackman_value, _scalar


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when none), like ``jnp.argmax`` on bools."""
    return torch.argmax(mask.to(torch.uint8))


def _adapted_blackman_slice_window(axis, t0, t_end, width) -> torch.Tensor:
    """Adapted-Blackman taper of a [t0, t_end] slice of ``axis`` with equal
    lower/upper bound ``width`` (how both band-passes smooth their edges)."""
    head = axis <= width + t0
    tail = axis >= t_end - width
    head_w = _blackman_value(axis - t0, 2.0 * width)
    tail_w = _blackman_value(axis - (t_end - 2.0 * width), 2.0 * width)
    return torch.where(head, head_w, torch.where(tail, tail_w, 1.0))


def td_bandpass_weights(time: torch.Tensor, low, high, window_width) -> torch.Tensor:
    """Weight vector of the time-domain band-pass
    (``band_pass_td_before_fft.rs:136-155``): ``lower`` = first index with
    ``t >= low`` (0 if none), ``upper`` = first index with ``t >= high``
    (len-1 if none), then ``upper = min(max(upper, lower+1), len)``; the
    cutoffs are first clamped to the time range."""
    n = time.shape[0]
    low = torch.clamp(_scalar(low, time), min=time[0])
    high = torch.minimum(_scalar(high, time), time[-1])
    width = _scalar(window_width, time)

    lower = _first_true(time >= low)
    ge_high = time >= high
    upper = torch.where(torch.any(ge_high), _first_true(ge_high), n - 1)
    upper = torch.clamp(torch.maximum(upper, lower + 1), max=n)

    k = torch.arange(n, device=time.device)
    inside = (k >= lower) & (k < upper)
    win = _adapted_blackman_slice_window(time, time[lower], time[upper - 1], width)
    return torch.where(inside, win, 0.0)


def td_bandpass(data, time, low, high, window_width) -> torch.Tensor:
    """The TD band-pass applied to the cube's time traces."""
    return data * td_bandpass_weights(time, low, high, window_width)


def fd_bandpass_weights(freq: torch.Tensor, low, high, window_width) -> torch.Tensor:
    """Weight vector of the frequency-domain band-pass
    (``band_pass_fd.rs:134-220``): ``lower`` = first index with
    ``f >= max(low, 0)``; ``upper`` = one past the last index with
    ``f <= min(high, f[-1])`` (len if none); the adapted-Blackman taper
    inside ``[lower, upper)`` and 0 outside."""
    n = freq.shape[0]
    safe_low = torch.clamp(_scalar(low, freq), min=0.0)
    safe_high = torch.minimum(_scalar(high, freq), freq[-1])
    width = _scalar(window_width, freq)

    lower = _first_true(freq >= safe_low)
    le_high = freq <= safe_high
    upper = torch.where(
        torch.any(le_high), n - _first_true(torch.flip(le_high, (0,))), n
    )

    k = torch.arange(n, device=freq.device)
    inside = (k >= lower) & (k < upper)
    f_end = freq[torch.clamp(upper - 1, min=0)]
    win = _adapted_blackman_slice_window(freq, freq[lower], f_end, width)
    return torch.where(inside, win, 0.0)


def weigh_spectrum(cube, w: torch.Tensor):
    """``cube`` with its complex spectrum and amplitudes times the
    per-frequency weight ``w``; the phases are left alone (the reference's
    FD filters leave them). The one way an FD stage's weight reaches a
    cube: the FD stages' ``apply`` and the executor both call it."""
    return cube.replace(fft=cube.fft * w, amplitudes=cube.amplitudes * w)


def fd_bandpass(fft, amplitudes, freq, low, high, window_width):
    """FD band-pass: complex spectrum and amplitudes are weighted; phases
    are untouched (the reference leaves them)."""
    w = fd_bandpass_weights(freq, low, high, window_width)
    return fft * w, amplitudes * w


def water_notch_weights(freq: torch.Tensor, lines: torch.Tensor, width, depth) -> torch.Tensor:
    """Comb of Blackman-shaped notches of half-width ``width`` (THz) and
    depth ``depth`` at the given line frequencies. ``depth`` is clamped to
    [0, 1], so the weights are an attenuation in [0, 1] and
    ``|spec * w| == |spec| * w`` holds."""
    f = freq[None, :]
    centers = lines[:, None]
    width = _scalar(width, freq)
    depth = torch.clamp(_scalar(depth, freq), 0.0, 1.0)
    in_notch = torch.abs(f - centers) <= width
    bump = _blackman_value(f - (centers - width), 2.0 * width)
    notch = torch.where(in_notch, 1.0 - depth * bump, 1.0)
    return torch.prod(notch, dim=0)


def water_notch(fft, amplitudes, freq, lines, width, depth):
    w = water_notch_weights(freq, lines, width, depth)
    return fft * w, amplitudes * w
