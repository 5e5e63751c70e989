"""Batched forward / inverse FFT over the scan cube, and the phase unwrap.

Port of ``thz_image_explorer_tpu/ops/fourier.py`` (reference
``math_tools.rs:330-571``) on ``torch.fft.rfft``/``irfft`` in f32. The
JAX package's DFT matmuls and blocked-matmul cumsum were TPU workarounds;
here the unwrap is ``torch.cumsum`` over the wrapped increments.

Semantics kept exactly:

* the window **mutates** the time-domain data before the FFT, so later
  stages see the windowed traces (``math_tools.rs:349-371``);
* the unnormalized r2c forward is ``rfft``; the c2r with 1/N is ``irfft``
  (``math_tools.rs:545-569``);
* phase unwrap uses period 2 pi with strict ``> pi`` comparisons against
  the f32 value of pi.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube, masked_pixel_mean
from thz_image_explorer_tpu_torch.ops.windows import WindowType, window_array

#: pi and 2 pi as the f32 values the reference's f32 comparisons use
#: (``jnp.pi`` against an f32 array compares with 3.14159274f)
PI_F32 = float(np.float32(math.pi))
TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def wrap_adjust(d: torch.Tensor) -> torch.Tensor:
    """The parity-critical 2 pi wrap rule on raw diffs: strict ``> pi`` /
    ``< -pi``, one correction (``math_tools.rs:226-238``); a jump of
    exactly pi is kept. ``csrc/specred.cu`` implements the same rule."""
    return (
        d
        - TWO_PI_F32 * (d > PI_F32).to(d.dtype)
        + TWO_PI_F32 * (d < -PI_F32).to(d.dtype)
    )


def phase_increments(phase: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``[phi_0, wrapped diffs]`` along ``dim``: an inclusive cumsum of it
    is :func:`unwrap`. Cumsum is linear, so a reduction of the increments
    followed by :func:`finish_unwrap` equals the reduction of the unwrap."""
    phase = torch.movedim(phase, dim, -1)
    d_adj = wrap_adjust(phase[..., 1:] - phase[..., :-1])
    out = torch.cat([phase[..., :1], d_adj], dim=-1)
    return torch.movedim(out, -1, dim)


def finish_unwrap(increments: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive cumsum turning (reduced) increments into unwrapped phases."""
    return torch.cumsum(increments, dim=dim)


def unwrap(phase: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """numpy-compatible 1-D phase unwrap with period 2 pi along ``dim``."""
    return finish_unwrap(phase_increments(phase, dim), dim)


def forward_fft(cube: ScanCube, window_type: WindowType, window_low,
                window_high) -> ScanCube:
    """Window + batched real FFT + amplitude / unwrapped phase over all
    pixels (``fft()``, ``math_tools.rs:330-398``). ``window_low``/``_high``
    (ps) only shape the adapted Blackman window."""
    w = window_array(cube.time, window_type, window_low, window_high)
    data = cube.data * w
    spec = torch.fft.rfft(data, dim=-1)
    return cube.replace(
        data=data,
        fft=spec,
        amplitudes=torch.abs(spec),
        phases=unwrap(torch.angle(spec)),
    )


def inverse_fft(cube: ScanCube, avg_in_fourier_space: bool = False) -> ScanCube:
    """Batched inverse FFT plus pixel-mean spectra (``ifft()``,
    ``math_tools.rs:418-571``, minus the ROI handling, which the publish
    does):

    * mean complex spectrum / amplitude / phase over the valid pixels
      (``math_tools.rs:421-440``);
    * optionally the average trace rebuilt from the polar means
      (``math_tools.rs:442-470``);
    * per-pixel c2r with 1/N normalization (``math_tools.rs:545-569``).
    """
    n_time = cube.time.shape[0]
    avg_fft = masked_pixel_mean(cube.fft, cube.valid_wh)
    avg_signal_fft = masked_pixel_mean(cube.amplitudes, cube.valid_wh)
    avg_phase_fft = masked_pixel_mean(cube.phases, cube.valid_wh)
    avg_data = cube.avg_data
    if avg_in_fourier_space:
        avg_data = polar_irfft(avg_signal_fft, avg_phase_fft, n_time)
    return cube.replace(
        data=torch.fft.irfft(cube.fft, n=n_time, dim=-1),
        avg_data=avg_data,
        avg_fft=avg_fft,
        avg_signal_fft=avg_signal_fft,
        avg_phase_fft=avg_phase_fft,
    )


def polar_irfft(amplitude: torch.Tensor, phase: torch.Tensor, n_time: int) -> torch.Tensor:
    """A real time trace from amplitude + phase spectra
    (``math_tools.rs:496-529``); ``irfft`` ignores the imaginary part of
    the DC bin, as the reference zeroes it."""
    spectrum = torch.polar(amplitude, phase)
    return torch.fft.irfft(spectrum, n=n_time, dim=-1)
