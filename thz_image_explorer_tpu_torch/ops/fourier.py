"""Batched forward / inverse FFT over the scan cube, and the phase unwrap.

Port of ``thz_image_explorer_tpu/ops/fourier.py`` (reference
``math_tools.rs:330-571``) on ``torch.fft.rfft``/``irfft`` in f32. The
JAX package's DFT matmuls and blocked-matmul cumsum were TPU workarounds;
here :func:`unwrap` is ``torch.cumsum`` over the wrapped increments, and the
FFT stage's amplitudes and unwrapped phases are one kernel on the card
(``ops/polar.py``, ``csrc/polar.cu``).

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
from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube, masked_pixel_mean
from thz_image_explorer_tpu_torch.ops.polar import amplitude_phase
from thz_image_explorer_tpu_torch.ops.windows import WindowType, window_array
from thz_image_explorer_tpu_torch.parallel.mesh import Mesh, all_sum

#: pi and 2 pi as the f32 values the reference's f32 comparisons use
#: (``jnp.pi`` against an f32 array compares with 3.14159274f)
PI_F32 = float(np.float32(math.pi))
TWO_PI_F32 = float(np.float32(2.0 * math.pi))
#: cuFFT chooses its algorithm by the batch as well as the length, and two
#: algorithms give a row different last bits (NVIDIA H100, CUDA 12.8, length
#: 1024: batches of up to 1 152 rows against batches of 2 178 rows and more;
#: length 128: up to 2 178 against 4 356 and more). A rank's block of a
#: sharded cube is padded with zero rows to the whole grid's row count or to
#: this many, whichever is fewer, so that it takes the whole cube's algorithm
#: and gets its bits, at every trace length. A whole cube is never padded.
#: An odd trace length has a second rule (:func:`pairs_rows`).
MIN_FFT_ROWS = 8192


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


def pairs_rows(n: int) -> bool:
    """Whether :func:`batch_fft` follows each row of length ``n`` with a
    zero row: at an odd length, and at no even one. cuFFT transforms the
    rows of an odd length two at a time (rows 2k and 2k + 1 of the batch as
    one complex transform, an odd batch's last row alone), so a row's bits
    depend on the row it is paired with, and a block's rows have other
    neighbours than the whole cube's. At an even length a row's bits depend
    on neither its neighbours nor its alignment: neither at a multiple of 4
    (64, 128, 1024, 1488) nor at 2 mod 4 (1606: rows at two alignments),
    for batches of 1 to 40 000 rows at offsets 0-3 and 7
    (``scripts/torch_fft_batch_probe.py``, the variants ``rfft``, ``irfft``
    and ``*_interleaved``; NVIDIA H100, CUDA 12.8)."""
    return n % 2 == 1


def batch_fft(fn, x: torch.Tensor, cube: ScanCube, **kw) -> torch.Tensor:
    """``fn(x, dim=-1, **kw)`` (``torch.fft.rfft`` or ``irfft``) over the
    rows of ``x`` (X, Y, n), the pixels of ``cube``, with each row's bits
    independent of the rows around it. Two rules, each for the lengths it
    names:

    * at every length, on a CUDA tensor of a block of a sharded cube
      (``cube.grid`` set), the batch is padded with zero rows to ``min(X' *
      Y', MIN_FFT_ROWS)`` for the whole grid's ``(X', Y')``: at most the
      whole cube's own batch (cuFFT chooses its algorithm by the batch);
    * at an odd length (:func:`pairs_rows`) every row is followed by a zero
      row in the batch, on every cube and device: paired with zeros, each
      row is transformed alike wherever it lies, at the cost of a batch
      twice as long.

    An even length, 0 or 2 mod 4, takes the plain batch on a single
    device: its FFTs are as they were. (The intensity image of rows of 2
    mod 4 does depend on their alignment: :func:`ops.intensity.
    intensity_image`.)"""
    rows = x.shape[0] * x.shape[1]
    n = kw.get("n", x.shape[-1])
    want = rows
    if x.device.type == "cuda" and cube.grid is not None:
        want = max(rows, min(cube.grid[0] * cube.grid[1], MIN_FFT_ROWS))
    if rows == 0 or (want == rows and not pairs_rows(n)):
        return fn(x, dim=-1, **kw)
    flat = x.reshape(rows, x.shape[-1])
    if not pairs_rows(n):
        padded = torch.cat([flat, flat.new_zeros((want - rows, x.shape[-1]))])
        out = fn(padded, dim=-1, **kw)[:rows]
    else:
        pairs = flat.new_zeros((want, 2, x.shape[-1]))
        pairs[:rows, 0] = flat
        out = fn(pairs.reshape(2 * want, x.shape[-1]), dim=-1, **kw)
        out = out.reshape(want, 2, out.shape[-1])[:rows, 0].contiguous()
    return out.reshape(*x.shape[:-1], out.shape[-1])


def forward_fft(cube: ScanCube, window_type: WindowType, window_low,
                window_high) -> ScanCube:
    """Window + batched real FFT + amplitude / unwrapped phase over all
    pixels (``fft()``, ``math_tools.rs:330-398``). ``window_low``/``_high``
    (ps) only shape the adapted Blackman window. The amplitudes and phases
    come from ``ops/polar.amplitude_phase``: on the card one launch of
    ``csrc/polar.cu``, on the CPU the absolute value, the angle and
    :func:`unwrap`."""
    w = window_array(cube.time, window_type, window_low, window_high)
    data = cube.data * w
    spec = batch_fft(torch.fft.rfft, data, cube)
    amplitudes, phases = amplitude_phase(spec)
    return cube.replace(data=data, fft=spec, amplitudes=amplitudes, phases=phases)


def inverse_fft(cube: ScanCube, avg_in_fourier_space: bool = False,
                mesh: Optional[Mesh] = None) -> ScanCube:
    """Batched inverse FFT plus pixel-mean spectra (``ifft()``,
    ``math_tools.rs:418-571``, minus the ROI handling, which the publish
    does):

    * mean complex spectrum / amplitude / phase over the valid pixels
      (``math_tools.rs:421-440``);
    * optionally the average trace rebuilt from the polar means
      (``math_tools.rs:442-470``);
    * per-pixel c2r with 1/N normalization (``math_tools.rs:545-569``).

    With a ``mesh`` (``parallel.mesh``), ``cube`` is this rank's block: its
    pixel sums over the global valid count are joined over the ranks in
    one ``all_sum`` before the polar means are used, so every rank holds
    the whole grid's means (a mesh of one rank gives the same values).
    """
    n_time = cube.time.shape[0]
    avg_fft = masked_pixel_mean(cube.fft, cube.valid_wh)
    avg_signal_fft = masked_pixel_mean(cube.amplitudes, cube.valid_wh)
    avg_phase_fft = masked_pixel_mean(cube.phases, cube.valid_wh)
    if mesh is not None:
        nf = avg_signal_fft.shape[0]
        means = all_sum(torch.cat([torch.view_as_real(avg_fft).reshape(-1), avg_signal_fft,
                                   avg_phase_fft]), mesh)
        avg_fft = torch.view_as_complex(means[: 2 * nf].reshape(nf, 2))
        avg_signal_fft, avg_phase_fft = means[2 * nf: 3 * nf], means[3 * nf:]
    avg_data = cube.avg_data
    if avg_in_fourier_space:
        avg_data = polar_irfft(avg_signal_fft, avg_phase_fft, n_time)
    return cube.replace(
        data=batch_fft(torch.fft.irfft, cube.fft, cube, n=n_time),
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
