"""FIR band filtering of knife-edge traces, for the PSF tool.

Port of ``thz_image_explorer_tpu/ops/firapply.py``: every trace correlated
with every band's taps, zero boundary, "same" length
(``psf_tool/fitting.rs:266-284``). The JAX package ran this as banded
matrix products on the TPU's matrix unit; here it is a product of spectra:
one ``torch.fft.rfft`` of the traces and one of the flipped taps at a
length of at least T + L - 1 (no wrap-around), their product, one
``irfft``. A direct correlation at the knife-edge fixture's size (300
positions x 1001 samples, 20 bands of 499 taps) would be ~3e9
multiply-adds a call; the transforms are ~1e8 operations. ``F.conv1d`` is
not used: it runs in TF32 on the card by default.

Precision: float64 throughout. The traces and taps arrive as float64 host
arrays (the knife-edge loader and the filter design are float64), and the
erf fits' band-to-band warm starts carry any difference in the intensities
forward; a float64 transform of (B + P) rows of a few thousand samples is
small work on the card. The filtered cube is kept as float32 on the device
(the JAX package's dtype; only plots and the left/right average read it);
the intensities are computed from the float64 values.
"""

from __future__ import annotations

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import resolve_device

#: output samples per window of the banded-matrix form
#: (:func:`fir_block_matrix`, :func:`window_input`)
FIR_BLOCK = 256


def fft_length(n: int) -> int:
    """The smallest 2^a 3^b 5^c >= n (lengths cuFFT and pocketfft run
    fastest)."""
    m = max(n, 1)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def _correlate(traces, taps, device) -> torch.Tensor:
    """(B, P, T) float64 'same' correlations on ``device``."""
    x = torch.as_tensor(np.asarray(traces, np.float64), device=device)
    h = torch.as_tensor(np.asarray(taps, np.float64), device=device)
    t, n_taps = x.shape[-1], h.shape[-1]
    # correlation with h == convolution with flip(h), read from index
    # L - 1 - L // 2 of the full convolution
    shift = n_taps - 1 - n_taps // 2
    n = fft_length(t + n_taps - 1)
    spec = torch.fft.rfft(x, n=n)[None] * torch.fft.rfft(torch.flip(h, (-1,)), n=n)[:, None]
    return torch.fft.irfft(spec, n=n)[..., shift: shift + t]


def fir_correlate_bands(traces: np.ndarray, taps: np.ndarray, device=None) -> np.ndarray:
    """Zero-boundary 'same' correlation of every trace with every band's
    taps: (P, T) x (B, L) -> (B, P, T) float64 numpy."""
    return _correlate(traces, taps, resolve_device(device)).cpu().numpy()


def fir_correlate_bands_device(traces: np.ndarray, taps: np.ndarray, device=None):
    """Like :func:`fir_correlate_bands`, but returns ``(filtered,
    intensities)``: the (B, P, T) float32 filtered traces as a tensor on
    ``device`` (no transfer), and the per-band knife-edge intensities
    (sum of squares over T, min-max normalized over the positions where the
    range exceeds 1e-10, ``fitting.rs:159-177``) as (B, P) float64 numpy,
    the only device-to-host copy."""
    filt = _correlate(traces, taps, resolve_device(device))
    inten = torch.sum(filt * filt, dim=-1)
    lo = torch.amin(inten, dim=1, keepdim=True)
    rng = torch.amax(inten, dim=1, keepdim=True) - lo
    norm = torch.where(rng > 1e-10, (inten - lo) / torch.where(rng == 0.0, 1.0, rng), inten)
    return filt.float(), norm.cpu().numpy()


def average_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a + b) / 2``: the left/right halves' filtered cubes averaged on
    their device."""
    return (a + b) * 0.5


def take_band(cube: torch.Tensor, i: int) -> torch.Tensor:
    """One band (P, T) of a (B, P, T) filtered cube, still on its device."""
    return cube[i]


def fir_block_matrix(taps: np.ndarray, block: int = FIR_BLOCK) -> np.ndarray:
    """The banded-matrix form of one band's correlation (the JAX package's
    matrix-unit route; the port correlates through spectra): ``G[m, t] =
    taps[t + ntaps - 1 - m]``, zeros outside, (block + ntaps - 1, block)
    float32. ``window_input(x, ntaps, shift) @ G`` gives ``block``
    outputs per window; the centring shift lives wholly in
    :func:`window_input`'s left pad, so pair the two with the same
    shift."""
    ntaps = len(taps)
    width = block + ntaps - 1
    m = np.arange(width)[:, None]
    t = np.arange(block)[None, :]
    idx = t + ntaps - 1 - m
    valid = (idx >= 0) & (idx < ntaps)
    return np.where(
        valid, np.asarray(taps, np.float32)[np.clip(idx, 0, ntaps - 1)], 0.0
    ).astype(np.float32)


def window_input(flat: torch.Tensor, ntaps: int, shift: int,
                 block: int = FIR_BLOCK) -> torch.Tensor:
    """Sliding input windows of a (N, T) batch of traces for
    :func:`fir_block_matrix`: ``xw[n, i, :] = padded[n, i * block: i *
    block + block + ntaps - 1]``, the traces zero-padded by ``ntaps - 1 -
    shift`` on the left and up to whole blocks on the right; (N,
    ceil(T / block), block + ntaps - 1)."""
    n_time = flat.shape[-1]
    width = block + ntaps - 1
    nb = -(-n_time // block)
    left = ntaps - 1 - shift
    xp = torch.nn.functional.pad(flat, (left, shift + nb * block - n_time))
    return torch.stack([xp[:, i * block: i * block + width] for i in range(nb)], dim=1)
