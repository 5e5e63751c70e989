"""The live 3-D view's voxels, written from their definition; imports no JAX.

Nothing here imports JAX, the JAX package or the program. The reference
application's ``instance_from_data`` (``threed_plot.rs:132-270``), as the
port's and the JAX package's docstrings describe it, per trace ``v`` of the
final cube:

square it, raise it to the contrast exponent, ``p = (v^2)^contrast``
(``0^0 = 1``); correlate ``p`` with the normalised Gaussian taps of ``sigma``
and ``radius`` with a zero boundary, ``env[t] = sum_k taps[k] p[t + k - r]``
(``threed_plot.rs:82-102, 166-201``); zero the trace where ``max env`` is
under the opacity threshold or ``max env - min env`` is at most 1e-6, else
min-max normalise it; keep the ``max_points`` largest opacities (the page's
view; the application keeps every voxel above the threshold that caps the
view at 2 M, ``threed_plot.rs:207-214``); place voxel ``(x, y, z)`` at
``(y sy - hy, hx - x sx, hz - z sz)`` with the depth of a sample from the
round trip ``c t / 2`` (``threed_plot.rs:149-162``); colour it by the jet map
of ``(alpha - thr) / (1 - thr)`` (``threed_plot.rs:123-130``).

Departures from the application: everything is float64 (the application
computes in f32, its taps too); the correlation is a product with the (T, T)
band matrix of the taps (``Numerics.mm``, so that the control computes it in
TF32); the view keeps the ``max_points`` largest, as the page asks, not the
application's 2 M cap; the scan is never downscaled (scale 1).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.numerics import Numerics

C_M_PER_S = 300_000_000.0  # threed_plot.rs:153, the application's own c
BASE_CUBE_SIZE = 0.25  # threed_plot.rs:149


def gaussian_taps(sigma: float, radius: int) -> np.ndarray:
    """The (2 radius + 1,) Gaussian taps of ``sigma``, summing to 1."""
    x = np.arange(2 * radius + 1, dtype=np.float64) - radius
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return k / k.sum()


def band_matrix(taps: np.ndarray, n: int) -> np.ndarray:
    """(n, n) ``B`` with ``B[s, t] = taps[s - t + r]`` where ``|s - t| <= r``:
    ``p @ B`` is the zero-boundary correlation of each row of ``p``."""
    r = len(taps) // 2
    s = np.arange(n)[:, None] - np.arange(n)[None, :] + r
    inside = (s >= 0) & (s < len(taps))
    return np.where(inside, taps[np.clip(s, 0, len(taps) - 1)], 0.0)


def envelope(final: torch.Tensor, contrast: float, sigma: float, radius: int,
             num: Numerics) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(normalised (N, T), trace max (N,), trace range (N,))`` of the
    (X, Y, T) cube ``final``: every trace min-max normalised, before the
    threshold and the range test."""
    t = final.shape[-1]
    v = final.reshape(-1, t).to(num.dtype)
    p = torch.pow(v * v, float(contrast))
    env = num.mm(p, num.tensor(band_matrix(gaussian_taps(sigma, radius), t)))
    lmax = env.amax(dim=-1)
    lmin = env.amin(dim=-1)
    rng = lmax - lmin
    norm = (env - lmin[:, None]) / torch.where(rng > 0, rng, 1.0)[:, None]
    return norm, lmax, rng


def geometry(shape, time_span: float, original_dims, scaling: int = 1) -> dict:
    """The view's voxel dims, spacings and half extents for a cube of
    ``shape`` (X, Y, T): the spacing from the scan's original dims, the
    depth of the axis ``time_span`` ps from ``c t / 2``; ``extent`` the
    rendered voxel's dims, scaled."""
    gx, gy, gz = shape
    ox, oy, oz = original_dims
    depth = BASE_CUBE_SIZE / (time_span * C_M_PER_S / 1.0e9 * 2.0)
    return dict(spacing=(ox * BASE_CUBE_SIZE / gx, oy * BASE_CUBE_SIZE / gy, oz * depth / gz),
                half=(ox * BASE_CUBE_SIZE / 2.0, oy * BASE_CUBE_SIZE / 2.0, oz * depth / 2.0),
                extent=(BASE_CUBE_SIZE * scaling, BASE_CUBE_SIZE * scaling, depth * scaling))


def positions(idx: np.ndarray, shape, geo: dict) -> np.ndarray:
    """(N, 3) float64 positions of the flat voxel indices ``idx``."""
    gy, gz = shape[1], shape[2]
    xs, ys, zs = idx // (gy * gz), (idx // gz) % gy, idx % gz
    (sx, sy, sz), (hx, hy, hz) = geo["spacing"], geo["half"]
    return np.stack([ys * sy - hy, hx - xs * sx, hz - zs * sz], axis=-1)


def jet(u) -> np.ndarray:
    """(N,) values -> (N, 3) rgb in [0, 1]."""
    v4 = 4.0 * np.asarray(u, np.float64)
    r = np.clip(v4 - 1.5, 0.0, 1.0)
    g = np.clip(v4 - 0.5, 0.0, 1.0) - np.clip(v4 - 2.5, 0.0, 1.0)
    b = 1.0 - np.clip(v4 - 1.5, 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def colour(alpha, thr: float) -> np.ndarray:
    """The jet colour of opacities ``alpha`` in a view whose smallest kept
    opacity is ``thr``."""
    alpha = np.asarray(alpha, np.float64)
    return jet((alpha - thr) / (1.0 - thr)) if thr < 1.0 else jet(np.zeros_like(alpha))
