"""General 2-D Richardson-Lucy on one image: the wrapper of
``csrc/rl2d_cluster.cu`` and ``csrc/rl2d.cu``.

Port of ``thz_image_explorer_tpu/ops/pallas_rl.py:richardson_lucy_pallas``
(the kernel of ``_make_kernel``), for a PSF that is not separable. Starting
from ``u = padded``, ``n_iter`` times::

    u <- u * corr(padded / (corr(u, psf) + 1e-12), psf mirrored)

with the zero-boundary correlation ``corr(x, K)[i, j] = sum_{a, b} K[a, b]
x[i + a - kr // 2, j + b - kc // 2]`` (no kernel flip). The padding is the
Pallas kernel's, ``kr // 2`` and ``kc // 2`` on both sides with the window
starting at offset ``a``: for odd ``kr`` and ``kc`` it equals XLA's
``"SAME"`` correlation (``deconvolution.py:_correlate_same``), for an even
one it sits one sample further down. No production path calls it.

On a CPU tensor :func:`richardson_lucy_direct` runs
:func:`richardson_lucy_direct_plain`, the same function in plain PyTorch. On
a CUDA tensor it launches one of two kernels, chosen from the shapes alone
before any launch (:func:`route_for`):

- the cluster route, ``csrc/rl2d_cluster.cu``: the image's estimate is held
  in the shared memory of one thread-block cluster of up to 16 CTAs
  (:func:`cluster_layout` mirrors its layout) and one launch runs a
  checkpoint group of ``rlsep.GROUP`` iterations, counted by
  ``richardson_lucy_direct.launches``;
- the tiled route, ``csrc/rl2d.cu``, for tap banks above
  :data:`CLUSTER_MAX_TAPS` (where the whole card's SMs beat one cluster's)
  or images no cluster holds: two launches per iteration, counted by
  ``richardson_lucy_direct.launches_tiled``.

A refused launch raises; nothing falls back to the other route or to the
plain version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops import rlsep

_EPS = 1e-12
#: the most taps (kr * kc) the cluster route takes: above it the tiled
#: kernel's 132 SMs beat the cluster's 16 (square PSFs on a 246 x 256
#: image: the cluster 2.1x faster at 15 x 15, 1.2x slower at 17 x 17;
#: scripts/torch_rl2d_grouped_sweep.py, PERF.md section 6)
CLUSTER_MAX_TAPS = 256
#: the largest thread-block cluster: the cluster route's size, or the
#: image's rows where it has fewer
MAX_CLUSTER = 16
# csrc/rl2d_cluster.cu's output rows a thread (kR) and the widest shifted
# tap bank its 9 x 9 tiles take (kSmallCols)
_ROWS = 4
_SMALL_COLS = 9


def _check(padded: torch.Tensor, psf: torch.Tensor, n_iter) -> int:
    if padded.dtype != torch.float32 or padded.ndim != 2:
        raise ValueError(f"padded must be (h2, w2) float32, got {padded.dtype} "
                         f"{tuple(padded.shape)}")
    if psf.dtype != torch.float32 or psf.ndim != 2 or psf.numel() == 0:
        raise ValueError(f"psf must be (kr, kc) float32, got {psf.dtype} {tuple(psf.shape)}")
    if psf.device != padded.device:
        raise ValueError(f"psf on {psf.device}, padded on {padded.device}")
    if not (padded.is_contiguous() and psf.is_contiguous()):
        raise ValueError("padded and psf must be contiguous")
    if int(n_iter) != n_iter or n_iter < 0:
        raise ValueError(f"n_iter must be an int >= 0, got {n_iter!r}")
    return int(n_iter)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cluster_layout(h2: int, w2: int, kr: int, kc: int, s: int) -> dict:
    """One CTA's share of the cluster route (``layout`` in
    ``csrc/rl2d_cluster.cu``): the tap tile (9 x 9 where the bank, shifted
    right so that the left column halo ``lh`` is a multiple of 4, is at
    most 9 columns wide; else 8 x 8) and the tiles of the bank, the slab's
    rows and row stride ``ws``, the halo window's rows ``nwin``, and the
    shared-memory bytes (``thz_rl2d_cluster_smem`` of the built library
    returns the same)."""
    if min(h2, w2, kr, kc, s) < 1:
        raise ValueError(f"no cluster layout for {h2}x{w2}, {kr}x{kc} taps, s = {s}")
    lh = _round_up(kc // 2, 4)
    kcs = kc + lh - kc // 2
    t = 9 if kcs <= _SMALL_COLS else 8
    ntr, ntc = -(-kr // t), -(-kcs // t)
    rows = -(-h2 // s)
    nwin = _round_up(rows, _ROWS) + ntr * t - 1
    w4 = _round_up(w2, 4)
    ws = _round_up(max(w4 - 4 + (ntc - 1) * t + _round_up(t + 3, 4), lh + w4), 4)
    bank = ntr * ntc * t * _round_up(t, 4)
    floats = 2 * bank + 3 * rows * ws + ws
    return dict(tile=t, ntr=ntr, ntc=ntc, lh=lh, rows=rows, ws=ws, nwin=nwin, bank=bank,
                bytes=2 * nwin * 8 + 4 * floats)


def cluster_fits(h2: int, w2: int, kr: int, kc: int, s: int) -> bool:
    return 1 <= s <= min(h2, MAX_CLUSTER) and \
        cluster_layout(h2, w2, kr, kc, s)["bytes"] <= rlsep.SMEM_PER_BLOCK


def route_for(h2: int, w2: int, kr: int, kc: int) -> tuple[str, Optional[int]]:
    """The routing rule, from the shapes alone: ``("cluster", s)`` with ``s
    = min(MAX_CLUSTER, h2)`` where the bank has at most
    :data:`CLUSTER_MAX_TAPS` taps and the image fits such a cluster (a
    larger cluster never needs more shared memory a CTA), else ``("tiled",
    None)``."""
    if min(h2, w2, kr, kc) < 1:
        raise ValueError(f"no route for a {h2}x{w2} image and {kr}x{kc} taps")
    s = min(MAX_CLUSTER, h2)
    if kr * kc <= CLUSTER_MAX_TAPS and cluster_fits(h2, w2, kr, kc, s):
        return "cluster", s
    return "tiled", None


def _correlate(img: torch.Tensor, taps: list[list[float]]) -> torch.Tensor:
    """Zero-boundary correlation as a shifted-slice multiply-add sum, taps in
    (a, b) order, as the Pallas kernel unrolls it."""
    h2, w2 = img.shape
    kr, kc = len(taps), len(taps[0])
    p = F.pad(img, (kc // 2, kc // 2, kr // 2, kr // 2))
    acc = torch.zeros_like(img)
    for a in range(kr):
        for b in range(kc):
            acc = acc + taps[a][b] * p[a: a + h2, b: b + w2]
    return acc


def richardson_lucy_direct_plain(padded: torch.Tensor, psf: torch.Tensor,
                                 n_iter: int) -> torch.Tensor:
    """The recurrence in plain PyTorch (the CPU path, and the yardstick the
    kernels are checked against on the card), f32. No ``F.conv2d``: on the
    card cuDNN would take it in TF32."""
    n_iter = _check(padded, psf, n_iter)
    taps = psf.tolist()
    mirror = psf.flip((0, 1)).tolist()
    u = padded.clone()
    for _ in range(n_iter):
        rel = padded / (_correlate(u, taps) + _EPS)
        u = u * _correlate(rel, mirror)
    return u


def richardson_lucy_direct(padded: torch.Tensor, psf: torch.Tensor,
                           n_iter: int) -> torch.Tensor:
    """``n_iter`` Richardson-Lucy iterations of the (h2, w2) f32 image
    ``padded`` with the (kr, kc) f32 ``psf`` on the same device. Returns
    ``u`` (h2, w2). On a CUDA tensor the route follows from the shapes
    (:func:`route_for`): the cluster kernel, one launch per checkpoint group
    of ``rlsep.GROUP`` iterations, counted by
    ``richardson_lucy_direct.launches``; or the tiled kernel, two launches
    per iteration, counted by ``richardson_lucy_direct.launches_tiled``."""
    n_iter = _check(padded, psf, n_iter)
    if padded.device.type == "cpu":
        return richardson_lucy_direct_plain(padded, psf, n_iter)
    if padded.device.type != "cuda":
        raise ValueError(f"no Richardson-Lucy kernel for device {padded.device}")
    route, s = route_for(*padded.shape, *psf.shape)
    with torch.cuda.device(padded.device):
        if route == "cluster":
            return _run_cluster(padded, psf, n_iter, s)
        return _run_tiled(padded, psf, n_iter)


richardson_lucy_direct.launches = 0
richardson_lucy_direct.launches_tiled = 0


def _run_cluster(padded, psf, n_iter: int, s: int) -> torch.Tensor:
    lib = kernels.load("rl2d_cluster")
    h2, w2 = padded.shape
    kr, kc = psf.shape
    u = padded.clone()
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    for i0, i1, _ in rlsep.launch_schedule(np.array([n_iter])):
        err = lib.thz_rl2d_cluster(u.data_ptr(), padded.data_ptr(), psf.data_ptr(), i1 - i0,
                                   h2, w2, kr, kc, s, stream)
        kernels.check_launch(err, "rl2d_cluster")
        richardson_lucy_direct.launches += 1
    return u


def _run_tiled(padded, psf, n_iter: int) -> torch.Tensor:
    h2, w2 = padded.shape
    kr, kc = psf.shape
    u = padded.clone()
    if n_iter == 0:
        return u
    rel = torch.empty_like(padded)
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    err = kernels.load("rl2d").thz_rl2d(u.data_ptr(), rel.data_ptr(), padded.data_ptr(),
                                        psf.data_ptr(), n_iter, h2, w2, kr, kc, stream)
    kernels.check_launch(err, "rl2d")
    richardson_lucy_direct.launches_tiled += 2 * n_iter
    return u
