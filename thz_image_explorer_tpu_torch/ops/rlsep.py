"""Separable Richardson-Lucy over a stack of bands: the wrapper of
``csrc/rlsep.cu``.

Port of ``thz_image_explorer_tpu/ops/pallas_rl.py:rl_bands_separable``.
For every band ``b``, ``n_iter[b]`` times::

    u <- u * R_b^T (P_b / (R_b u C_b^T + 1e-12)) C_b

starting from ``u = P_b``, the band's reflect-padded (h2, w2) canvas. ``R_b``
and ``C_b`` are the banded correlation matrices of the band's row and
column profiles, ``R_b[i, k] = px[b, k - i + kr // 2]`` (zero outside the
profile), so ``R u C^T`` is a zero-boundary correlation with ``px`` along
axis 0 and ``py`` along axis 1. The JAX kernel takes the dense ``R``, ``C``
(a TPU matrix-unit workaround); the port takes the profiles themselves.
Profiles of bands that take FFT-convolution semantics arrive already
flipped (``ops/deconvolution.py``).

On a CUDA tensor :func:`rl_bands_separable` launches the CUDA kernel (two
launches per iteration, each over every band still iterating) or raises;
on a CPU tensor it runs :func:`rl_bands_separable_plain`, the same function
as dense banded matmuls in plain PyTorch (f32; TF32 is off).

:func:`rl_bands_separable_grouped` is the same function with ``group``
bands per kernel block (port of ``pallas_rl.py:rl_bands_separable_grouped``,
the JAX package's G-band interleave): on the card its output equals
:func:`rl_bands_separable`'s bit for bit. No production path calls it.

Both :func:`rl_bands_separable` and the plain version take
``between(done, total) -> bool``, called on the host before each
group of at most :data:`GROUP` iterations (``done`` groups of ``total`` run
so far); returning True stops the run and the function returns None. That
is where the deconvolution reports progress and checks cancellation.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch import kernels

_EPS = 1e-12
#: iterations between two host checkpoints
GROUP = 50

Between = Optional[Callable[[int, int], bool]]


def _check(padded: torch.Tensor, px: torch.Tensor, py: torch.Tensor, n_iter) -> np.ndarray:
    if padded.dtype != torch.float32 or padded.ndim != 3:
        raise ValueError(f"padded must be (B, h2, w2) float32, got {padded.dtype} "
                         f"{tuple(padded.shape)}")
    b = padded.shape[0]
    for name, prof in (("px", px), ("py", py)):
        if prof.dtype != torch.float32 or prof.ndim != 2 or prof.shape[0] != b:
            raise ValueError(f"{name} must be ({b}, k) float32, got {prof.dtype} "
                             f"{tuple(prof.shape)}")
        if prof.device != padded.device:
            raise ValueError(f"{name} on {prof.device}, padded on {padded.device}")
        if prof.shape[1] < 1:
            raise ValueError(f"{name} has no taps")
    if not (padded.is_contiguous() and px.is_contiguous() and py.is_contiguous()):
        raise ValueError("padded, px and py must be contiguous")
    n_iter = np.asarray(n_iter)
    if n_iter.shape != (b,) or not np.issubdtype(n_iter.dtype, np.integer):
        raise ValueError(f"n_iter must be a host int array of shape ({b},)")
    if (n_iter < 0).any():
        raise ValueError("n_iter must be >= 0")
    return n_iter.astype(np.int64)


def _groups(max_iter: int) -> list[tuple[int, int]]:
    """Iteration ranges of the host checkpoints, :data:`GROUP` iterations
    each: at least one (possibly empty) group, so ``between`` is always
    asked once."""
    if max_iter == 0:
        return [(0, 0)]
    return [(i, min(i + GROUP, max_iter)) for i in range(0, max_iter, GROUP)]


def banded_matrix(prof: torch.Tensor, size: int) -> torch.Tensor:
    """(B, k) profiles -> (B, size, size) ``M[b, i, j] = prof[b, j - i + k // 2]``,
    zero outside the profile (the JAX package's ``_banded_matrix``)."""
    k = prof.shape[1]
    ii = torch.arange(size, device=prof.device)
    idx = ii[None, :] - ii[:, None] + k // 2
    valid = (idx >= 0) & (idx < k)
    return torch.where(valid, prof[:, idx.clamp(0, k - 1)], 0.0)


def rl_bands_separable_plain(padded: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                             n_iter, *, between: Between = None) -> Optional[torch.Tensor]:
    """The recurrence as dense banded matmuls in plain PyTorch (the CPU
    path, and the yardstick the kernel is checked against on the card).
    Same operand order as the JAX scan body: ``(R @ u) @ C^T``, then
    ``(R^T @ rel) @ C``."""
    n_iter = _check(padded, px, py, n_iter)
    _, h2, w2 = padded.shape
    rs = banded_matrix(px, h2)
    cs = banded_matrix(py, w2)
    u = padded.clone()
    spans = _groups(int(n_iter.max(initial=0)))
    for g, (i0, i1) in enumerate(spans):
        if between is not None and between(g, len(spans)):
            return None
        for b in np.flatnonzero(n_iter > i0):
            r, c, p, ub = rs[b], cs[b], padded[b], u[b]
            for _ in range(min(i1, int(n_iter[b])) - i0):
                rel = p / (r @ ub @ c.T + _EPS)
                ub = ub * (r.T @ rel @ c)
            u[b] = ub
    return u


def rl_bands_separable(padded: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                       n_iter, *, between: Between = None) -> Optional[torch.Tensor]:
    """Every band's Richardson-Lucy recurrence: ``padded`` (B, h2, w2) f32,
    ``px`` (B, kr) and ``py`` (B, kc) f32 profiles on the same device,
    ``n_iter`` a host int array (B,). Returns ``u`` (B, h2, w2), or None
    when ``between`` stopped the run. ``rl_bands_separable.launches``
    counts kernel launches (two per iteration)."""
    n_iter = _check(padded, px, py, n_iter)
    if padded.device.type == "cpu":
        return rl_bands_separable_plain(padded, px, py, n_iter, between=between)
    if padded.device.type != "cuda":
        raise ValueError(f"no Richardson-Lucy kernel for device {padded.device}")
    # the kernel reads its shared-memory limit on, and launches on, the
    # current device: make it padded's
    with torch.cuda.device(padded.device):
        return _run_kernel(padded, px, py, n_iter, between)


rl_bands_separable.launches = 0


def rl_bands_separable_grouped(padded: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                               n_iter, *, group: int = 2) -> torch.Tensor:
    """:func:`rl_bands_separable` with ``group`` bands per kernel block: the
    same operands and result, ``B % group == 0``. On a CPU tensor it runs
    :func:`rl_bands_separable_plain`. ``rl_bands_separable_grouped.launches``
    counts its kernel launches (two per iteration)."""
    n_iter = _check(padded, px, py, n_iter)
    if group < 1 or padded.shape[0] % group != 0:
        raise ValueError(f"B = {padded.shape[0]} is not a multiple of group = {group}")
    if padded.device.type == "cpu":
        return rl_bands_separable_plain(padded, px, py, n_iter)
    if padded.device.type != "cuda":
        raise ValueError(f"no Richardson-Lucy kernel for device {padded.device}")
    with torch.cuda.device(padded.device):
        return _run_kernel(padded, px, py, n_iter, None, group=group,
                           counter=rl_bands_separable_grouped)


rl_bands_separable_grouped.launches = 0


def _library() -> ctypes.CDLL:
    lib = kernels.load("rlsep")
    fn = lib.thz_rlsep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _run_kernel(padded, px, py, n_iter, between: Between, *, group: int = 1,
                counter=rl_bands_separable):
    lib = _library()
    b, h2, w2 = padded.shape
    max_iter = int(n_iter.max(initial=0))
    # bands by descending trip count: at iteration ``it`` the first
    # counts[it] of them are the ones still iterating
    order = np.argsort(-n_iter, kind="stable").astype(np.int32)
    counts = np.ascontiguousarray(
        (n_iter[None, :] > np.arange(max_iter)[:, None]).sum(axis=1), dtype=np.int32
    )
    order_dev = torch.as_tensor(order, device=padded.device)
    u = padded.clone()
    rel = torch.empty_like(padded)
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    spans = _groups(max_iter)
    for g, (i0, i1) in enumerate(spans):
        if between is not None and between(g, len(spans)):
            return None
        if i1 == i0:
            continue
        err = lib.thz_rlsep(
            u.data_ptr(), rel.data_ptr(), padded.data_ptr(), px.data_ptr(),
            py.data_ptr(), order_dev.data_ptr(), counts.ctypes.data, i0, i1,
            b, h2, w2, px.shape[1], py.shape[1], group, stream,
        )
        if err != 0:
            raise RuntimeError(f"rlsep kernel launch failed: CUDA error {err}")
        counter.launches += 2 * (i1 - i0)
    return u
