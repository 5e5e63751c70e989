"""General 2-D Richardson-Lucy on one image: the wrapper of ``csrc/rl2d.cu``.

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

On a CUDA tensor :func:`richardson_lucy_direct` launches the CUDA kernel
(two launches per iteration) or raises; on a CPU tensor it runs
:func:`richardson_lucy_direct_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from thz_image_explorer_tpu_torch import kernels

_EPS = 1e-12


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
    kernel is checked against on the card), f32. No ``F.conv2d``: on the
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
    ``u`` (h2, w2). ``richardson_lucy_direct.launches`` counts kernel
    launches (two per iteration)."""
    n_iter = _check(padded, psf, n_iter)
    if padded.device.type == "cpu":
        return richardson_lucy_direct_plain(padded, psf, n_iter)
    if padded.device.type != "cuda":
        raise ValueError(f"no Richardson-Lucy kernel for device {padded.device}")
    with torch.cuda.device(padded.device):
        return _run_kernel(padded, psf, n_iter)


richardson_lucy_direct.launches = 0


def _library() -> ctypes.CDLL:
    lib = kernels.load("rl2d")
    fn = lib.thz_rl2d
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _run_kernel(padded, psf, n_iter: int) -> torch.Tensor:
    lib = _library()
    h2, w2 = padded.shape
    kr, kc = psf.shape
    u = padded.clone()
    if n_iter == 0:
        return u
    rel = torch.empty_like(padded)
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    err = lib.thz_rl2d(u.data_ptr(), rel.data_ptr(), padded.data_ptr(), psf.data_ptr(),
                       n_iter, h2, w2, kr, kc, stream)
    if err != 0:
        raise RuntimeError(f"rl2d kernel launch failed: CUDA error {err}")
    richardson_lucy_direct.launches += 2 * n_iter
    return u
