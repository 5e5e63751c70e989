"""Per-trace envelope and min-max normalization of the 3-D voxel view: the
wrapper of ``csrc/envelope.cu``.

Port of ``thz_image_explorer_tpu/ops/voxel.py:_envelope_pallas``, computing
the function of that module's f32 XLA path (``_normalized_opacities``).
For each trace ``v`` (a row of the (N, T) input)::

    p   = (v * v) ** contrast                      (0 ** 0 = 1)
    env = zero-boundary "same" correlation of p with the (2r+1,) taps
    out = (env - env.min()) / (env.max() - env.min())

and ``out = 0`` for the whole trace where ``env.max() < thr`` or
``|env.max() - env.min()| <= 1e-6``. A correlation, not a convolution:
``env[t] = sum_k taps[k] * p[t + k - r]``, the taps are not flipped.

On a CUDA tensor :func:`envelope` launches the CUDA kernel (one launch per
call) or raises; on a CPU tensor it runs :func:`envelope_plain`, the same
function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from thz_image_explorer_tpu_torch import kernels


def _operands(flat: torch.Tensor, taps) -> torch.Tensor:
    """Check ``flat`` and return the taps as a contiguous f32 vector on its
    device."""
    if flat.dtype != torch.float32 or flat.ndim != 2 or flat.shape[1] < 1:
        raise ValueError(f"flat must be (N, T) float32 with T >= 1, got {flat.dtype} "
                         f"{tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError("flat must be contiguous")
    if not isinstance(taps, torch.Tensor):
        taps = np.asarray(taps, np.float32)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=flat.device).contiguous()
    if taps.ndim != 1 or taps.shape[0] % 2 != 1:
        raise ValueError(f"taps must be a vector of odd length 2r+1, got {tuple(taps.shape)}")
    return taps


def envelope_plain(flat: torch.Tensor, taps, contrast: float, thr: float) -> torch.Tensor:
    """The function written from its formula in plain PyTorch (the CPU path,
    and the yardstick the kernel is checked against on the card): the
    correlation as a sum of shifted slices, in f32."""
    taps = _operands(flat, taps)
    t = flat.shape[1]
    r = taps.shape[0] // 2
    powed = F.pad(torch.pow(flat * flat, float(contrast)), (r, r))
    env = torch.zeros_like(flat)
    for k in range(taps.shape[0]):
        env = env + taps[k] * powed[:, k: k + t]
    lmax = env.amax(dim=-1, keepdim=True)
    lmin = env.amin(dim=-1, keepdim=True)
    rng = lmax - lmin
    return torch.where((lmax >= float(thr)) & (rng.abs() > 1e-6), (env - lmin) / rng, 0.0)


def envelope(flat: torch.Tensor, taps, contrast: float, thr: float) -> torch.Tensor:
    """Opacities (N, T) f32 of the (N, T) f32 traces ``flat`` for the
    (2r+1,) ``taps`` (host or device; moved to ``flat``'s device), the
    contrast exponent and the trace-max threshold ``thr``.
    ``envelope.launches`` counts kernel launches (one per call on CUDA)."""
    taps = _operands(flat, taps)
    if flat.device.type == "cpu":
        return envelope_plain(flat, taps, contrast, thr)
    if flat.device.type != "cuda":
        raise ValueError(f"no envelope kernel for device {flat.device}")
    with torch.cuda.device(flat.device):
        return _run_kernel(flat, taps, contrast, thr)


envelope.launches = 0


def _library() -> ctypes.CDLL:
    lib = kernels.load("envelope")
    fn = lib.thz_envelope
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _run_kernel(flat, taps, contrast, thr) -> torch.Tensor:
    lib = _library()
    n, t = flat.shape
    out = torch.empty_like(flat)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    err = lib.thz_envelope(flat.data_ptr(), out.data_ptr(), taps.data_ptr(), n, t,
                           taps.shape[0] // 2, float(contrast), float(thr), stream)
    if err != 0:
        raise RuntimeError(f"envelope kernel launch failed: CUDA error {err}")
    envelope.launches += 1
    return out
