"""The FFT stage's amplitudes and unwrapped phases, in one pass on the card.

:func:`amplitude_phase` takes the (..., F) complex64 spectrum of
``torch.fft.rfft`` and returns ``(|z|, unwrap(arg z))`` along its last axis:
two f32 tensors of its shape, the ``amplitudes`` and ``phases`` of the FFT
stage's slot (``ops/fourier.forward_fft``).

On a CUDA tensor it launches ``csrc/polar.cu`` (one launch a call, counted
by ``amplitude_phase.launches``), which reads the spectrum once and writes
the two planes once: no angle tensor, no increments, no cat, no scan pass.
On a CPU tensor it runs :func:`amplitude_phase_plain`, the FFT stage's code
as it stood before the kernel: :func:`_abs_angle`, then ``unwrap``. On any
other device it raises.

On the card the two agree bit for bit in the amplitudes and the wrapped
steps (the kernel computes ``hypotf`` and ``atan2f`` as ``torch.abs`` and
``torch.angle`` do, and the wrap's roundings in ``wrap_adjust``'s order).
The running sum is ``torch.cumsum``'s own order where PyTorch scans a row in
chunks of 32 bins (R > 1 rows of F bins, R rounded up to a power of two
lying between F rounded up to one and 512 times that: every slider step's
cube), so there the
phases agree bit for bit too; elsewhere (a single row, or few long rows)
PyTorch sums in another order and the
kernel's phase at bin k lies within 2 k 2^-24 sum_{j <= k} |inc_j| of it. A
row's bits depend on the row alone, never on the rows around it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from thz_image_explorer_tpu_torch import kernels


def _abs_angle(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(|z|, arg z)`` of a complex tensor, each element computed the same
    way wherever it sits in the tensor. On the CPU an elementwise function
    takes a vector path for most elements of a contiguous run and a scalar
    one for its tail, and the two can differ in the last bit; the strided
    real and imaginary views take the scalar path for every element, so a
    block of a sharded cube gets the whole cube's values bit for bit. A
    CUDA kernel computes every element alike."""
    if spec.device.type != "cpu":
        return torch.abs(spec), torch.angle(spec)
    re, im = spec.real, spec.imag
    return torch.hypot(re, im), torch.atan2(im, re)


def _check(spec: torch.Tensor, increments: Optional[torch.Tensor]) -> None:
    if spec.dtype != torch.complex64 or spec.dim() < 1 or not spec.is_contiguous():
        raise ValueError("spec must be a contiguous complex64 tensor of at least one dimension, "
                         f"got {spec.dtype} of shape {tuple(spec.shape)}")
    if spec.shape[-1] >= 2**31:
        raise ValueError(f"a row of {spec.shape[-1]} bins does not fit the kernel")
    if increments is not None and (increments.dtype != torch.float32
                                   or increments.device != spec.device
                                   or increments.shape != spec.shape
                                   or not increments.is_contiguous()):
        raise ValueError(f"increments must be a contiguous {tuple(spec.shape)} float32 tensor "
                         f"on {spec.device}")


def amplitude_phase_plain(spec: torch.Tensor, increments: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The amplitudes and unwrapped phases in plain PyTorch (the CPU path,
    and the yardstick the kernel is checked against on the card):
    :func:`_abs_angle`, then ``ops/fourier.unwrap`` (the wrapped steps and
    ``torch.cumsum``). ``increments`` receives the wrapped steps."""
    from thz_image_explorer_tpu_torch.ops.fourier import finish_unwrap, phase_increments

    _check(spec, increments)
    amplitudes, angles = _abs_angle(spec)
    inc = phase_increments(angles)
    if increments is not None:
        increments.copy_(inc)
    return amplitudes, finish_unwrap(inc)


def amplitude_phase(spec: torch.Tensor, increments: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(amplitudes, phases)`` of the contiguous (..., F) complex64 ``spec``
    along its last axis (module docstring). ``increments``: an optional f32
    tensor of ``spec``'s shape on its device that receives the wrapped phase
    steps (``ops/fourier.phase_increments`` of the angles).
    ``amplitude_phase.launches`` counts kernel launches."""
    if spec.device.type == "cpu":
        return amplitude_phase_plain(spec, increments)
    _check(spec, increments)
    if spec.device.type != "cuda":
        raise ValueError(f"no polar kernel for device {spec.device}")
    with torch.cuda.device(spec.device):
        return _run_kernel(spec, increments)


amplitude_phase.launches = 0


def config(lib: ctypes.CDLL) -> tuple[int, int, int]:
    """The compiled shape of ``csrc/polar.cu``: (warps a block, resident
    blocks an SM, chunks of 32 bins loaded ahead)."""
    out = (ctypes.c_longlong * 3)()
    lib.thz_polar_config(out)
    return int(out[0]), int(out[1]), int(out[2])


def _run_kernel(spec: torch.Tensor, increments: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    amplitudes = torch.empty(spec.shape, dtype=torch.float32, device=spec.device)
    phases = torch.empty(spec.shape, dtype=torch.float32, device=spec.device)
    if spec.numel() == 0:
        return amplitudes, phases
    f = spec.shape[-1]
    rows = spec.numel() // f
    lib = kernels.load("polar")
    warps, per_sm, _ = config(lib)
    # the persistent grid: a warp a row, up to the blocks the card holds at once
    sms = torch.cuda.get_device_properties(spec.device).multi_processor_count
    blocks = min(-(-rows // warps), per_sm * sms)
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    err = lib.thz_polar_unwrap(spec.data_ptr(), amplitudes.data_ptr(), phases.data_ptr(),
                               None if increments is None else increments.data_ptr(), rows, f,
                               blocks, stream)
    kernels.check_launch(err, "polar")
    amplitude_phase.launches += 1
    return amplitudes, phases
