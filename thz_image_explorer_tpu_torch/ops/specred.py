"""One-pass spectral publish reduction: the wrapper of ``csrc/specred.cu``.

Port of ``thz_image_explorer_tpu/ops/pallas_specred.py``. For each pixel
row of the (N, F) complex64 spectrum it forms ``amp = |z|``, ``ang =
atan2(im, re)`` and the wrapped phase increments (``ops/fourier.
phase_increments``: ``inc[0] = ang[0]``, ``inc[k] = wrap_adjust(ang[k] -
ang[k-1])``), and sums ``amp``, ``inc`` and optionally the real and
imaginary parts over a stack of 0/1 pixel masks. Row 0 of the mask stack is
the valid region, rows 1.. are ROIs; the caller divides by the mask counts
and finishes the phase means with a cumsum.

On a CUDA tensor :func:`spectral_reduction_sums` launches the CUDA kernel
(one launch per group of at most 16 masks) or raises; on a CPU tensor it
runs :func:`spectral_reduction_sums_plain`, the same function written in
plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops.fourier import finish_unwrap, phase_increments

#: masks per kernel launch (the kernel's per-thread accumulators are
#: unrolled over a compile-time mask count)
MAX_MASKS = 16
#: partial-sum blocks per SM the row chunking aims for
_BLOCKS_PER_SM = 8
#: frequency columns per block (``kThreads`` in csrc/specred.cu)
_COLS_PER_BLOCK = 128

Sums = tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _check(spec: torch.Tensor, masks: torch.Tensor) -> None:
    if spec.dtype != torch.complex64 or spec.ndim != 2:
        raise ValueError(f"spec must be (N, F) complex64, got {spec.dtype} {tuple(spec.shape)}")
    if masks.dtype != torch.float32 or masks.ndim != 2:
        raise ValueError(f"masks must be (M, N) float32, got {masks.dtype} {tuple(masks.shape)}")
    if masks.shape[1] != spec.shape[0] or masks.shape[0] < 1:
        raise ValueError(
            f"masks {tuple(masks.shape)} do not fit spec {tuple(spec.shape)} (need M >= 1, N equal)"
        )
    if masks.device != spec.device:
        raise ValueError(f"spec on {spec.device}, masks on {masks.device}")
    if not (spec.is_contiguous() and masks.is_contiguous()):
        raise ValueError("spec and masks must be contiguous")


def spectral_reduction_sums_plain(spec: torch.Tensor, masks: torch.Tensor,
                                  with_complex: bool = True) -> Sums:
    """The reduction written from its formula in plain PyTorch (the CPU
    path, and the yardstick the kernel is checked against on the card)."""
    c, s = spec.real, spec.imag
    amp = torch.sqrt(c * c + s * s)
    inc = phase_increments(torch.atan2(s, c))
    if not with_complex:
        return masks @ amp, masks @ inc, None, None
    return masks @ amp, masks @ inc, masks @ c, masks @ s


def spectral_reduction_sums(spec: torch.Tensor, masks: torch.Tensor,
                            with_complex: bool = True) -> Sums:
    """Masked row sums ``(amp, inc, re, im)``, each (M, F) f32, of the
    (N, F) complex64 spectrum ``spec`` over the (M, N) f32 ``masks``.
    ``with_complex=False`` skips the real/imag sums (``None`` in their
    slots). ``spectral_reduction_sums.launches`` counts kernel launches."""
    _check(spec, masks)
    if spec.device.type == "cpu":
        return spectral_reduction_sums_plain(spec, masks, with_complex)
    if spec.device.type != "cuda":
        raise ValueError(f"no spectral reduction for device {spec.device}")
    return _in_groups(_launch, spec, masks, with_complex)


spectral_reduction_sums.launches = 0


def _in_groups(reduce_group, spec, masks, with_complex) -> Sums:
    """``reduce_group(spec, masks_g, with_complex) -> (n_out, M_g, F)`` on
    consecutive groups of at most ``MAX_MASKS`` masks, joined along M."""
    groups = [
        reduce_group(spec, masks[g: g + MAX_MASKS], with_complex)
        for g in range(0, masks.shape[0], MAX_MASKS)
    ]
    out = groups[0] if len(groups) == 1 else torch.cat(groups, dim=1)
    if with_complex:
        return out[0], out[1], out[2], out[3]
    return out[0], out[1], None, None


def _library() -> ctypes.CDLL:
    lib = kernels.load("specred")
    fn = lib.thz_specred
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(spec: torch.Tensor, masks: torch.Tensor, with_complex: bool) -> torch.Tensor:
    """One kernel launch for at most 16 masks -> (n_out, M, F)."""
    lib = _library()
    n, f = spec.shape
    m = masks.shape[0]
    n_out = 4 if with_complex else 2
    masks = masks.contiguous()
    # row chunks: enough blocks (frequency tiles x chunks) for a few per SM
    sms = torch.cuda.get_device_properties(spec.device).multi_processor_count
    col_tiles = -(-f // _COLS_PER_BLOCK)
    chunks = max(1, min(-(-n // 32), math.ceil(_BLOCKS_PER_SM * sms / col_tiles)))
    rows_per_chunk = -(-n // chunks)
    chunks = -(-n // rows_per_chunk)
    partial = torch.empty((chunks, n_out, m, f), dtype=torch.float32, device=spec.device)
    out = torch.empty((n_out, m, f), dtype=torch.float32, device=spec.device)
    err = lib.thz_specred(
        torch.view_as_real(spec).data_ptr(), masks.data_ptr(), partial.data_ptr(),
        out.data_ptr(), n, f, m, int(bool(with_complex)), rows_per_chunk, chunks,
        torch.cuda.current_stream(spec.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"specred kernel launch failed: CUDA error {err}")
    spectral_reduction_sums.launches += 1
    return out


def lean_spectral_outputs(raw_fft: torch.Tensor, wvec: torch.Tensor,
                          masks: torch.Tensor, valid_wh,
                          with_complex: bool = False) -> dict[str, torch.Tensor]:
    """The publish's spectral means from one reduction pass.

    ``raw_fft``: (X, Y, F) complex64 RAW spectrum (post-window, before the
    FD stages: those weight amplitudes but leave phases alone,
    ``band_pass_fd.rs``, so the published phases must come from the raw
    spectrum). ``wvec``: (F,) product of the active FD stages' weights;
    being per-frequency it factors out of every pixel sum. ``masks``:
    (R, X, Y) ROI stack. Returns ``avg_amp``, ``avg_ph``, ``roi_amp``,
    ``roi_ph`` (phases finished with the cumsum) and, with
    ``with_complex``, the pixel-mean complex spectrum ``avg_fft``."""
    x, y, nf = raw_fft.shape
    n = x * y
    r = masks.shape[0]
    mflat = masks.reshape(r, n).to(torch.float32)
    mstack = torch.cat(
        [torch.ones((1, n), dtype=torch.float32, device=masks.device), mflat]
    )
    amp_s, inc_s, cos_s, sin_s = spectral_reduction_sums(
        raw_fft.reshape(n, nf), mstack, with_complex=with_complex
    )
    vcnt = max(int(valid_wh[0]) * int(valid_wh[1]), 1)
    rcnt = mflat.sum(dim=1)
    safe = torch.clamp(rcnt, min=1.0)[:, None]
    nonzero = (rcnt > 0)[:, None]
    out = dict(
        avg_amp=amp_s[0] * wvec / vcnt,
        avg_ph=finish_unwrap(inc_s[0] / vcnt),
        roi_amp=torch.where(nonzero, amp_s[1:] * wvec[None, :] / safe, 0.0),
        roi_ph=finish_unwrap(torch.where(nonzero, inc_s[1:] / safe, 0.0)),
    )
    if with_complex:
        out["avg_fft"] = torch.complex(cos_s[0], sin_s[0]) * wvec / vcnt
    return out
