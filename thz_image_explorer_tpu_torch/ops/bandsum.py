"""The deconvolution's band sum in one pass: the wrapper of ``csrc/bandsum.cu``.

For the (N, m) complex64 spectra ``spec`` of a block of N pixels (pixel
``n = i * cols + j``), the Richardson-Lucy estimates ``u`` (B, h2, w2) on the
padded canvas, the block's band energies ``energy`` (N, B) and the bands'
spectra ``taps`` (B, m)::

    g_b(n)    = sqrt(max(u[b, pr + i, pc + j], 0) / energy[n, b])    (0/0 = NaN)
    out(n, f) = spec(n, f) * sum_b g_b(n) T_b(f)

written over ``spec`` and returned; ``(pr, pc)`` is where the block's pixel
(0, 0) lies on the canvas (the pads, plus a mesh rank's origin). The inverse
transform that follows is cuFFT's (``ops/deconvolution.py``).

It replaces no TPU kernel: the JAX package's band sum is two ``jnp.einsum``
calls and elementwise products in XLA
(``thz_image_explorer_tpu/ops/deconvolution.py:_spectral_band_sum``). On the
card that form moved ~27 GB at 512 x 512 x 1024 (two (N, m) f32 weights, the
products over strided views, the complex copy); the function needs the
spectrum read and written once, 16 bytes a bin (:func:`bound_bytes`: 3.2 GB,
~0.96 ms at 3.35 TB/s).

On a CPU tensor :func:`weighted_spectrum` runs :func:`weighted_spectrum_plain`,
the deconvolution's arithmetic before the kernel (f32 matmuls for the weight,
then the products; TF32 is off); on a CUDA tensor it launches the kernel (one
launch per call, counted by ``weighted_spectrum.launches``) or raises; on any
other device it raises. The kernel sums the bands in ascending order with
fused multiply-adds, so reruns are bit-identical; it differs from the plain
version's matmul by rounding only.

The kernel's work plan is made here from the shapes (:func:`plan`) and handed
to the launch; :func:`layout_bytes` mirrors the kernel's shared-memory layout,
whose ``thz_bandsum_smem`` must agree, and the launch refuses a plan that does
not fit it.
"""

from __future__ import annotations

import ctypes

import torch

from thz_image_explorer_tpu_torch import kernels

#: csrc/bandsum.cu's pixels a block (kWarps warps of kWarpRows rows)
BLOCK_ROWS = 64
#: its spectrum buffers: two of kWarpRows x 32 16-byte vectors a warp
SPEC_BUFFER_BYTES = 8 * 2 * 8 * 32 * 16
#: shared memory of one block when two share an SM: (228 KB - 2 x 1 KB
#: reserved) / 2
SMEM_BUDGET = 115_712


def layout_bytes(ci: int, bc: int) -> int:
    """Shared-memory bytes of one block (``thz_bandsum_smem``): ``bc`` bands'
    chunk of taps, 2 ci + 2 complex bins each, their gains for the block's
    64 pixels, then the warps' spectrum buffers."""
    return bc * (2 * ci + 2) * 8 + bc * BLOCK_ROWS * 4 + SPEC_BUFFER_BYTES


def plan(n: int, m: int, bands: int) -> dict:
    """The kernel's plan for N pixels, m bins and B bands, from the shapes
    alone: ``ci`` vector indices a chunk of taps (a multiple of 32: the
    fewest chunks that leave two blocks an SM), ``bc`` bands a chunk (all of
    them, unless even one step of taps does not fit: then as many as fit,
    one step of 32 a chunk), ``blocks`` of 64 pixels, ``smem`` bytes."""
    if n < 1 or m < 1 or m % 2 == 0 or bands < 1:
        raise ValueError(f"no band-sum plan for n={n}, m={m}, bands={bands}")
    steps = max(1, -(-((m - 1) // 2) // 32))
    blocks = -(-n // BLOCK_ROWS)
    for chunks in range(1, steps + 1):
        ci = 32 * -(-steps // chunks)
        nbytes = layout_bytes(ci, bands)
        if nbytes <= SMEM_BUDGET:
            return dict(ci=ci, bc=bands, blocks=blocks, smem=nbytes)
    bc = (SMEM_BUDGET - SPEC_BUFFER_BYTES) // (layout_bytes(32, 1) - SPEC_BUFFER_BYTES)
    return dict(ci=32, bc=bc, blocks=blocks, smem=layout_bytes(32, bc))


def bound_bytes(n: int, m: int, bands: int) -> int:
    """Bytes the function must move: the spectrum read and written, the
    crop of u and the energies read once, the taps read once."""
    return 16 * n * m + 8 * n * bands + 8 * bands * m


def _check(spec, u, energy, taps, offset, cols) -> None:
    if spec.dtype != torch.complex64 or spec.ndim != 2 or spec.shape[1] % 2 == 0:
        raise ValueError(f"spec must be (N, m) complex64 with m odd, got {spec.dtype} "
                         f"{tuple(spec.shape)}")
    n, m = spec.shape
    if u.dtype != torch.float32 or u.ndim != 3:
        raise ValueError(f"u must be (B, h2, w2) float32, got {u.dtype} {tuple(u.shape)}")
    bands = u.shape[0]
    if energy.dtype != torch.float32 or tuple(energy.shape) != (n, bands):
        raise ValueError(f"energy must be ({n}, {bands}) float32, got {energy.dtype} "
                         f"{tuple(energy.shape)}")
    if taps.dtype != torch.complex64 or tuple(taps.shape) != (bands, m):
        raise ValueError(f"taps must be ({bands}, {m}) complex64, got {taps.dtype} "
                         f"{tuple(taps.shape)}")
    if any(t.device != spec.device for t in (u, energy, taps)):
        raise ValueError("spec, u, energy and taps must be on one device")
    if not all(t.is_contiguous() for t in (spec, u, energy, taps)):
        raise ValueError("spec, u, energy and taps must be contiguous")
    pr, pc = offset
    if cols < 1 or n % cols or pr < 0 or pc < 0 or pr + n // cols > u.shape[1] \
            or pc + cols > u.shape[2]:
        raise ValueError(f"a block of {n} pixels in rows of {cols} at {offset} does not lie "
                         f"on the {tuple(u.shape[1:])} canvas")


def weighted_spectrum_plain(spec, u, energy, taps, offset, cols) -> torch.Tensor:
    """The function in plain PyTorch (the CPU path, and the yardstick the
    kernel is checked against on the card): the gains as the crop of ``u``
    over the energies, the weight as two f32 matmuls, the products."""
    _check(spec, u, energy, taps, offset, cols)
    bands, n = u.shape[0], spec.shape[0]
    x = n // cols
    pr, pc = offset
    crop = u[:, pr: pr + x, pc: pc + cols]
    # 0/0 -> NaN, as in the reference
    gains = torch.sqrt(torch.clamp(crop, min=0.0) / energy.T.reshape(bands, x, cols))
    g = gains.reshape(bands, -1)  # (B, N)
    wr = g.T @ taps.real.contiguous()  # (N, m)
    wi = g.T @ taps.imag.contiguous()
    sr = spec.real * wr - spec.imag * wi
    si = spec.real * wi + spec.imag * wr
    return spec.copy_(torch.complex(sr, si))


def weighted_spectrum(spec, u, energy, taps, offset, cols) -> torch.Tensor:
    """``spec`` (N, m) complex64 times ``sum_b g_b T_b``, in place (module
    docstring); returns ``spec``. ``u`` (B, h2, w2) f32, ``energy`` (N, B)
    f32 and ``taps`` (B, m) complex64 on ``spec``'s device, all contiguous;
    ``offset`` the block's (row, column) on the canvas, ``cols`` its pixels
    a row. ``weighted_spectrum.launches`` counts kernel launches."""
    _check(spec, u, energy, taps, offset, cols)
    if spec.device.type == "cpu":
        return weighted_spectrum_plain(spec, u, energy, taps, offset, cols)
    if spec.device.type != "cuda":
        raise ValueError(f"no band-sum kernel for device {spec.device}")
    if spec.data_ptr() % 16:
        raise ValueError("spec must be 16-byte aligned")
    with torch.cuda.device(spec.device):
        return _run_kernel(spec, u, energy, taps, offset, cols)


weighted_spectrum.launches = 0


def library_config() -> dict:
    """The built kernel's compiled shape (``thz_bandsum_config``)."""
    out = (ctypes.c_longlong * 3)()
    kernels.load("bandsum").thz_bandsum_config(out)
    return dict(warps=out[0], block_rows=out[1], smem_per_block=out[2])


def _run_kernel(spec, u, energy, taps, offset, cols) -> torch.Tensor:
    n, m = spec.shape
    if n == 0:
        return spec
    bands = u.shape[0]
    p = plan(n, m, bands)
    args = (ctypes.c_longlong * 4)(p["ci"], p["bc"], p["blocks"], p["smem"])
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    err = kernels.load("bandsum").thz_bandsum(
        spec.data_ptr(), u.data_ptr(), energy.data_ptr(), taps.data_ptr(), n, m, bands, cols,
        u.shape[1], u.shape[2], int(offset[0]), int(offset[1]), args, stream)
    kernels.check_launch(err, "band-sum")
    weighted_spectrum.launches += 1
    return spec
