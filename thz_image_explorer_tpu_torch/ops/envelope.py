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
function in plain PyTorch; on any other device it raises.

The kernel's work plan is made here, in pure Python, and handed to the
launch: :func:`plan` (the routes and the block shape, chosen from the shapes
alone; the bulk route also needs 16-byte aligned tensors, checked at the
launch). :func:`layout_bytes` mirrors the kernel's shared-memory layout,
whose ``thz_envelope_smem`` must agree, and the launch refuses a plan that
does not fit it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from thz_image_explorer_tpu_torch import kernels

#: csrc/envelope.cu's preferred warps per block and input buffers per warp
#: (its ENV_WARPS, ENV_STAGES), outputs per lane run (kRun), the largest
#: radius with its own instantiation (kMaxR) and the shared memory a block
#: may use (``thz_envelope_config``)
WARPS, STAGES, RUN, MAX_R = 4, 2, 8, 12
SMEM_PER_BLOCK = 232_448


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def stage_floats(t: int, r: int) -> int:
    """Floats of one input buffer: a zero halo of round4(r), the trace
    rounded up to whole runs, and the right halo the last run's float4
    window reaches (at least r zeros)."""
    return -(-t // RUN) * RUN - RUN + _round4(_round4(r) + r + RUN)


def out_floats(t: int) -> int:
    """Floats of one output buffer: the trace rounded up to whole runs."""
    return -(-t // RUN) * RUN


def layout_bytes(warps: int, stages: int, outs: int, t: int, r: int) -> int:
    """Shared-memory bytes of one block (``thz_envelope_smem``): the
    barriers (8 bytes a warp and input buffer, rounded to 16), then per
    warp ``stages`` input and ``outs`` output buffers."""
    bars = -(-warps * stages * 8 // 16) * 16
    return bars + 4 * warps * (stages * stage_floats(t, r) + outs * out_floats(t))


def plan(t: int, r: int, warps: int = WARPS, stages: int = STAGES) -> dict:
    """The kernel's routes and block shape for traces of length ``t`` and
    radius ``r``, from the shapes alone: ``bulk`` (whole-trace bulk copies,
    T a multiple of 4) or ``plain`` (4-byte accesses); ``registers`` (taps
    in registers, r <= MAX_R) or ``generic`` (a loop over the taps);
    ``warps`` warps a block, each with ``stages`` input and two output
    buffers; where that does not fit a block, fewer warps, then fewer input
    buffers, then one output buffer, then none (the raw envelope goes to
    the output in device memory and is normalized there); ``smem`` bytes.
    Raises where one warp with one input buffer does not fit a block."""
    if t < 1 or r < 0:
        raise ValueError(f"no envelope plan for t={t}, r={r}")
    outs = 2
    nbytes = layout_bytes(warps, stages, outs, t, r)
    while nbytes > SMEM_PER_BLOCK and warps > 1:
        warps -= 1
        nbytes = layout_bytes(warps, stages, outs, t, r)
    while nbytes > SMEM_PER_BLOCK and stages > 1:
        stages -= 1
        nbytes = layout_bytes(warps, stages, outs, t, r)
    while nbytes > SMEM_PER_BLOCK and outs > 0:
        outs -= 1
        nbytes = layout_bytes(warps, stages, outs, t, r)
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(f"a trace of {t} samples at radius {r} does not fit a block")
    return dict(route="bulk" if t % 4 == 0 else "plain",
                radius="registers" if r <= MAX_R else "generic",
                warps=warps, stages=stages, outs=outs, smem=nbytes)


def blocks(n: int, warps: int, blocks_possible: int) -> int:
    """Persistent blocks for n traces: as many as the card holds at once,
    but no warp without a trace (each warp g of the G in the grid walks
    the traces g, g + G, g + 2G, ...)."""
    return max(1, min(blocks_possible, -(-n // warps)))


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


def library_config() -> dict:
    """The built kernel's compiled shape (``thz_envelope_config``): its
    preferred warps and input buffers, its run, its largest radius with
    taps in registers, its block limit."""
    out = (ctypes.c_longlong * 5)()
    kernels.load("envelope").thz_envelope_config(out)
    return dict(warps=out[0], stages=out[1], run=out[2], max_r=out[3], smem_per_block=out[4])


_plans: dict = {}


def kernel_plan(n: int, t: int, r: int, device=None) -> dict:
    """:func:`plan` for n traces on ``device`` (the current CUDA device by
    default) with the built kernel's compiled shape, plus its blocks
    (persistent: the blocks the card holds, ``thz_envelope_blocks_per_sm``
    times the SMs, at most one warp per trace) and threads; cached by
    shape."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (n, t, r, index)
    got = _plans.get(key)
    if got is None:
        cfg = library_config()
        got = plan(t, r, cfg["warps"], cfg["stages"])
        threads = got["warps"] * 32
        with torch.cuda.device(index):
            per_sm = kernels.load("envelope").thz_envelope_blocks_per_sm(r, threads, got["smem"])
        if per_sm < 1:
            raise RuntimeError(f"envelope: no block of shape {got} fits an SM (CUDA error "
                               f"{-per_sm})")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        got.update(threads=threads, blocks_possible=per_sm * sms,
                   blocks=blocks(n, got["warps"], per_sm * sms))
        _plans[key] = got
    return got


def _run_kernel(flat, taps, contrast, thr) -> torch.Tensor:
    n, t = flat.shape
    r = taps.shape[0] // 2
    out = torch.empty_like(flat)
    if n == 0:
        return out
    p = kernel_plan(n, t, r, flat.device)
    bulk = p["route"] == "bulk" and flat.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    args = (ctypes.c_longlong * 6)(p["warps"], p["stages"], p["outs"], int(bulk), p["blocks"],
                                   p["smem"])
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    err = kernels.load("envelope").thz_envelope(flat.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                                n, t, r, float(contrast), float(thr), args, stream)
    kernels.check_launch(err, "envelope")
    envelope.launches += 1
    return out
