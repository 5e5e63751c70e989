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
(one launch per group of at most 16 masks, no second kernel) or raises; on
a CPU tensor it runs :func:`spectral_reduction_sums_plain`, the same
function written in plain PyTorch; on any other device it raises.

The kernel's work plan is made here, in pure Python, and handed to the
launch: :func:`shape` (column chunks, tile rows and buffers, the wide route
for spectra whose whole rows do not fit a block, threads, shared memory)
and :func:`plan` (row ranges and blocks for a card that holds a given
number of blocks). :func:`layout_bytes` mirrors the kernel's shared-memory
layout, whose ``thz_specred_smem`` must agree, and the launch refuses a
plan that does not fit it. The kernel's grid-barrier counters are one
small int32 tensor per device and stream: launches on one stream run in
order, and each leaves its pair as it found it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops.fourier import finish_unwrap, phase_increments

#: masks per kernel launch (the kernel's per-thread accumulators are
#: unrolled over a compile-time mask count)
MAX_MASKS = 16
#: csrc/specred.cu's preferred rows per tile (SR_ROWS) and tile buffers
#: (SR_STAGES), columns of one block (kMaxCols), and the shared memory a
#: block may use (``thz_specred_config``)
ROWS, STAGES, MAX_COLS = 4, 4, 640
SMEM_PER_BLOCK = 232_448

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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def layout_bytes(f: int, cw: int, m: int, rows: int, stages: int, wide: bool) -> int:
    """Shared-memory bytes of one block (``thz_specred_smem``): the tile
    barriers, ``stages`` tiles of ``rows`` rows of F complex64 (of the
    chunk's ``cw`` columns and the one left of them on the wide route), two
    (amp, angle) buffers of rows x (cw + 1) and two mask buffers of
    rows x round4(M) f32."""
    ts = cw + 1 if wide else f
    return (_round_up(stages * 8, 16) + stages * rows * ts * 8 + 2 * rows * (cw + 1) * 8
            + 2 * rows * _round_up(m, 4) * 4)


def shape(f: int, m: int, rows: int = ROWS, stages: int = STAGES,
          max_cols: int = MAX_COLS) -> dict:
    """The block's shape for F columns and m masks, from the shapes alone:
    column chunks of at most ``max_cols``; tiles of whole rows, ``rows``
    rows in ``stages`` buffers, fewer buffers (down to 2) where that does
    not fit a block, then 2 rows; where even that does not fit (F above
    ~6 600), the wide route: tiles of the chunk's columns, read with plain
    loads, in 2 buffers. Threads: one per column and per mask value of a
    tile, in whole warps."""
    if not (1 <= m <= MAX_MASKS and f >= 1):
        raise ValueError(f"no spectral reduction shape for f={f}, m={m}")
    chunks = -(-f // max_cols)
    cw = -(-f // chunks)
    wide, preferred_rows = False, rows
    nbytes = layout_bytes(f, cw, m, rows, stages, wide)
    while nbytes > SMEM_PER_BLOCK and stages > 2:
        stages -= 1
        nbytes = layout_bytes(f, cw, m, rows, stages, wide)
    if nbytes > SMEM_PER_BLOCK:
        rows = 2
        nbytes = layout_bytes(f, cw, m, rows, stages, wide)
    if nbytes > SMEM_PER_BLOCK:
        rows, stages, wide = preferred_rows, 2, True
        nbytes = layout_bytes(f, cw, m, rows, stages, wide)
    return dict(chunks=chunks, cw=cw, rows=rows, stages=stages, wide=wide,
                threads=max(_round_up(cw, 32), _round_up(m * rows, 32)), smem=nbytes)


def plan(n: int, f: int, m: int, blocks_possible: int, **preferred) -> dict:
    """The launch plan for an (n, f) spectrum and m masks on a card that
    holds ``blocks_possible`` blocks of this shape at once (the occupancy
    times the SMs): :func:`shape` (``preferred`` overrides its rows,
    stages and max_cols), the tiles, the row ranges (a range and a column
    chunk make an item; as many ranges as the resident blocks allow, at
    least one) and the blocks (every item its own block where the card
    holds them all; all blocks resident: the launch is cooperative)."""
    if n < 1 or blocks_possible < 1:
        raise ValueError(f"no spectral reduction plan for n={n} on {blocks_possible} blocks")
    s = shape(f, m, **preferred)
    n_tiles = -(-n // s["rows"])
    ranges = max(1, min(blocks_possible // s["chunks"], n_tiles))
    return dict(s, n_tiles=n_tiles, ranges=ranges,
                grid=min(ranges * s["chunks"], blocks_possible))


#: the order of thz_specred's ``plan`` array
_PLAN_ARGS = ("chunks", "cw", "rows", "stages", "wide", "ranges", "grid", "threads", "smem")


def library_config() -> dict:
    """The built kernel's compiled shape (``thz_specred_config``): its
    preferred rows and stages, its columns of one block, its block limit."""
    out = (ctypes.c_longlong * 4)()
    kernels.load("specred").thz_specred_config(out)
    return dict(rows=out[0], stages=out[1], max_cols=out[2], smem_per_block=out[3])


_plans: dict = {}
_counters: dict = {}


def kernel_plan(n: int, f: int, m: int, with_complex: bool, device=None) -> dict:
    """:func:`plan` on ``device`` (the current CUDA device by default) for
    the built kernel: its compiled shape and the blocks the card holds
    (``thz_specred_blocks_per_sm`` times the SMs), cached by shape. Holds
    ``args``, the launch's plan array."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (n, f, m, bool(with_complex), index)
    got = _plans.get(key)
    if got is None:
        cfg = library_config()
        s = shape(f, m, cfg["rows"], cfg["stages"], cfg["max_cols"])
        with torch.cuda.device(index):
            per_sm = kernels.load("specred").thz_specred_blocks_per_sm(
                m, int(bool(with_complex)), s["threads"], s["smem"])
        if per_sm < 1:
            raise RuntimeError(f"specred: no block of shape {s} fits an SM (CUDA error "
                               f"{-per_sm})")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        got = plan(n, f, m, per_sm * sms, rows=cfg["rows"], stages=cfg["stages"],
                   max_cols=cfg["max_cols"])
        got["blocks_possible"] = per_sm * sms
        got["args"] = (ctypes.c_longlong * len(_PLAN_ARGS))(*(int(got[k]) for k in _PLAN_ARGS))
        _plans[key] = got
    return got


def _barrier_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's grid-barrier counters for launches on ``stream`` of
    ``device``: {arrivals, generation}, zero when made (on that stream);
    each launch leaves the arrivals zero."""
    key = (device, stream)
    have = _counters.get(key)
    if have is None:
        have = _counters[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return have


def _launch(spec: torch.Tensor, masks: torch.Tensor, with_complex: bool) -> torch.Tensor:
    """One kernel launch for at most 16 masks -> (n_out, M, F)."""
    n, f = spec.shape
    m = masks.shape[0]
    n_out = 4 if with_complex else 2
    masks = masks.contiguous()
    p = kernel_plan(n, f, m, with_complex, spec.device)
    bulk = not p["wide"] and spec.data_ptr() % 16 == 0
    partial = torch.empty(p["ranges"] * n_out * m * f, dtype=torch.float32, device=spec.device)
    out = torch.empty((n_out, m, f), dtype=torch.float32, device=spec.device)
    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        counters = _barrier_counters(spec.device, stream)
        err = kernels.load("specred").thz_specred(
            torch.view_as_real(spec).data_ptr(), masks.data_ptr(), partial.data_ptr(),
            counters.data_ptr(), out.data_ptr(), n, f, m, int(bool(with_complex)), p["args"],
            int(bulk), stream,
        )
    kernels.check_launch(err, "specred")
    spectral_reduction_sums.launches += 1
    return out


def lean_spectral_sums(raw_fft: torch.Tensor, masks: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       with_complex: bool = False) -> Sums:
    """The pixel sums behind :func:`lean_spectral_outputs`: one reduction
    pass over the (X, Y, F) complex64 raw spectrum with the mask stack
    ``[valid region, ROI 1, ..., ROI R]``. ``masks``: (R, X, Y) ROI stack;
    ``valid``: (X, Y) 0/1 of the pixels inside the valid region, all ones
    for None. Returns the (1 + R, F) sums of :func:`spectral_reduction_sums`
    (amplitude, phase increment and, with ``with_complex``, real and
    imaginary part). Sums over disjoint pixel blocks add up to the whole
    grid's: the sharded update joins them before :func:`lean_spectral_finish`."""
    x, y, nf = raw_fft.shape
    n = x * y
    mflat = masks.reshape(masks.shape[0], n).to(torch.float32)
    first = (torch.ones((1, n), dtype=torch.float32, device=masks.device) if valid is None
             else valid.reshape(1, n).to(torch.float32))
    return spectral_reduction_sums(raw_fft.reshape(n, nf), torch.cat([first, mflat]),
                                   with_complex=with_complex)


def lean_spectral_finish(sums: Sums, wvec: torch.Tensor, roi_counts: torch.Tensor,
                         valid_count: int) -> dict[str, torch.Tensor]:
    """The publish's spectral means from :func:`lean_spectral_sums`'s sums:
    divided by the valid-pixel count and the (R,) ROI pixel counts (an
    empty ROI gives zeros), the per-frequency FD weight product ``wvec``
    applied (it factors out of every pixel sum), the phases finished with
    the cumsum. Keys ``avg_amp``, ``avg_ph``, ``roi_amp``, ``roi_ph`` and,
    where the sums hold the real and imaginary parts, ``avg_fft``."""
    amp_s, inc_s, cos_s, sin_s = sums
    vcnt = max(int(valid_count), 1)
    safe = torch.clamp(roi_counts, min=1.0)[:, None]
    nonzero = (roi_counts > 0)[:, None]
    out = dict(
        avg_amp=amp_s[0] * wvec / vcnt,
        avg_ph=finish_unwrap(inc_s[0] / vcnt),
        roi_amp=torch.where(nonzero, amp_s[1:] * wvec[None, :] / safe, 0.0),
        roi_ph=finish_unwrap(torch.where(nonzero, inc_s[1:] / safe, 0.0)),
    )
    if cos_s is not None:
        out["avg_fft"] = torch.complex(cos_s[0], sin_s[0]) * wvec / vcnt
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
    sums = lean_spectral_sums(raw_fft, masks, with_complex=with_complex)
    roi_counts = masks.to(torch.float32).sum(dim=(1, 2))
    return lean_spectral_finish(sums, wvec, roi_counts, int(valid_wh[0]) * int(valid_wh[1]))
