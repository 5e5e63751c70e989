"""Separable Richardson-Lucy over a stack of bands: the wrapper of
``csrc/rlsep_cluster.cu`` and ``csrc/rlsep.cu``.

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

On a CPU tensor :func:`rl_bands_separable` runs
:func:`rl_bands_separable_plain`, the same function as dense banded matmuls
in plain PyTorch (f32; TF32 is off). On a CUDA tensor it launches one of
two kernels, chosen from the shapes alone before any launch
(:func:`cluster_size_for`):

- the cluster route, ``csrc/rlsep_cluster.cu``: each band's estimate is
  held in the shared memory of a thread-block cluster of ``S`` CTAs
  (:func:`cluster_rows` splits its rows) and one launch runs a whole host
  checkpoint group (:func:`launch_schedule`), counted by
  ``rl_bands_separable.launches``. Where the clusters of the bands still
  iterating would leave much of the card idle (the late groups, few bands
  with many iterations left), that group's launch takes the wide route of
  the same source instead: one cooperative launch in which each band runs
  on more blocks than one cluster holds, its estimate and ``rel`` in device
  memory, a band-wide barrier between the halves (:func:`launch_plan`,
  :func:`wide_blocks`). It counts in ``launches`` too, and in
  ``rl_bands_separable.launches_wide``; its output equals the cluster
  route's bit for bit;
- the tiled route, ``csrc/rlsep.cu``, for a canvas whose estimate and
  scratch do not fit 16 CTAs' shared memory: two launches per iteration,
  counted by ``rl_bands_separable.launches_tiled``.

A refused launch raises; nothing falls back to the other route or to the
plain version.

:func:`rl_bands_separable_grouped` is the same function on the cluster
kernel with ``group`` bands per cluster (port of
``pallas_rl.py:rl_bands_separable_grouped``, the JAX package's G-band
interleave): the G bands' half-iterations run back to back between shared
cluster barriers (:func:`grouped_plan`, :func:`grouped_smem_bytes`), and on
the card its output equals :func:`rl_bands_separable`'s cluster route bit
for bit. A group that does not fit 16 CTAs raises. No production path calls
it.

Both :func:`rl_bands_separable` and the plain version take
``between(done, total) -> bool``, called on the host before each
group of at most :data:`GROUP` iterations (``done`` groups of ``total`` run
so far); returning True stops the run and the function returns None. That
is where the deconvolution reports progress and checks cancellation.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch import kernels

_EPS = 1e-12
#: iterations between two host checkpoints
GROUP = 50
#: shared memory one CTA may use on Hopper (227 KB)
SMEM_PER_BLOCK = 232_448
#: the largest thread-block cluster the cluster route launches
MAX_CLUSTER = 16
#: the cluster size the cluster route takes where it fits (measured against
#: 8 at the reference Apply; PERF.md)
PREFERRED_CLUSTER = 16
#: the most bands one cluster of the grouped mode holds (kMaxGroup)
MAX_GROUP = 8
#: the most bands one launch of the wide route holds (kMaxWide)
MAX_WIDE = 8
#: the wide route's crossover: a checkpoint launch takes it only where the
#: clusters of its bands would hold less than 1 - this share of the card's
#: SMs. Measured at the 512² Apply's inputs on an H100 (132 SMs, clusters
#: of 16; PERF.md §6): the launch of 6 bands (73 % of the SMs) ran 5 %
#: faster on the wide route and those of 4 bands or fewer 34-51 %; a launch
#: of 7 bands (85 %, a rank's subset of a sharded Apply) ran 17 % slower.
#: The share lies between those two readings.
WIDE_IDLE_SHARE = 0.2
#: the fewest rows a block's slab holds on the wide route: one strip (kSR)
WIDE_MIN_ROWS = 8
# csrc/rlsep_cluster.cu's strip height, rows per pass and axis-1 block
# (kSR, kPass, kCB) and its static shared memory per band (reach[2])
_SR, _PASS, _CB = 8, 16, 8
_STATIC_SMEM = 8
# and the wide route's (reach[2] and the staging mbarrier)
_STATIC_SMEM_WIDE = 16

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


def launch_schedule(n_iter) -> list[tuple[int, int, int]]:
    """The cluster route's launches: ``(i0, i1, nb)`` per non-empty host
    checkpoint group, running iterations ``i0 .. i1 - 1`` of the ``nb``
    bands with ``n_iter > i0``, each band stopping at
    ``min(i1, n_iter[b])``."""
    n_iter = np.asarray(n_iter)
    return [(i0, i1, int((n_iter > i0).sum()))
            for i0, i1 in _groups(int(n_iter.max(initial=0))) if i1 > i0]


def cluster_rows(h2: int, s: int, reach: int) -> list[tuple[int, int, int, int]]:
    """The rows of each CTA of an ``s``-CTA cluster on an ``h2``-row canvas,
    as ``csrc/rlsep_cluster.cu`` splits them: ``(lo, hi, q_lo, q_hi)`` per
    rank, the CTA owning rows ``lo .. hi - 1`` (the first ``h2 % s`` ranks
    one row more) and its axis-0 halo of ``reach`` rows lying in the slabs of
    ranks ``q_lo .. q_hi``."""
    if not 1 <= s <= h2:
        raise ValueError(f"cluster size {s} outside 1..{h2}")
    base, rem = divmod(h2, s)
    spans = [(q * base + min(q, rem), (q + 1) * base + min(q + 1, rem)) for q in range(s)]

    def owner(j):
        return next(q for q, (lo, hi) in enumerate(spans) if lo <= j < hi)

    return [(lo, hi, owner(max(lo - reach, 0)), owner(min(hi - 1 + reach, h2 - 1)))
            for lo, hi in spans]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def grouped_smem_bytes(h2: int, w2: int, kr: int, kc: int, s: int, g: int) -> int:
    """Shared memory of one CTA of a cluster holding ``g`` bands (``layout``
    in ``csrc/rlsep_cluster.cu``, plus its static bytes): per band the u and
    rel slabs of ``ceil(h2 / s)`` rows, the taps, the halo window's row
    tables and the reach; one strip and one zero row.
    ``thz_rlsep_grouped_smem`` of the built library returns the same."""
    rows = -(-h2 // s)
    ws = w2 + (1 - w2) % 32
    hr, hc = kr // 2, kc // 2
    nwin = rows + 2 * hr + 3 * _SR
    taps = 2 * _round_up(2 * hr + 3 * _SR, 4) + 2 * _round_up(2 * hc + 3 * _CB, 4)
    strip = (2 * hc + w2 + 2 * _CB) * (_PASS + 1)
    floats = g * (taps + 2 * rows * ws) + strip + ws
    return g * (2 * nwin * 8 + _STATIC_SMEM) + 4 * floats


def cluster_smem_bytes(h2: int, w2: int, kr: int, kc: int, s: int) -> int:
    """Shared memory of one CTA of the cluster route: one band a cluster.
    ``thz_rlsep_cluster_smem`` of the built library returns the same."""
    return grouped_smem_bytes(h2, w2, kr, kc, s, 1)


def grouped_fits(h2: int, w2: int, kr: int, kc: int, s: int, g: int) -> bool:
    return 1 <= g <= MAX_GROUP and 1 <= s <= min(h2, MAX_CLUSTER) and \
        grouped_smem_bytes(h2, w2, kr, kc, s, g) <= SMEM_PER_BLOCK


def cluster_fits(h2: int, w2: int, kr: int, kc: int, s: int) -> bool:
    return grouped_fits(h2, w2, kr, kc, s, 1)


def cluster_size_for(h2: int, w2: int, kr: int, kc: int, group: int = 1) -> Optional[int]:
    """The routing rule, from the shapes alone: the cluster size for
    ``group`` bands a cluster, :data:`PREFERRED_CLUSTER` or, where they need
    more CTAs, the smallest size that holds them (never above the canvas's
    rows); None when not even :data:`MAX_CLUSTER` CTAs hold them. At group
    1 that is the cluster route's size, and None sends a canvas to the
    tiled route."""
    for s in range(1, MAX_CLUSTER + 1):
        if grouped_fits(h2, w2, kr, kc, s, group):
            return max(s, min(PREFERRED_CLUSTER, h2))
    return None


def grouped_plan(n_iter, group: int) -> list[tuple[int, int, list[list[int]]]]:
    """The grouped mode's launches: ``(i0, i1, clusters)`` per entry of
    :func:`launch_schedule`, where cluster ``c`` holds the bands in slots
    ``c * group .. c * group + group - 1`` of the descending-``n_iter`` order
    that still iterate (``ceil(nb / group)`` clusters)."""
    order = np.argsort(-np.asarray(n_iter), kind="stable")
    return [(i0, i1, [order[c: min(c + group, nb)].tolist() for c in range(0, nb, group)])
            for i0, i1, nb in launch_schedule(n_iter)]


def wide_smem_bytes(h2: int, w2: int, kr: int, kc: int, rows: int) -> int:
    """Shared memory of one block of the wide route whose largest slab holds
    ``rows`` rows (``wide_layout`` in ``csrc/rlsep_cluster.cu``, plus its
    static bytes): two tables of the halo window's row pointers, the taps,
    the slab and its halo staged from device memory, the strip and one zero
    row. ``thz_rlsep_wide_smem`` of the built library returns the same."""
    hr, hc = kr // 2, kc // 2
    table = _round_up(rows + 2 * hr + 3 * _SR, 2)
    taps = 2 * _round_up(2 * hr + 3 * _SR, 4) + 2 * _round_up(2 * hc + 3 * _CB, 4)
    stage = (rows + 2 * hr) * w2 + 4
    strip = (2 * hc + w2 + 2 * _CB) * (_PASS + 1)
    return 2 * table * 8 + 4 * (taps + stage + strip + w2) + _STATIC_SMEM_WIDE


def wide_blocks(iters, h2: int, w2: int, kr: int, kc: int,
                sms: int) -> Optional[tuple[int, ...]]:
    """The wide route's blocks per band for one launch whose bands run
    ``iters`` iterations each: in proportion to them over the card's ``sms``
    SMs (one block an SM, so every block is resident), each at most ``h2 //
    WIDE_MIN_ROWS`` (no slab thinner than one strip) and at least the fewest
    whose slab fits one block's shared memory; where those floors overfill
    the card, the largest shares give up blocks. None where no such split
    fits the card."""
    cap = h2 // WIDE_MIN_ROWS
    least = next((s for s in range(1, cap + 1)
                  if wide_smem_bytes(h2, w2, kr, kc, -(-h2 // s)) <= SMEM_PER_BLOCK), None)
    if least is None or not 1 <= len(iters) <= MAX_WIDE or least * len(iters) > sms:
        return None
    total = sum(iters)
    blocks = [min(cap, max(least, sms * it // total)) for it in iters]
    while sum(blocks) > sms:  # the last of the largest, so the order holds
        blocks[len(blocks) - 1 - blocks[::-1].index(max(blocks))] -= 1
    return tuple(blocks)


def passes(rows: int) -> int:
    """Passes of one half-iteration over a slab of ``rows`` rows (``kPass``
    rows a pass, as many as the block has threads for): the unit of a
    block's time on either route. A pass of one row costs about what a full
    one does."""
    return -(-rows // _PASS)


def launch_plan(n_iter, h2: int, w2: int, kr: int, kc: int, s: int,
                sms: int) -> list[tuple[int, int, int, tuple[int, ...]]]:
    """The routes of :func:`launch_schedule`'s launches, from what the host
    sees: ``(i0, i1, nb, blocks)`` per launch, ``blocks`` empty for the
    cluster route (``nb`` clusters of ``s`` CTAs) and, for the wide route,
    the blocks of each of the ``nb`` bands in the descending-``n_iter``
    order (:func:`wide_blocks` over the card's ``sms`` SMs). A launch takes
    the wide route where it holds at most :data:`MAX_WIDE` bands, their
    clusters would leave more than :data:`WIDE_IDLE_SHARE` of the SMs idle,
    the split fits, and it gives the largest share's blocks fewer
    :func:`passes` over their slabs than a cluster's CTA makes over its own:
    the wide route pays for its staging and its barriers in device memory
    only with passes it saves (so a canvas whose cluster CTAs hold one pass
    each keeps the cluster route)."""
    n_iter = np.asarray(n_iter)
    order = np.argsort(-n_iter, kind="stable")
    plan = []
    for i0, i1, nb in launch_schedule(n_iter):
        blocks = None
        if nb <= MAX_WIDE and 1 - nb * s / sms > WIDE_IDLE_SHARE:
            iters = [min(i1, int(n_iter[b])) - i0 for b in order[:nb]]
            blocks = wide_blocks(iters, h2, w2, kr, kc, sms)
            if blocks and passes(-(-h2 // max(blocks))) >= passes(-(-h2 // s)):
                blocks = None
        plan.append((i0, i1, nb, blocks or ()))
    return plan


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
    when ``between`` stopped the run.

    On a CUDA tensor the route follows from the shapes: the cluster kernel
    at :func:`cluster_size_for` CTAs per band, one launch per non-empty
    checkpoint group, counted by ``rl_bands_separable.launches``, each
    launch on the cluster or the wide route as :func:`launch_plan` finds
    from the card's SMs (``launches_wide`` counts the
    wide ones, ``wide_blocks`` holds the blocks per band of each of the
    call's wide launches); or, where no cluster holds the canvas, the tiled
    kernel, two launches per iteration, counted by
    ``rl_bands_separable.launches_tiled``."""
    n_iter = _check(padded, px, py, n_iter)
    if padded.device.type == "cpu":
        return rl_bands_separable_plain(padded, px, py, n_iter, between=between)
    if padded.device.type != "cuda":
        raise ValueError(f"no Richardson-Lucy kernel for device {padded.device}")
    _, h2, w2 = padded.shape
    s = cluster_size_for(h2, w2, px.shape[1], py.shape[1])
    # the kernels read their shared-memory limit on, and launch on, the
    # current device: make it padded's
    with torch.cuda.device(padded.device):
        if s is None:
            return _run_tiled(padded, px, py, n_iter, between)
        return _run_cluster(padded, px, py, n_iter, between, s)


rl_bands_separable.launches = 0
rl_bands_separable.launches_wide = 0
rl_bands_separable.launches_tiled = 0
rl_bands_separable.wide_blocks = []


def rl_bands_separable_grouped(padded: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                               n_iter, *, group: int = 2) -> torch.Tensor:
    """The cluster kernel with ``group`` bands a cluster: the same operands
    and function as :func:`rl_bands_separable`, ``B % group == 0``. On a CPU
    tensor it runs :func:`rl_bands_separable_plain`; on any other it raises
    ``ValueError`` before any launch where ``group`` bands of the canvas do
    not fit :data:`MAX_CLUSTER` CTAs (:func:`grouped_fits`).
    ``rl_bands_separable_grouped.launches`` counts its kernel launches (one
    per non-empty checkpoint group, as :func:`launch_schedule`)."""
    n_iter = _check(padded, px, py, n_iter)
    b, h2, w2 = padded.shape
    if group < 1 or b % group != 0:
        raise ValueError(f"B = {b} is not a multiple of group = {group}")
    if padded.device.type == "cpu":
        return rl_bands_separable_plain(padded, px, py, n_iter)
    s = cluster_size_for(h2, w2, px.shape[1], py.shape[1], group)
    if s is None:
        raise ValueError(f"{group} bands of a {h2}x{w2} canvas with {px.shape[1]}x"
                         f"{py.shape[1]} taps do not fit a cluster of {MAX_CLUSTER} CTAs")
    if padded.device.type != "cuda":
        raise ValueError(f"no Richardson-Lucy kernel for device {padded.device}")
    with torch.cuda.device(padded.device):
        return _run_cluster(padded, px, py, n_iter, None, s, group)


rl_bands_separable_grouped.launches = 0


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    """The card's SMs, for :func:`launch_plan`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _run_cluster(padded, px, py, n_iter, between: Between, s: int,
                 group: Optional[int] = None):
    """The cluster route's launches (``thz_rlsep_cluster``, or
    ``thz_rlsep_wide`` where :func:`launch_plan` says so; counted by
    ``rl_bands_separable.launches``) or, with ``group``, the grouped mode's
    (``thz_rlsep_grouped``, ``group`` bands a cluster, counted by
    ``rl_bands_separable_grouped.launches``)."""
    lib = kernels.load("rlsep_cluster")
    b, h2, w2 = padded.shape
    kr, kc = px.shape[1], py.shape[1]
    # bands by descending trip count: a launch from i0 runs the first nb
    order_host = np.argsort(-n_iter, kind="stable")
    order = torch.as_tensor(order_host.astype(np.int32), device=padded.device)
    n_iter_dev = torch.as_tensor(n_iter.astype(np.int32), device=padded.device)
    u = padded.clone()
    inputs = (padded.data_ptr(), px.data_ptr(), py.data_ptr(), order.data_ptr(),
              n_iter_dev.data_ptr())
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    if group is None:
        counter = rl_bands_separable
        plan = launch_plan(n_iter, h2, w2, kr, kc, s, _sms(padded.device.index))
        counter.wide_blocks = [blocks for *_, blocks in plan if blocks]
    else:
        counter = rl_bands_separable_grouped
        plan = [(i0, i1, nb, ()) for i0, i1, nb in launch_schedule(n_iter)]
    wide_nb = max((nb for _, _, nb, blocks in plan if blocks), default=0)
    if wide_nb:
        rel = torch.empty((wide_nb, h2, w2), dtype=torch.float32, device=padded.device)
        arrivals = torch.zeros(MAX_WIDE, dtype=torch.int32, device=padded.device)
        base = np.zeros(MAX_WIDE, np.uint32)  # each band barrier's arrivals so far
    steps = iter(plan)
    spans = _groups(int(n_iter.max(initial=0)))
    for g, (i0, i1) in enumerate(spans):
        if between is not None and between(g, len(spans)):
            return None
        if i1 == i0:
            continue
        _, _, nb, blocks = next(steps)
        shape = (nb, i0, i1, b, h2, w2, kr, kc)
        if blocks:
            first = np.concatenate([[0], np.cumsum(blocks)]).astype(np.int32)
            err = lib.thz_rlsep_wide(u.data_ptr(), rel.data_ptr(), *inputs, arrivals.data_ptr(),
                                     *shape, first.ctypes.data, base.ctypes.data, stream)
            its = np.minimum(i1, n_iter[order_host[:nb]]) - i0
            base[:nb] += (2 * np.asarray(blocks) * its).astype(np.uint32)
            counter.launches_wide += 1
        elif group is None:
            err = lib.thz_rlsep_cluster(u.data_ptr(), *inputs, *shape, s, stream)
        else:
            err = lib.thz_rlsep_grouped(u.data_ptr(), *inputs, *shape, s, group, stream)
        kernels.check_launch(err, "rlsep_cluster")
        counter.launches += 1
    return u


def _run_tiled(padded, px, py, n_iter, between: Between):
    lib = kernels.load("rlsep")
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
            b, h2, w2, px.shape[1], py.shape[1], stream,
        )
        kernels.check_launch(err, "rlsep")
        rl_bands_separable.launches_tiled += 2 * (i1 - i0)
    return u
