"""The cluster route of the separable Richardson-Lucy wrapper, on the CPU.

``csrc/rlsep_cluster.cu`` runs only on the card (``chip_smoke.py`` holds it
against the plain version there). What surrounds it is plain Python and is
checked here: the launch schedule (one launch per non-empty checkpoint
group), the row split of a band's canvas over the CTAs of a cluster and
the ranks its halo reaches, the shared-memory size and the routing rule
that picks the cluster or the half-iteration kernel from the shapes, the
plan that sends late launches to the wide route and splits its blocks, the
host's launch loop against a stand-in for the library (plain PyTorch behind
the same C entry points), and that on a CPU tensor ``rl_bands_separable``
is still the plain version, against the JAX package's Pallas kernel in
interpret mode.
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thz_image_explorer_tpu.ops import deconvolution as jdec
from thz_image_explorer_tpu.ops.pallas_rl import rl_bands_separable as jax_rl_bands
from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops import rlsep

#: the reference Apply's trip counts (200x200 scan, dx = dy = 0.5 mm, the
#: synthetic PSF of chip_smoke.py, default parameters)
APPLY_N_ITER = np.array([408, 336, 277, 228, 188, 154, 127, 104, 85, 70, 57, 46, 38, 30, 24,
                         20, 16, 12, 9, 7, 5, 4, 2, 1, 1])
#: its canvas and profile lengths (pad_r 23, pad_c 28)
APPLY_CANVAS = (246, 256, 47, 57)


# ------------------------------------------------------------ the schedule
def test_apply_schedule_is_nine_launches():
    sched = rlsep.launch_schedule(APPLY_N_ITER)
    assert APPLY_N_ITER.sum() == 2249
    assert sched == [(0, 50, 25), (50, 100, 11), (100, 150, 8), (150, 200, 6), (200, 250, 4),
                     (250, 300, 3), (300, 350, 2), (350, 400, 1), (400, 408, 1)]


@pytest.mark.parametrize("n_iter", [APPLY_N_ITER, np.array([0, 17, 5]), np.array([3]),
                                    np.array([50, 50, 100, 0]), np.array([0, 0])])
def test_schedule_runs_each_band_its_iterations(n_iter):
    """Per launch, the first nb bands of the descending order are exactly
    those still iterating, each runs min(i1, n_iter) - i0 > 0 iterations,
    and over all launches every band runs n_iter[b]."""
    order = np.argsort(-n_iter, kind="stable")
    done = np.zeros_like(n_iter)
    sched = rlsep.launch_schedule(n_iter)
    assert len(sched) == -(-int(n_iter.max()) // rlsep.GROUP)
    for i0, i1, nb in sched:
        assert i1 - i0 <= rlsep.GROUP and nb >= 1
        assert set(order[:nb]) == set(np.flatnonzero(n_iter > i0))
        for b in order[:nb]:
            assert done[b] == i0
            done[b] += min(i1, n_iter[b]) - i0
    np.testing.assert_array_equal(done, n_iter)


def test_schedule_follows_the_checkpoint_size(monkeypatch):
    monkeypatch.setattr(rlsep, "GROUP", 4)
    assert rlsep.launch_schedule(np.array([6, 2, 0, 4])) == [(0, 4, 3), (4, 6, 1)]


# ------------------------------------------------------------ the row split
@pytest.mark.parametrize("s", [1, 2, 8, 16])
@pytest.mark.parametrize("h2,reach", [(246, 23), (37, 2), (558, 23), (16, 7), (40, 20)])
def test_cluster_rows_cover_the_canvas_once(s, h2, reach):
    rows = rlsep.cluster_rows(h2, s, reach)
    assert len(rows) == s
    owner = np.full(h2, -1)
    for q, (lo, hi, q_lo, q_hi) in enumerate(rows):
        assert hi > lo and (owner[lo:hi] == -1).all()
        owner[lo:hi] = q
    assert (owner >= 0).all() and (np.diff(owner) >= 0).all()  # contiguous, in rank order
    sizes = [hi - lo for lo, hi, _, _ in rows]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    for q, (lo, hi, q_lo, q_hi) in enumerate(rows):
        # the halo's ranks: the owners of every canvas row within the reach
        window = owner[max(lo - reach, 0):min(hi + reach, h2)]
        assert (q_lo, q_hi) == (window.min(), window.max())
        assert q_lo <= q <= q_hi


@pytest.mark.parametrize("s", [2, 8, 16])
def test_halo_reaches_past_one_slab(s):
    """At the Apply's canvas a reach of 23 rows is more than a slab of
    ceil(246 / s) rows at 16 CTAs: a middle CTA's halo then spans more
    than its two neighbours."""
    rows = rlsep.cluster_rows(246, s, 23)
    q = s // 2
    lo, hi, q_lo, q_hi = rows[q]
    spans_far = q - q_lo > 1 or q_hi - q > 1
    assert spans_far == (23 > 246 // s)


def test_cluster_rows_refuse_more_ctas_than_rows():
    with pytest.raises(ValueError):
        rlsep.cluster_rows(5, 8, 1)
    with pytest.raises(ValueError):
        rlsep.cluster_rows(5, 0, 1)


# ------------------------------------------------------------ the routing rule
def test_smem_bytes_at_the_apply_canvas():
    """The layout of csrc/rlsep_cluster.cu, by hand at 246x256, 47x57 taps,
    S = 16: 16 rows a slab, row stride 257 (= 1 mod 32), a 86-row halo
    window, the strip of 16 + 1 floats x (2*28 + 256 + 16) columns."""
    rows, ws, hr, hc = 16, 257, 23, 28
    nwin = rows + 2 * hr + 3 * 8
    taps = 2 * 72 + 2 * 80
    floats = taps + 2 * rows * ws + (2 * hc + 256 + 16) * 17 + ws
    assert rlsep.cluster_smem_bytes(*APPLY_CANVAS, 16) == 2 * nwin * 8 + 4 * floats + 8
    assert rlsep.cluster_smem_bytes(*APPLY_CANVAS, 16) < rlsep.cluster_smem_bytes(
        *APPLY_CANVAS, 8) < rlsep.SMEM_PER_BLOCK


@pytest.mark.parametrize("h2,w2,kr,kc,expected", [
    (246, 256, 47, 57, 16),     # the reference Apply
    (558, 568, 47, 57, 16),     # the 512x512 scan's Apply: fits at 16
    (720, 720, 47, 57, None),   # over the limit: the half-iteration route
    (40, 1100, 9, 1001, 16),    # a 1001-tap column reach
    (5, 45, 5, 7, 5),           # fewer rows than 16: one CTA a row
    (37, 45, 5, 7, 16),
])
def test_cluster_size_for(h2, w2, kr, kc, expected):
    assert rlsep.cluster_size_for(h2, w2, kr, kc) == expected
    if expected is not None:
        assert rlsep.cluster_fits(h2, w2, kr, kc, expected)


def test_routing_edge():
    """Where the canvas outgrows 16 CTAs' shared memory the rule switches
    to the half-iteration route, and a larger S never needs more bytes."""
    kr, kc = APPLY_CANVAS[2:]
    fits = [h for h in range(540, 640, 2) if rlsep.cluster_size_for(h, h + 10, kr, kc)]
    edge = max(fits)
    assert fits == list(range(540, edge + 1, 2))  # one contiguous run up to the edge
    assert rlsep.cluster_smem_bytes(edge, edge + 10, kr, kc, 16) <= rlsep.SMEM_PER_BLOCK
    assert rlsep.cluster_smem_bytes(edge + 2, edge + 12, kr, kc, 16) > rlsep.SMEM_PER_BLOCK
    for s in range(1, 16):
        assert rlsep.cluster_smem_bytes(edge, edge + 10, kr, kc, s) >= \
            rlsep.cluster_smem_bytes(edge, edge + 10, kr, kc, s + 1)


def test_preferred_size_wins_where_it_fits(monkeypatch):
    monkeypatch.setattr(rlsep, "PREFERRED_CLUSTER", 8)
    assert rlsep.cluster_size_for(*APPLY_CANVAS) == 8
    # 558x568 needs 15 CTAs: the smallest size that holds it
    assert rlsep.cluster_size_for(558, 568, 47, 57) == 15
    assert not rlsep.cluster_fits(558, 568, 47, 57, 14)


# ------------------------------------------------------------ the CPU path
def _tall_case():
    """Three bands on a 40x30 canvas, a row reach of 10 (> 40 / 16 rows a
    slab at 16 CTAs), asymmetric taps, a pre-flipped band and a band with
    no iterations; each image positive inside a zero margin."""
    rng = np.random.default_rng(21)
    padded = np.zeros((3, 40, 30), np.float32)
    padded[0, 3:37, 2:28] = rng.uniform(0.2, 1.5, (34, 26))
    padded[1, 1:39, 4:26] = rng.uniform(0.2, 1.5, (38, 22))
    padded[2, 5:35, 1:29] = rng.uniform(0.2, 1.5, (30, 28))
    x = np.arange(-10, 11, dtype=np.float32)
    y = np.arange(-3, 4, dtype=np.float32)
    px = np.stack([np.exp(-(x - 1.5) ** 2 / 20), np.exp(-(x + 2.0) ** 2 / 8),
                   np.exp(-(x - 0.3) ** 2 / 30)]).astype(np.float32)
    py = np.stack([np.exp(-(y + 0.8) ** 2 / 2), np.exp(-(y - 1.1) ** 2 / 3),
                   np.exp(-(y + 0.2) ** 2 / 1.5)]).astype(np.float32)
    px[1] = px[1, ::-1]
    return padded, px, py, np.array([7, 0, 4], np.int32)


def test_cpu_path_is_the_plain_version_and_matches_jax():
    padded, px, py, n_iter = _tall_case()
    _, h2, w2 = padded.shape
    rs = np.stack([jdec._banded_matrix(v, h2) for v in px])
    cs = np.stack([jdec._banded_matrix(v, w2) for v in py])
    ref = np.asarray(jax_rl_bands(jnp.asarray(padded), jnp.asarray(rs), jnp.asarray(cs),
                                  jnp.asarray(n_iter), interpret=True))
    t = [torch.from_numpy(a.copy()) for a in (padded, px, py)]
    got = rlsep.rl_bands_separable(*t, n_iter)
    assert torch.equal(got, rlsep.rl_bands_separable_plain(*t, n_iter))
    # the JAX test's tolerance: its interpret kernel splits operands into
    # bf16 pairs
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), padded[1])


@pytest.mark.parametrize("s", [0, 17, 41])
def test_cluster_fits_refuses_sizes_outside_the_range(s):
    """1..16 CTAs and no more than the canvas's rows (40 here)."""
    assert not rlsep.cluster_fits(40, 30, 21, 7, s)
    assert rlsep.cluster_fits(40, 30, 21, 7, 16)


def test_cuda_route_raises_without_a_card_or_toolchain(monkeypatch, tmp_path):
    """No fallback: a tensor on any device but the CPU goes to a kernel or
    raises, and a cluster kernel that cannot be built raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    assert "rlsep_cluster" in kernels.SOURCES
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("rlsep_cluster")
    p, px, py = (torch.from_numpy(a.copy()).to("meta") for a in _tall_case()[:3])
    with pytest.raises(ValueError, match="no Richardson-Lucy kernel"):
        rlsep.rl_bands_separable(p, px, py, np.array([1, 1, 1]))


# ------------------------------------------------------------ the wide route
#: the card the plans are made for: an H100 SXM's SMs
SMS = 132
#: the Apply canvases: 200² and 512² scans, and the PSF tool's PSF on the
#: 200² scan
CANVASES = [(246, 256, 47, 57), (558, 568, 47, 57), (228, 230, 47, 57)]


def _plan(h2, w2, kr, kc, n_iter=APPLY_N_ITER, share=None):
    """The plan at the package's crossover, or at ``share``: -1 sends every
    launch that can be split and cuts passes to the wide route."""
    if share is None:
        return rlsep.launch_plan(n_iter, h2, w2, kr, kc, 16, SMS)
    kept = rlsep.WIDE_IDLE_SHARE
    try:
        rlsep.WIDE_IDLE_SHARE = share
        return rlsep.launch_plan(n_iter, h2, w2, kr, kc, 16, SMS)
    finally:
        rlsep.WIDE_IDLE_SHARE = kept


def test_wide_smem_bytes_at_the_512_canvas():
    """``wide_layout`` of csrc/rlsep_cluster.cu by hand at 558x568, 47x57
    taps, a 16-row slab: two tables of 16 + 46 + 24 = 86 row pointers, the
    taps, 16 + 46 staged rows of 568 floats and 4 of slack, the strip of
    (56 + 568 + 16) x 17 floats, one zero row; reach[2] and the staging
    mbarrier."""
    taps = 2 * 72 + 2 * 80
    floats = taps + 62 * 568 + 4 + 640 * 17 + 568
    assert rlsep.wide_smem_bytes(558, 568, 47, 57, 16) == 2 * 86 * 8 + 4 * floats + 16
    assert rlsep.wide_smem_bytes(558, 568, 47, 57, 34) <= rlsep.SMEM_PER_BLOCK < \
        rlsep.wide_smem_bytes(558, 568, 47, 57, 35)


@pytest.mark.parametrize("canvas", CANVASES, ids=["apply200", "apply512", "psf_tool"])
def test_plan_keeps_the_schedule_and_its_cluster_launches(canvas):
    """One plan entry per launch of the schedule, the same (i0, i1, nb); a
    launch goes wide only where at most MAX_WIDE bands iterate and their
    clusters would leave more than the crossover's share of the SMs idle."""
    h2 = canvas[0]
    plan = _plan(*canvas)
    assert [p[:3] for p in plan] == rlsep.launch_schedule(APPLY_N_ITER)
    for i0, i1, nb, blocks in plan:
        idle = 1 - nb * 16 / SMS
        split = rlsep.wide_blocks([min(i1, n) - i0 for n in APPLY_N_ITER[:nb]], *canvas, SMS)
        if nb > rlsep.MAX_WIDE or idle <= rlsep.WIDE_IDLE_SHARE or split is None or \
                rlsep.passes(-(-h2 // max(split))) >= rlsep.passes(-(-h2 // 16)):
            assert blocks == ()
        else:
            assert blocks == split
    # the first launches, 25 and 11 bands, stay on the cluster route
    assert plan[0][3] == plan[1][3] == ()


@pytest.mark.parametrize("canvas", CANVASES, ids=["apply200", "apply512", "psf_tool"])
def test_wide_splits_fit_the_card(canvas):
    """Every split ``wide_blocks`` makes for a launch of the schedule: one
    share per band, Σ blocks within the SMs (one block an SM: all
    resident), no slab thinner than one strip, every slab within one
    block's shared memory, and the shares in the order of the bands'
    iterations left."""
    h2, w2, kr, kc = canvas
    wide = []
    for i0, i1, nb in rlsep.launch_schedule(APPLY_N_ITER):
        blocks = rlsep.wide_blocks([min(i1, n) - i0 for n in APPLY_N_ITER[:nb]], *canvas, SMS)
        assert (blocks is None) == (nb > rlsep.MAX_WIDE or (h2 == 558 and nb == 8)), (nb, blocks)
        if blocks:
            wide.append((i0, i1, nb, blocks))
    for i0, i1, nb, blocks in wide:
        assert len(blocks) == nb and sum(blocks) <= SMS
        assert all(1 <= b and h2 // b >= rlsep.WIDE_MIN_ROWS for b in blocks)
        assert rlsep.wide_smem_bytes(h2, w2, kr, kc, -(-h2 // min(blocks))) <= \
            rlsep.SMEM_PER_BLOCK
        iters = [min(i1, n) - i0 for n in APPLY_N_ITER[:nb]]
        assert list(blocks) == sorted(blocks, reverse=True)
        assert all(b >= b_next for (b, it), (b_next, it_next) in
                   zip(zip(blocks, iters), zip(blocks[1:], iters[1:])) if it >= it_next)


def test_512_apply_tail_goes_wide():
    """At the 512² Apply every launch of six bands or fewer takes the wide
    route, band 0 on more SMs than a cluster of 16 holds and in fewer passes
    a half than a cluster's CTA makes (three); the launches of 25, 11 and 8
    bands keep the cluster route (8 bands at 17 blocks each, the fewest
    whose slabs fit, would need 136 SMs)."""
    plan = _plan(558, 568, 47, 57)
    assert [(nb, blocks) for _, _, nb, blocks in plan] == [
        (25, ()), (11, ()), (8, ()), (6, (24, 24, 24, 23, 20, 17)), (4, (37, 37, 37, 20)),
        (3, (51, 51, 28)), (2, (69, 55)), (1, (69,)), (1, (69,))]
    assert rlsep.passes(-(-558 // 16)) == 3 and rlsep.passes(-(-558 // 37)) == 1


@pytest.mark.parametrize("canvas", [CANVASES[0], CANVASES[2]], ids=["apply200", "psf_tool"])
def test_one_pass_canvases_keep_the_cluster_route(canvas):
    """Where a cluster's CTA already holds its slab in one pass (246 and
    228 rows over 16 CTAs), no split saves a pass: every launch keeps the
    cluster route, whatever the crossover."""
    assert rlsep.passes(-(-canvas[0] // 16)) == 1
    for share in (None, -1.0):
        assert all(blocks == () for *_, blocks in _plan(*canvas, share=share))


def test_seven_bands_keep_the_cluster_route_at_512():
    """Seven bands of 50 iterations at the 512² canvas (a rank's subset of a
    sharded Apply can hold seven): their clusters hold 112 of 132 SMs, under
    the crossover's idle share, so the launch keeps the cluster route, where
    it was measured 17 % faster than the split of 18 blocks a band that the
    wide route would take; six bands go wide."""
    seven = np.full(7, 50)
    assert 1 - 7 * 16 / SMS <= rlsep.WIDE_IDLE_SHARE < 1 - 6 * 16 / SMS
    assert _plan(558, 568, 47, 57, n_iter=seven) == [(0, 50, 7, ())]
    assert _plan(558, 568, 47, 57, n_iter=seven, share=-1.0) == [(0, 50, 7, (18,) * 7)]
    assert _plan(558, 568, 47, 57, n_iter=np.full(6, 50)) == [(0, 50, 6, (22,) * 6)]


def test_sharded_subsets_plan_from_their_own_bands():
    """A rank's band subset (``band_split``) plans from its own trip counts:
    at the 512² canvas the last rank of 2 runs band 1 alone from iteration
    250 on, on the wide route, where the whole Apply's plan has 3 bands."""
    from thz_image_explorer_tpu_torch.ops.deconvolution import band_split

    sub = APPLY_N_ITER[band_split(APPLY_N_ITER, 2)[1]]
    plan = rlsep.launch_plan(sub, 558, 568, 47, 57, 16, SMS)
    assert [p[:3] for p in plan] == rlsep.launch_schedule(sub)
    assert [(nb, blocks) for i0, _, nb, blocks in plan if i0 >= 250] == [
        (1, (69,)), (1, (69,))]


@pytest.mark.parametrize("iters,expected", [
    ([50], (69,)),                       # one band: as many strips as the canvas has
    ([50, 36], (69, 55)),
    ([50, 50, 27], (51, 51, 28)),
    ([50, 50, 50, 28], (37, 37, 37, 20)),
    ([50, 4], (69, 17)),                 # the floor a slab of shared memory sets
])
def test_wide_blocks_in_proportion_to_iterations(iters, expected):
    assert rlsep.wide_blocks(iters, 558, 568, 47, 57, SMS) == expected


def test_wide_blocks_trim_the_largest_shares_and_refuse_what_cannot_fit():
    # eight bands at the 512² canvas need 17 blocks each (33-row slabs):
    # 136 > 132 SMs
    assert rlsep.wide_blocks([50] * 8, 558, 568, 47, 57, SMS) is None
    blocks = rlsep.wide_blocks([50, 50, 50, 50, 50, 4], 558, 568, 47, 57, SMS)
    assert sum(blocks) == SMS and min(blocks) == 17 and max(blocks) - min(blocks[:5]) <= 1
    assert rlsep.wide_blocks([50] * (rlsep.MAX_WIDE + 1), 246, 256, 47, 57, SMS) is None
    assert rlsep.wide_blocks([5], 7, 40, 3, 3, SMS) is None  # fewer rows than a strip


def test_signatures_declare_the_wide_route():
    table = kernels.SIGNATURES["rlsep_cluster"]
    restype, argtypes = table["thz_rlsep_wide"]
    assert restype is ctypes.c_int and len(argtypes) == 19
    assert table["thz_rlsep_wide_smem"] == (ctypes.c_longlong, [ctypes.c_int] * 5)
    assert table["thz_rlsep_cluster"][1][-1] is ctypes.c_void_p  # the stream, as the wide's


def _floats(ptr, n):
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)))


def _ints(ptr, n, ctype=ctypes.c_int32):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


class _Library:
    """``csrc/rlsep_cluster.cu``'s two launches behind its C entry points,
    on CPU tensors: each reads the wrapper's pointers as host memory and
    runs its bands' iterations as ``rl_bands_separable_plain`` does, so the
    output equals the plain version bit for bit exactly when the host loop
    hands every band its iterations once, in order. The wide launch also
    holds the host's count of barrier arrivals to the counters it is given,
    and adds its own arrivals to them, as the kernel's blocks do."""

    def __init__(self):
        self.routes = []

    @staticmethod
    def _iterate(u, padded, px, py, order, n_iter, nb, i0, i1, b, h2, w2, kr, kc):
        u = _floats(u, b * h2 * w2).view(b, h2, w2)
        p = _floats(padded, b * h2 * w2).view(b, h2, w2)
        rs = rlsep.banded_matrix(_floats(px, b * kr).view(b, kr), h2)
        cs = rlsep.banded_matrix(_floats(py, b * kc).view(b, kc), w2)
        n_iter = _ints(n_iter, b)
        for band in _ints(order, b)[:nb]:
            ub = u[band]
            for _ in range(min(i1, int(n_iter[band])) - i0):
                rel = p[band] / (rs[band] @ ub @ cs[band].T + rlsep._EPS)
                ub = ub * (rs[band].T @ rel @ cs[band])
            u[band] = ub

    def thz_rlsep_cluster(self, u, padded, px, py, order, n_iter, nb, i0, i1, b, h2, w2, kr,
                          kc, s, stream):
        assert s == 16 and nb >= 1
        self.routes.append(("cluster", nb))
        self._iterate(u, padded, px, py, order, n_iter, nb, i0, i1, b, h2, w2, kr, kc)
        return 0

    def thz_rlsep_wide(self, u, rel, padded, px, py, order, n_iter, arrivals, nb, i0, i1, b,
                       h2, w2, kr, kc, first, base, stream):
        first = _ints(first, nb + 1)
        base = _ints(base, nb, ctypes.c_uint32)
        blocks = tuple(int(v) for v in np.diff(first))
        assert first[0] == 0 and 1 <= nb <= rlsep.MAX_WIDE
        n = _ints(n_iter, b)
        counts = _ints(arrivals, rlsep.MAX_WIDE, ctypes.c_uint32)
        for j, band in enumerate(_ints(order, b)[:nb]):
            assert base[j] == counts[j], (j, base[j], counts[j])
            counts[j] += 2 * blocks[j] * (min(i1, int(n[band])) - i0)
        self.routes.append(("wide", blocks))
        self._iterate(u, padded, px, py, order, n_iter, nb, i0, i1, b, h2, w2, kr, kc)
        return 0


@pytest.mark.parametrize("sms", [SMS, 114])
def test_launch_loop_runs_the_plan(monkeypatch, sms):
    """The wrapper's loop over the plan on a stand-in library, on a card of
    ``sms`` SMs (an H100 SXM's 132 or a PCIe card's 114): 9 launches of the
    Apply's trip counts on a small canvas (the plan is made for a 558-row
    one), ``launches`` 9, ``launches_wide`` and ``wide_blocks`` as
    the plan says, each route given its launches in order, the barrier
    counts carried from launch to launch, and the output the plain
    version's bit for bit."""
    lib = _Library()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(rlsep, "_sms", lambda _device: sms)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_a: types.SimpleNamespace(cuda_stream=0))
    # the plan at the 512² Apply's 558x568 canvas, the arithmetic on a small one
    real_plan = rlsep.launch_plan
    monkeypatch.setattr(rlsep, "launch_plan",
                        lambda n, *_a: real_plan(n, 558, 568, 47, 57, *_a[4:]))
    rng = np.random.default_rng(5)
    b = len(APPLY_N_ITER)
    padded = torch.from_numpy(rng.uniform(0.2, 1.0, (b, 12, 10)).astype(np.float32))
    px = torch.from_numpy(rng.uniform(0.0, 0.3, (b, 5)).astype(np.float32))
    py = torch.from_numpy(rng.uniform(0.0, 0.3, (b, 3)).astype(np.float32))
    n_iter = (APPLY_N_ITER // 8).astype(np.int64)  # 51, 42, ... : still 2 launches
    monkeypatch.setattr(rlsep, "GROUP", 6)         # ... made 9 by 6-iteration groups
    plan = rlsep.launch_plan(n_iter, 558, 568, 47, 57, 16, sms)
    assert len(plan) == 9
    before = rlsep.rl_bands_separable.launches, rlsep.rl_bands_separable.launches_wide
    seen = []
    got = rlsep._run_cluster(padded, px, py, n_iter, lambda g, t: seen.append((g, t)), 16)
    assert seen == [(g, 9) for g in range(9)]
    assert rlsep.rl_bands_separable.launches - before[0] == 9
    wide = [blocks for *_, blocks in plan if blocks]
    assert rlsep.rl_bands_separable.launches_wide - before[1] == len(wide) > 0
    assert rlsep.rl_bands_separable.wide_blocks == wide
    assert lib.routes == [("wide", blocks) if blocks else ("cluster", nb)
                          for _, _, nb, blocks in plan]
    want = rlsep.rl_bands_separable_plain(padded, px, py, n_iter)
    assert torch.equal(got, want)
