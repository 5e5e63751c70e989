"""The Python parts of the redesigned Richardson-Lucy routes, on the CPU.

``csrc/rl2d_cluster.cu`` (the general 2-D recurrence on one thread-block
cluster) and the grouped mode of ``csrc/rlsep_cluster.cu`` (G bands a
cluster) run only on the card, where ``chip_smoke.py`` holds them against
the plain versions and the cluster route. What surrounds them is plain
Python and is checked here: the 2-D routing rule and the layout mirror
(with the kernel's tap tiles, shifted bank, column halos and row windows
replayed in numpy against the plain correlation), the grouped mode's
shared-memory mirror, fit rule and slot plan, and that a group past the
fit is refused before any library is loaded.
"""

import numpy as np
import pytest
import torch

from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops import rl2d, rlsep

#: the reference Apply's canvas and profile lengths (pad_r 23, pad_c 28) and
#: trip counts (tests/test_torch_rlsep_cluster.py)
APPLY_CANVAS = (246, 256, 47, 57)
APPLY_N_ITER = np.array([408, 336, 277, 228, 188, 154, 127, 104, 85, 70, 57, 46, 38, 30, 24,
                         20, 16, 12, 9, 7, 5, 4, 2, 1, 1])


# ------------------------------------------------------------ rl2d routing
@pytest.mark.parametrize("h2,w2,kr,kc,expected", [
    (246, 256, 9, 9, ("cluster", 16)),     # band 0's canvas, 9x9: the smoke's case
    (246, 256, 47, 57, ("tiled", None)),   # an Apply band's outer product: 2679 taps
    (11, 70, 5, 7, ("cluster", 11)),       # fewer rows than 16: one CTA a row
    (37, 45, 16, 16, ("cluster", 16)),     # 256 taps: the crossover itself
    (37, 45, 17, 15, ("cluster", 16)),     # 255 taps
    (37, 45, 17, 17, ("tiled", None)),     # 289 taps
    (4000, 4000, 9, 9, ("tiled", None)),   # no 16 CTAs hold the image
    (1, 1, 1, 1, ("cluster", 1)),
])
def test_route_for(h2, w2, kr, kc, expected):
    assert rl2d.route_for(h2, w2, kr, kc) == expected
    if expected[0] == "cluster":
        assert rl2d.cluster_fits(h2, w2, kr, kc, expected[1])


def test_route_follows_the_crossover_constant(monkeypatch):
    monkeypatch.setattr(rl2d, "CLUSTER_MAX_TAPS", 0)
    assert rl2d.route_for(246, 256, 9, 9) == ("tiled", None)
    monkeypatch.setattr(rl2d, "CLUSTER_MAX_TAPS", 10_000)
    assert rl2d.route_for(246, 256, 47, 57) == ("cluster", 16)


def test_route_edge_by_size():
    """Where the image outgrows 16 CTAs' shared memory the rule switches to
    the tiled route, and a larger cluster never needs more bytes."""
    fits = [h for h in range(200, 3000, 50) if rl2d.route_for(h, h, 9, 9)[0] == "cluster"]
    edge = max(fits)
    assert fits == list(range(200, edge + 1, 50))
    assert rl2d.cluster_layout(edge, edge, 9, 9, 16)["bytes"] <= rlsep.SMEM_PER_BLOCK
    assert rl2d.cluster_layout(edge + 50, edge + 50, 9, 9, 16)["bytes"] > rlsep.SMEM_PER_BLOCK
    for s in range(1, 16):
        assert rl2d.cluster_layout(edge, edge, 9, 9, s)["bytes"] >= \
            rl2d.cluster_layout(edge, edge, 9, 9, s + 1)["bytes"]


@pytest.mark.parametrize("shape", [(0, 5, 3, 3), (5, 5, 0, 3), (5, -1, 3, 3), (5, 5, 3, 0)])
def test_route_for_refuses_bad_shapes(shape):
    with pytest.raises(ValueError):
        rl2d.route_for(*shape)
    with pytest.raises(ValueError):
        rl2d.cluster_layout(*shape, 1)


@pytest.mark.parametrize("s", [0, 17, 41])
def test_cluster_fits_refuses_sizes_outside_the_range(s):
    assert not rl2d.cluster_fits(40, 30, 9, 9, s)
    assert rl2d.cluster_fits(40, 30, 9, 9, 16)


# ------------------------------------------------------- the layout mirror
def test_layout_at_band0_canvas():
    """By hand at 246x256, 9x9 taps, S = 16: 9x9 tiles (one), a left halo
    of 4 columns, 16 rows a slab, row stride 264 (the last window's 12
    floats from column 252), a halo window of 16 + 9 - 1 rows."""
    lay = rl2d.cluster_layout(246, 256, 9, 9, 16)
    assert (lay["tile"], lay["ntr"], lay["ntc"], lay["lh"]) == (9, 1, 1, 4)
    assert (lay["rows"], lay["ws"], lay["nwin"], lay["bank"]) == (16, 264, 24, 9 * 12)
    assert lay["bytes"] == 2 * 24 * 8 + 4 * (2 * 108 + 3 * 16 * 264 + 264)


@pytest.mark.parametrize("kc,tile,ntc", [(1, 9, 1), (4, 9, 1), (7, 9, 1), (9, 9, 1),
                                         (10, 8, 2), (11, 8, 2), (16, 8, 2), (17, 8, 3),
                                         (57, 8, 8)])
def test_tile_choice(kc, tile, ntc):
    """9x9 tiles where the shifted bank (kc + lh - kc // 2 columns) is at
    most 9 wide, else 8x8: every kc <= 9 takes the 9x9 tiles."""
    lay = rl2d.cluster_layout(40, 40, 5, kc, 4)
    assert (lay["tile"], lay["ntc"]) == (tile, ntc)
    assert lay["lh"] % 4 == 0 and lay["lh"] >= kc // 2
    assert kc + lay["lh"] - kc // 2 <= lay["ntc"] * lay["tile"]


def _slab(h2, s, q):
    base, rem = divmod(h2, s)
    return q * base + min(q, rem), base + (q < rem)


def _emulate_correlation(x, psf, s, mirrored):
    """The cluster kernel's correlation, replayed in numpy (f64) with its
    own index arithmetic: the bank in tiles of ``tile`` rows x ``tp``
    floats, shifted right by lh - kc // 2; each CTA's slab in rows of ``ws``
    floats with the image at column lh; each thread's 4 x 4 block walking its
    window rows, read as float4s from column j0 + tb * tile."""
    h2, w2 = x.shape
    kr, kc = psf.shape
    lay = rl2d.cluster_layout(h2, w2, kr, kc, s)
    t, lh, ws, ntr, ntc = lay["tile"], lay["lh"], lay["ws"], lay["ntr"], lay["ntc"]
    shift, nw = lh - kc // 2, -(-(4 + t - 1) // 4)
    bank = np.zeros((ntr, ntc, t, t))
    for ta in range(ntr):
        for tb in range(ntc):
            for a in range(t):
                for b in range(t):
                    ar, bc = ta * t + a, tb * t + b - shift
                    if ar < kr and 0 <= bc < kc:
                        bank[ta, tb, a, b] = (psf[kr - 1 - ar, kc - 1 - bc] if mirrored
                                              else psf[ar, bc])
    rows = np.zeros((h2, ws))
    rows[:, lh:lh + w2] = x
    zero = np.zeros(ws)
    out = np.full((h2, w2), np.nan)
    for q in range(s):
        lo, n = _slab(h2, s, q)
        nbc = -(-w2 // 4)
        for blk in range(-(-n // rl2d._ROWS) * nbc):
            i0, j0 = blk // nbc * rl2d._ROWS, blk % nbc * 4
            acc = np.zeros((rl2d._ROWS, 4))
            for ta in range(ntr):
                for tb in range(ntc):
                    col = j0 + tb * t
                    assert col % 4 == 0 and col + 4 * nw <= ws
                    for r in range(rl2d._ROWS + t - 1):
                        w = i0 + ta * t + r  # the halo window's row
                        assert w < lay["nwin"]
                        j = lo - kr // 2 + w
                        win = (rows[j] if 0 <= j < h2 else zero)[col: col + 4 * nw]
                        for i in range(rl2d._ROWS):
                            if 0 <= r - i < t:
                                acc[i] += [bank[ta, tb, r - i] @ win[c: c + t] for c in range(4)]
            for i in range(rl2d._ROWS):
                for c in range(4):
                    if i0 + i < n and j0 + c < w2:
                        out[lo + i0 + i, j0 + c] = acc[i, c]
    return out


@pytest.mark.parametrize("h2,w2,kr,kc,s", [
    (21, 26, 6, 4, 16),    # an even PSF: the window one sample below "SAME"
    (37, 45, 9, 9, 16),    # odd rows, a width no multiple of 4
    (11, 70, 5, 7, 11),    # fewer rows than 16
    (40, 33, 21, 3, 16),   # a reach of 10 rows past slabs of 2-3
    (30, 40, 13, 11, 8),   # 8x8 tiles, 2 x 2 of them
    (9, 17, 2, 10, 3),     # an even bank over 9 columns
    (13, 9, 1, 1, 4),
])
def test_layout_replays_the_plain_correlation(h2, w2, kr, kc, s):
    """With the mirror's layout the kernel's indexing computes exactly the
    plain version's correlation, plain and mirrored, and covers every
    output once."""
    rng = np.random.default_rng(h2 * 100 + kr)
    x = rng.uniform(0.2, 1.5, (h2, w2))
    psf = rng.uniform(0.0, 1.0, (kr, kc))
    for mirrored in (False, True):
        taps = (psf[::-1, ::-1] if mirrored else psf).tolist()
        ref = rl2d._correlate(torch.from_numpy(x), taps).numpy()
        got = _emulate_correlation(x, psf, s, mirrored)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------ the grouped mode
@pytest.mark.parametrize("shape", [APPLY_CANVAS, (558, 568, 47, 57), (40, 1100, 9, 1001),
                                   (37, 45, 5, 7), (5, 45, 5, 7)])
@pytest.mark.parametrize("s", [1, 5, 8, 16])
def test_grouped_bytes_at_group_1_are_the_cluster_routes(shape, s):
    assert rlsep.grouped_smem_bytes(*shape, s, 1) == rlsep.cluster_smem_bytes(*shape, s)
    assert rlsep.grouped_fits(*shape, s, 1) == rlsep.cluster_fits(*shape, s)
    assert rlsep.cluster_size_for(*shape, group=1) == rlsep.cluster_size_for(*shape)


def test_group_5_fits_the_apply_canvas_and_6_does_not():
    """One band needs ~58.8 KB a CTA at S = 16 and each further band ~35.5
    KB (its slabs, taps, row tables and reach; the strip and the zero row
    are shared): group 5 ~201 KB fits the 227 KB, group 6 ~236 KB does not."""
    one = rlsep.grouped_smem_bytes(*APPLY_CANVAS, 16, 1)
    per_band = rlsep.grouped_smem_bytes(*APPLY_CANVAS, 16, 2) - one
    rows, ws, nwin = 16, 257, 16 + 2 * 23 + 3 * 8
    assert per_band == 2 * nwin * 8 + 8 + 4 * (2 * 72 + 2 * 80 + 2 * rows * ws)
    for g in range(1, 9):
        assert rlsep.grouped_smem_bytes(*APPLY_CANVAS, 16, g) == one + (g - 1) * per_band
    assert rlsep.grouped_fits(*APPLY_CANVAS, 16, 5)
    assert not rlsep.grouped_fits(*APPLY_CANVAS, 16, 6)
    assert rlsep.cluster_size_for(*APPLY_CANVAS, group=5) == 16
    assert rlsep.cluster_size_for(*APPLY_CANVAS, group=6) is None


def test_no_group_past_the_kernels_limit():
    assert rlsep.grouped_fits(37, 45, 5, 7, 16, rlsep.MAX_GROUP)
    assert not rlsep.grouped_fits(37, 45, 5, 7, 16, rlsep.MAX_GROUP + 1)
    assert not rlsep.grouped_fits(37, 45, 5, 7, 16, 0)


@pytest.mark.parametrize("group", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n_iter", [APPLY_N_ITER, np.array([0, 17, 5]),
                                    np.array([40, 1, 0, 2, 40]), np.array([50, 50, 100, 0])])
def test_grouped_plan(n_iter, group):
    """Per launch of the cluster route's schedule: ceil(nb / G) clusters,
    cluster c holding slots c G .. c G + G - 1 of the descending order,
    together every band that still iterates, once; the first cluster
    holds the longest chains."""
    order = np.argsort(-n_iter, kind="stable")
    plan = rlsep.grouped_plan(n_iter, group)
    assert [(i0, i1) for i0, i1, _ in plan] == \
        [(i0, i1) for i0, i1, _ in rlsep.launch_schedule(n_iter)]
    for (i0, i1, clusters), (_, _, nb) in zip(plan, rlsep.launch_schedule(n_iter)):
        assert len(clusters) == -(-nb // group)
        assert all(1 <= len(c) <= group for c in clusters)
        assert [b for c in clusters for b in c] == order[:nb].tolist()
        assert all(n_iter[b] > i0 for c in clusters for b in c)
        assert n_iter[clusters[0][0]] == n_iter.max()


def test_apply_plan_at_group_5():
    plan = rlsep.grouped_plan(APPLY_N_ITER, 5)
    assert len(plan) == 9
    assert plan[0][2] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11, 12, 13, 14],
                          [15, 16, 17, 18, 19], [20, 21, 22, 23, 24]]
    assert plan[1][2] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10]]
    assert plan[-1][2] == [[0]]


def _meta_stack(b, h2, w2, kr, kc):
    return (torch.empty((b, h2, w2), device="meta"), torch.empty((b, kr), device="meta"),
            torch.empty((b, kc), device="meta"))


def test_grouped_past_the_fit_raises_before_any_library_load(monkeypatch):
    def no_load(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(kernels, "load", no_load)
    stack = _meta_stack(6, *APPLY_CANVAS)
    with pytest.raises(ValueError, match="do not fit"):
        rlsep.rl_bands_separable_grouped(*stack, np.full(6, 3), group=6)
    big = _meta_stack(9, 37, 45, 5, 7)
    with pytest.raises(ValueError, match="do not fit"):
        rlsep.rl_bands_separable_grouped(*big, np.full(9, 3), group=9)
    # a group that fits goes to a kernel, and a meta tensor has none
    with pytest.raises(ValueError, match="no Richardson-Lucy kernel"):
        rlsep.rl_bands_separable_grouped(*_meta_stack(5, *APPLY_CANVAS), np.full(5, 3), group=5)


def test_rl2d_on_meta_raises_before_any_library_load(monkeypatch):
    monkeypatch.setattr(kernels, "load", lambda name: (_ for _ in ()).throw(
        AssertionError(f"library {name} loaded")))
    for kr, kc in ((9, 9), (47, 57)):
        with pytest.raises(ValueError, match="no Richardson-Lucy kernel"):
            rl2d.richardson_lucy_direct(torch.empty((246, 256), device="meta"),
                                        torch.empty((kr, kc), device="meta"), 3)


def test_grouped_cpu_path_is_the_plain_version():
    rng = np.random.default_rng(4)
    padded = rng.uniform(0.5, 2.0, (5, 20, 30)).astype(np.float32)
    px = rng.uniform(0.1, 0.4, (5, 7)).astype(np.float32)
    py = rng.uniform(0.1, 0.4, (5, 3)).astype(np.float32)
    n_iter = np.array([6, 0, 3, 6, 1])
    t = [torch.from_numpy(a) for a in (padded, px, py)]
    before = rlsep.rl_bands_separable_grouped.launches
    got = rlsep.rl_bands_separable_grouped(*t, n_iter, group=5)
    assert torch.equal(got, rlsep.rl_bands_separable_plain(*t, n_iter))
    assert rlsep.rl_bands_separable_grouped.launches == before


def test_sources_are_registered():
    assert {"rl2d", "rl2d_cluster", "rlsep", "rlsep_cluster"} <= set(kernels.SOURCES)
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").exists()
