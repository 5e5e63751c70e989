"""The cluster route of the separable Richardson-Lucy wrapper, on the CPU.

``csrc/rlsep_cluster.cu`` runs only on the card (``chip_smoke.py`` holds it
against the plain version there). What surrounds it is plain Python and is
checked here: the launch schedule (one launch per non-empty checkpoint
group), the row split of a band's canvas over the CTAs of a cluster and
the ranks its halo reaches, the shared-memory size and the routing rule
that picks the cluster or the half-iteration kernel from the shapes, and
that on a CPU tensor ``rl_bands_separable`` is still the plain version,
against the JAX package's Pallas kernel in interpret mode.
"""

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
