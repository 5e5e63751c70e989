"""The work plans of the envelope and spectral-reduction kernels, on the CPU.

``csrc/envelope.cu`` and ``csrc/specred.cu`` cannot run here. Their work
plans are made in pure Python by their wrappers (``ops/envelope.py``,
``ops/specred.py``) and handed to the launches, and are tested here: every
trace, row and column is covered exactly once under the kernels' walks,
every bulk copy's address and size is a multiple of 16 bytes, the shared
memory fits a block, each route follows from the shapes alone, and every
shape the previous kernels took still fits. The chip smoke holds the built
libraries' layouts (``thz_*_smem``) and compiled shapes against these. Also
here: the contrast-2 premise of the envelope kernel (``torch.pow(q, 2.0)``
is ``q * q``, bit for bit), the plain envelope against the JAX package's
f32 XLA path, and the wrappers' refusal to run anything on a device that is
neither the CPU nor CUDA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thz_image_explorer_tpu.ops import voxel as jvox
from thz_image_explorer_tpu_torch import kernels
from thz_image_explorer_tpu_torch.ops import envelope as tenv
from thz_image_explorer_tpu_torch.ops import specred as tsr

SMEM = 232_448


# ------------------------------------------------------------ the envelope
@pytest.mark.parametrize("t,r,route,radius", [
    (777, 5, "plain", "registers"), (777, 9, "plain", "registers"),
    (1000, 9, "bulk", "registers"), (1024, 0, "bulk", "registers"),
    (1024, 9, "bulk", "registers"), (1024, 12, "bulk", "registers"),
    (1024, 13, "bulk", "generic"), (1024, 40, "bulk", "generic"),
    (4096, 9, "bulk", "registers"), (4096, 40, "bulk", "generic"),
    (20, 30, "bulk", "generic"), (9, 10, "plain", "registers"),
])
def test_envelope_route_follows_from_the_shapes(t, r, route, radius):
    p = tenv.plan(t, r)
    assert (p["route"], p["radius"]) == (route, radius)
    assert 0 < p["smem"] == tenv.layout_bytes(p["warps"], p["stages"], p["outs"], t, r) <= SMEM


def test_envelope_main_shape_takes_the_full_block():
    p = tenv.plan(1024, 9)
    assert (p["warps"], p["stages"], p["outs"]) == (tenv.WARPS, tenv.STAGES, 2)


@pytest.mark.parametrize("t,r", [(1024, 9), (1000, 40), (4096, 40), (20, 30), (16, 0),
                                 (12_000, 9), (29_000, 9)])
def test_envelope_bulk_copies_are_16_byte_multiples(t, r):
    """The kernel's carving of the plan's bytes: barriers rounded to 16,
    then per warp its input buffers (a bulk copy lands round4(r) floats in)
    and its output buffers (a bulk store starts there)."""
    assert t * 4 % 16 == 0  # the bulk route's copy and store size
    p = tenv.plan(t, r)
    sf, of = tenv.stage_floats(t, r), tenv.out_floats(t)
    base = -(-p["warps"] * p["stages"] * 8 // 16) * 16
    inputs, outputs = [], []
    for w in range(p["warps"]):
        mine = base + 4 * w * (p["stages"] * sf + p["outs"] * of)
        inputs += [mine + 4 * (s * sf + -(-r // 4) * 4) for s in range(p["stages"])]
        outputs += [mine + 4 * (p["stages"] * sf + b * of) for b in range(p["outs"])]
    assert base % 16 == 0 and sf % 4 == 0 and of % 4 == 0
    assert all(o % 16 == 0 for o in inputs + outputs)
    assert max(outputs + inputs) + 4 * t <= p["smem"]


@pytest.mark.parametrize("t,r", [(1024, 9), (777, 5), (20, 30), (1000, 40), (4096, 40)])
def test_envelope_buffers_hold_the_halos(t, r):
    """Each input buffer holds round4(r) zeros, the trace, and zeros up to
    where the last run's float4 window reaches (at least r), without
    reaching into the next buffer."""
    sf = tenv.stage_floats(t, r)
    lh = -(-r // 4) * 4
    runs = -(-t // tenv.RUN)
    last_window_end = (runs - 1) * tenv.RUN + -(-(lh + r + tenv.RUN) // 4) * 4
    assert last_window_end <= sf and sf >= lh + t + r and sf % 4 == 0


def test_envelope_long_traces_shrink_the_block():
    """A long trace gives up warps, then input buffers, then its output
    buffers (the envelope then goes to the output row); one that does not
    fit even then is refused before any launch."""
    shapes = [tenv.plan(t, 9) for t in (2048, 4096, 12_000, 16_000, 29_000, 40_000)]
    assert [(p["warps"], p["stages"], p["outs"]) for p in shapes] == \
        [(4, 2, 2), (3, 2, 2), (1, 2, 2), (1, 1, 2), (1, 1, 1), (1, 1, 0)]
    with pytest.raises(ValueError, match="does not fit"):
        tenv.plan(60_000, 9)


@pytest.mark.parametrize("r", [0, 1, 5, 9, 12, 13, 40, 1000, 14_527])
def test_envelope_takes_every_shape_the_previous_kernel_took(r):
    """The previous kernel held the taps and, per warp, p with its halos
    and the envelope: 4 (2r + 1) + 4 (2T + 2r) bytes for one warp. Every
    T that fit there fits here, from 1 up to its longest."""
    t_max = (SMEM - 4 * (2 * r + 1) - 8 * r) // 8
    for t in sorted({1, 2, 3, 15, 16, max(1, t_max - 1), t_max}):
        if t >= 1:
            p = tenv.plan(t, r)
            assert 0 < p["smem"] <= SMEM


@pytest.mark.parametrize("n,blocks_possible,warps", [(40_000, 264, 4), (1003, 264, 4), (7, 3, 4),
                                                     (64, 132, 1), (262_144, 396, 4)])
def test_envelope_warps_walk_every_trace_once(n, blocks_possible, warps):
    """The kernel's walk (warp g of the G in the grid takes g, g + G, ...)
    over the plan's blocks: every trace once, no warp without a trace, no
    wave tail."""
    g_total = tenv.blocks(n, warps, blocks_possible) * warps
    walks = [list(range(g, n, g_total)) for g in range(g_total)]
    assert sorted(i for w in walks for i in w) == list(range(n))
    assert tenv.blocks(n, warps, blocks_possible) <= blocks_possible
    assert g_total < n + warps  # the last block has a trace for its first warp
    assert max(map(len, walks)) - min(len(w) for w in walks if w) <= 1


def test_contrast_two_is_the_square_of_the_square():
    """The kernel takes q * q at contrast 2: torch.pow(q, 2.0) is the same,
    bit for bit, over 2**20 values (squares of normal, tiny and huge f32)."""
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.normal(size=2 ** 18), rng.normal(size=2 ** 18) * 1e-20,
                        rng.normal(size=2 ** 18) * 1e18, rng.uniform(-4, 4, 2 ** 18)])
    q = torch.from_numpy(v.astype(np.float32)) ** 2
    assert torch.equal(torch.pow(q, 2.0).view(torch.int32), (q * q).view(torch.int32))


@pytest.mark.parametrize("contrast", [0.0, 0.5, 1.3, 2.0])
def test_envelope_plain_matches_jax_xla(contrast):
    rng = np.random.default_rng(int(contrast * 10))
    data = (rng.normal(size=(6, 7, 96)) * rng.uniform(0.2, 1.5, (6, 7, 1))).astype(np.float32)
    data[1, 2] = 0.0
    taps = np.array([0.1, 0.5, 0.2, 0.05, 0.15, 0.3, 0.02], np.float32)  # asymmetric
    thr = 0.05
    ref, _ = jvox._voxel_opacities_impl(jnp.asarray(data), jnp.asarray(taps),
                                        np.float32(contrast), np.float32(thr), 3, False)
    got = tenv.envelope_plain(torch.from_numpy(data.reshape(-1, 96)), taps, contrast, thr)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(-1, 96), atol=2e-5, rtol=0)


# ---------------------------------------------------- the spectral reduction
def _tiles(n, p):
    """The kernel's tiles of each row range (range q takes tiles
    q * n_tiles // ranges up to the next range's first): first row, rows,
    and the bulk copy's byte offset and bytes (the tile's whole row pairs,
    none on the wide route)."""
    rows, n_tiles, ranges = p["rows"], p["n_tiles"], p["ranges"]
    out = []
    for q in range(ranges):
        tiles = []
        for t in range(q * n_tiles // ranges, (q + 1) * n_tiles // ranges):
            r0, k = t * rows, min(rows, n - t * rows)
            pairs = 0 if p["wide"] else k & ~1
            tiles.append(dict(row=r0, rows=k, pairs=pairs, offset=r0 * p["f"] * 8,
                              bytes=pairs * p["f"] * 8))
        out.append(tiles)
    return out


@pytest.mark.parametrize("f", [33, 129, 513, 1025, 2049])
@pytest.mark.parametrize("n", [1, 2, 7, 1009, 40_000, 40_001])
def test_specred_bulk_copies_are_whole_row_pairs(n, f):
    p = dict(tsr.plan(n, f, 5, 264), f=f)
    assert not p["wide"] and p["rows"] % 2 == 0
    tiles = [t for rng in _tiles(n, p) for t in rng]
    for t in tiles:
        assert t["row"] % 2 == 0 and t["offset"] % 16 == 0 and t["bytes"] % 16 == 0
    # only the spectrum's odd last row is read with plain loads
    assert [t["row"] + t["rows"] - 1 for t in tiles if t["rows"] > t["pairs"]] == \
        ([n - 1] if n % 2 else [])
    # every row in exactly one tile, the tiles in order
    assert [r for t in tiles for r in range(t["row"], t["row"] + t["rows"])] == list(range(n))


@pytest.mark.parametrize("n,f,m,blocks", [(40_000, 513, 5, 264), (262_144, 513, 5, 264),
                                          (1009, 33, 1, 396), (4099, 129, 16, 264),
                                          (2053, 1025, 3, 132), (3001, 513, 16, 132),
                                          (5, 2049, 2, 132), (3001, 8193, 5, 260),
                                          (3, 524_289, 2, 264)])
def test_specred_plan_covers_rows_and_columns_once(n, f, m, blocks):
    """The kernel's items (row range, column chunk), taken by the blocks in
    turn (block b: items b, b + grid, ...), cover every row and column
    once; every block resident and busy."""
    p = dict(tsr.plan(n, f, m, blocks), f=f)
    items = p["ranges"] * p["chunks"]
    assert 1 <= p["grid"] <= min(blocks, items)
    taken = sorted(w for b in range(p["grid"]) for w in range(b, items, p["grid"]))
    assert taken == list(range(items))
    cols = [k for c in range(p["chunks"])
            for k in range(c * p["cw"], min(f, (c + 1) * p["cw"]))]
    assert cols == list(range(f)) and p["cw"] <= p["threads"] <= tsr.MAX_COLS
    assert p["threads"] % 32 == 0 and p["threads"] >= m * p["rows"]
    ranges = _tiles(n, p)
    assert all(len(r) >= 1 for r in ranges)
    assert [t["row"] for r in ranges for t in r] == list(range(0, n, p["rows"]))


@pytest.mark.parametrize("f,m,rows,stages,wide", [
    (513, 5, 4, 4, False), (513, 16, 4, 4, False), (33, 1, 4, 4, False),
    (1025, 3, 4, 4, False), (2049, 16, 4, 3, False), (4097, 5, 2, 2, False),
    (6000, 5, 2, 2, False), (8193, 5, 4, 2, True), (16_385, 16, 4, 2, True)])
def test_specred_smem_fits_and_shrinks_for_wide_spectra(f, m, rows, stages, wide):
    p = tsr.plan(100, f, m, 132)
    assert (p["rows"], p["stages"], p["wide"]) == (rows, stages, wide)
    assert 0 < p["smem"] == tsr.layout_bytes(f, p["cw"], m, rows, stages, wide) <= SMEM
    ts = p["cw"] + 1 if wide else f
    assert p["smem"] == (-(-stages * 8 // 16) * 16 + stages * rows * ts * 8
                         + 2 * rows * (p["cw"] + 1) * 8 + 2 * rows * (-(-m // 4) * 4) * 4)
    # the finish's scratch (a float a thread) lies past the barriers
    assert 4 * p["threads"] <= p["smem"] - -(-stages * 8 // 16) * 16


@pytest.mark.parametrize("f", [6_700, 8_193, 16_385, 524_289])
def test_specred_wide_spectra_take_the_chunk_columns(f):
    """Spectra whose whole rows do not fit a block (traces of more than
    ~13 300 samples) stage only each chunk's columns and the one left of
    them; any F fits, and more chunks than resident blocks share them."""
    for m in (1, 5, 16):
        assert tsr.layout_bytes(f, -(-f // -(-f // tsr.MAX_COLS)), m, 2, 2, False) > SMEM
        p = tsr.plan(40_000, f, m, 264)
        assert p["wide"] and p["smem"] <= SMEM and p["grid"] <= 264
        assert p["chunks"] * p["cw"] >= f > (p["chunks"] - 1) * p["cw"]


def test_specred_main_shape_is_one_chunk_one_launch():
    p = tsr.plan(40_000, 513, 5, 264)
    assert (p["chunks"], p["cw"], p["threads"], p["ranges"], p["grid"]) == (1, 513, 544, 264, 264)


# --------------------------------------------------------------- no fallback
def test_wrappers_raise_on_a_device_with_no_kernel(monkeypatch):
    """A tensor on neither the CPU nor CUDA raises; no plain version runs
    and no library is built or loaded."""
    def refuse(*a, **k):
        raise AssertionError("no plain version and no library here")

    monkeypatch.setattr(tenv, "envelope_plain", refuse)
    monkeypatch.setattr(tsr, "spectral_reduction_sums_plain", refuse)
    monkeypatch.setattr(kernels, "load", refuse)
    before = tenv.envelope.launches, tsr.spectral_reduction_sums.launches
    flat = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="no envelope kernel"):
        tenv.envelope(flat, np.array([0.2, 0.5, 0.3], np.float32), 2.0, 0.1)
    spec = torch.zeros((8, 5), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="no spectral reduction"):
        tsr.spectral_reduction_sums(spec, torch.ones((2, 8), device="meta"))
    assert (tenv.envelope.launches, tsr.spectral_reduction_sums.launches) == before
