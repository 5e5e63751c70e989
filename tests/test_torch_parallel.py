"""The port's pixel-grid mesh (``thz_image_explorer_tpu_torch.parallel``)
against the JAX package and against its own unsharded functions, on the CPU.

* single process, no mesh: ``interactive_update`` and ``lean_update`` equal
  the JAX package's on a regular 16x16x64 and a ragged 30x22x64 scan (all
  stages on, averaging in Fourier space, downscales by 2 and 3), at the
  main path's tolerance (atol 5e-5, rtol 1e-4);
* the split rule: the rank grid is JAX ``make_mesh``'s, blocks tile ragged
  grids, a downscale by 3 or 7 of a grid neither divides gives each rank
  the mesh's block of the downscaled grid with the single device's values
  (ranks as threads of this process, their one exchange joined in memory),
  ``cube_sharding`` names JAX's placements;
* real multi-process runs: 2 (1x2) and 4 (2x2) ranks, one spawned process
  each, joined over gloo through a ``file://`` store
  (``tests/torch_parallel_worker.py``). Each rank opens only its block of
  the ragged scan file and runs the sharded update at scale 1, 2, 3 and 7
  (each output on the mesh's block of the output grid), the
  sharded Apply (and one cancelled on one rank), the sharded live view and
  a ``grid_gather`` round trip; the parent compares with the unsharded port
  (per-pixel outputs bit for bit, means within rtol 1e-5 / atol 1e-6, the
  Apply within 1e-5 * max) and with the JAX package (atol 5e-5 / rtol
  1e-4). The JAX side runs in the parent only;
* a one-rank gloo group in this process equals the single-device calls
  bit for bit (the card runs the same check over NCCL).
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as worker
from make_sample import synthetic_scan, write_scan_thz
from test_torch_deconv import synthetic_psf_arrays
from thz_image_explorer_tpu.data import make_cube as jax_make_cube
from thz_image_explorer_tpu.parallel import mesh as jax_mesh
from thz_image_explorer_tpu.parallel import step as jax_step
from thz_image_explorer_tpu_torch import convert
from thz_image_explorer_tpu_torch.data import make_cube
from thz_image_explorer_tpu_torch.io.dotthz import finalize_scan, open_scan_host
from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
from thz_image_explorer_tpu_torch.ops import deconvolution as dec
from thz_image_explorer_tpu_torch.ops import voxel
from thz_image_explorer_tpu_torch.parallel import mesh as pm
from thz_image_explorer_tpu_torch.parallel import step

#: the main path's tolerance, port vs JAX
ATOL, RTOL = 5e-5, 1e-4
#: sharded vs unsharded means (tests/test_parallel.py's)
MEAN_ATOL, MEAN_RTOL = 1e-6, 1e-5
#: a spawned run's limit: a hung collective fails its test, not the suite
SPAWN_TIMEOUT_S = 150.0


def _scan(w, h, n=64, seed=0):
    """The JAX parallel tests' pulse-plus-noise cube (tests/test_parallel.py)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(n) * 0.05).astype(np.float32)
    pulse = np.exp(-((t - 1.2) ** 2) / 0.1) * np.sin(2 * np.pi * 1.0 * t)
    data = (pulse[None, None, :] * rng.uniform(0.3, 1.0, (w, h, 1))
            + 0.01 * rng.normal(size=(w, h, n))).astype(np.float32)
    return t, data


CONFIGS = {
    "all_stages": dict(td_before_active=True, fd_active=True, notch_active=True,
                       td_after_active=True),
    "avg_in_fourier": dict(fd_active=True, notch_active=True, avg_in_fourier_space=True),
    "scale2": dict(scale=2, fd_active=True, notch_active=True),
    "scale3": dict(scale=3, td_before_active=True, td_after_active=True),
}
CUBE_FIELDS = ("data", "fft", "amplitudes", "phases", "avg_data", "avg_fft", "avg_signal_fft",
               "avg_phase_fft")


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _phase_close(got, want, what=""):
    """Phase means are cumsums of mean phase increments, so their error is
    the running sum of the increments' errors: each increment is held to
    rtol 1e-5 / atol 1e-6, and the series to the accumulated bound. (A
    float32 pixel mean of ~660 angles of ±pi is itself ~2e-6 from the
    float64 mean, so a flat 1e-6 on a cumsum would test summation order.)"""
    got, want = np.asarray(got), np.asarray(want)
    inc = np.abs(np.diff(want, axis=-1, prepend=0.0))
    tol = np.cumsum(MEAN_ATOL + MEAN_RTOL * inc, axis=-1)
    assert got.shape == want.shape, what
    assert (np.abs(got - want) <= tol).all(), (what, float(np.abs(got - want).max()))


def _masks(x, y):
    return worker.roi_masks(x, y)


# ------------------------------------------------------ single process vs JAX
@pytest.mark.parametrize("shape", [(16, 16), (30, 22)], ids=["16x16", "30x22"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(shape, name):
    t, data = _scan(*shape)
    kw = CONFIGS[name]
    jcube = jax_make_cube(t, data, dx=1.0, dy=1.0)
    tcube = make_cube(t, data, dx=1.0, dy=1.0, device="cpu")
    params = convert.step_params_from_numpy(jax_step.StepParams.defaults_np())
    jout, jimg = jax_step.interactive_update(jcube, jax_step.StepParams.defaults(),
                                             jax_step.StepConfig(**kw))
    tout, timg = step.interactive_update(tcube, params, step.StepConfig(**kw))
    for field in CUBE_FIELDS:
        _close(getattr(tout, field).numpy(), getattr(jout, field), what=field)
    _close(timg.numpy(), jimg, what="image")

    s = kw.get("scale", 1)
    gx, gy = shape[0] // s, shape[1] // s
    masks, pix = _masks(gx, gy), worker.pixel(gx, gy)
    jl = jax_step.lean_update(jcube, jax_step.StepParams.defaults(), jax_step.StepConfig(**kw),
                              jnp.asarray(masks), jnp.asarray(pix, jnp.int32))
    tl = step.lean_update(tcube, params, step.StepConfig(**kw), torch.as_tensor(masks), pix)
    assert set(tl) == set(jl)
    for key in jl:
        _close(tl[key].numpy(), jl[key], what=key)


def test_step_params_defaults_match_jax():
    jax_defaults = convert.step_params_from_numpy(jax_step.StepParams.defaults_np())
    ours = step.StepParams()
    # the chain takes every scalar as float32 (ops/windows._scalar)
    for f in ours.__dataclass_fields__:
        np.testing.assert_array_equal(np.float32(getattr(ours, f)),
                                      np.float32(getattr(jax_defaults, f)))
    assert set(step.StepConfig._fields) < set(jax_step.StepConfig._fields)


# ------------------------------------------------------------ the split rule
@pytest.mark.parametrize("n", range(1, 9))
def test_grid_shape_matches_jax_make_mesh(n):
    import jax

    assert pm.grid_shape(n) == jax_mesh.make_mesh(jax.devices()[:n]).devices.shape


class ThreadMesh:
    """The ranks of a mesh as threads of this process: each thread's
    ``all_sum`` hands its tensor in, waits for the others, and gets the sum
    in rank order (the collective of ``ops/scaling``'s one exchange)."""

    def __init__(self, shape):
        import threading

        self.shape = shape
        self.world = shape[0] * shape[1]
        self.barrier = threading.Barrier(self.world)
        self.parts = [None] * self.world

    def all_sum(self, t, mesh):
        self.parts[mesh.rank] = t
        self.barrier.wait()
        out = self.parts[0].clone()
        for p in self.parts[1:]:
            out = out + p
        self.barrier.wait()
        return out

    def run(self, fn):
        """``fn(mesh)`` on every rank's thread; the results in rank order."""
        import threading

        out, errors = [None] * self.world, []

        def one(r):
            try:
                out[r] = fn(pm.Mesh(self.shape, r))
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if errors:
            raise errors[0]
        return out


@pytest.mark.parametrize("grid,shape,scale", [
    ((30, 22), (2, 2), 1), ((200, 200), (2, 2), 1), ((16, 16), (2, 4), 1),
    ((31, 23), (1, 2), 3), ((31, 23), (2, 2), 3), ((31, 23), (1, 2), 7), ((31, 23), (2, 2), 7),
])
def test_blocks_tile_the_grid(grid, shape, scale, monkeypatch):
    """The blocks of a grid tile it; after a downscale by a factor that
    divides neither the grid nor its blocks, each rank holds the mesh's
    block of the downscaled grid, with the single device's values bit for
    bit (the one layout of the step and the ``Pipeline``)."""
    from thz_image_explorer_tpu_torch.ops import scaling

    mesh = pm.Mesh(shape)
    out_grid = (grid[0] // scale, grid[1] // scale)
    cover = np.zeros(out_grid, np.int32)
    for r in range(mesh.world):
        x0, x1, y0, y1 = mesh.block(r, out_grid)
        assert mesh.coords(r) == (r // shape[1], r % shape[1])
        cover[x0:x1, y0:y1] += 1
    assert (cover == 1).all()
    if scale == 1:
        return
    assert grid[0] % scale and grid[1] % scale
    t, data = _scan(*grid, n=16)
    whole = make_cube(t, data, dx=1.0, dy=1.0, device="cpu")
    whole = whole.replace(fft=torch.complex(whole.data[..., :9], -whole.data[..., 7:]),
                          amplitudes=whole.data[..., :9] * 2, phases=whole.data[..., 7:] - 1)
    want = scaling.scale_cube(whole, scale, valid_wh=whole.valid_wh)
    threads = ThreadMesh(shape)
    monkeypatch.setattr(scaling, "all_sum", threads.all_sum)
    got = threads.run(lambda m: scaling.scale_cube(pm.shard_cube(whole, m), scale,
                                                   valid_wh=whole.valid_wh, mesh=m))
    for r, blk in enumerate(got):
        x0, x1, y0, y1 = mesh.block(r, out_grid)
        assert blk.origin == (x0, y0) and blk.grid == out_grid and blk.scaling == scale
        assert blk.valid_wh == want.valid_wh
        for f in scaling.FIELDS:
            assert torch.equal(getattr(blk, f), getattr(want, f)[x0:x1, y0:y1]), (r, f)


def test_block_refuses_an_empty_rank():
    with pytest.raises(ValueError, match="no rows or columns"):
        pm.Mesh((1, 4)).block(3, (8, 5))
    with pytest.raises(ValueError, match="no rows or columns"):
        pm.Mesh((2, 1)).block(1, (1, 8))


def test_cube_sharding_names_jax_placements():
    import jax

    mesh = jax_mesh.make_mesh(jax.devices()[:4])
    want = {k: "replicated" if v.is_fully_replicated else "split"
            for k, v in jax_mesh.cube_sharding(mesh).items()}
    assert pm.cube_sharding() == want


def test_shard_cube_keeps_global_fields():
    t, data = _scan(30, 22)
    cube = make_cube(t, data, dx=1.0, dy=1.0, device="cpu")
    mesh = pm.Mesh((2, 2))
    for r in range(4):
        b = pm.shard_cube(cube, mesh, r)
        x0, x1, y0, y1 = mesh.block(r, (30, 22))
        assert b.origin == (x0, y0) and b.grid == (30, 22) and b.valid_wh == (30, 22)
        assert torch.equal(b.data, cube.data[x0:x1, y0:y1])
        assert b.fft.shape[:2] == (x1 - x0, y1 - y0) and b.time is cube.time


def test_scale_cube_refuses_a_block_without_its_mesh():
    """A block downscaled on its own would put a downscaled pixel that
    straddles two blocks on neither: the step passes its mesh, and a block
    without one is refused."""
    from thz_image_explorer_tpu_torch.ops.scaling import scale_cube

    t, data = _scan(30, 22)
    block = pm.shard_cube(make_cube(t, data, device="cpu"), pm.Mesh((2, 2)), 3)
    assert block.origin == (15, 11)
    with pytest.raises(ValueError, match="with its mesh"):
        scale_cube(block, 2)
    assert scale_cube(block, 1) is block


def test_band_split_is_round_robin_by_trip_count():
    n_iter = np.array([64, 35, 19, 9, 4, 1, 64, 50, 35])
    # descending n_iter, stable: 0, 6, 7, 1, 8, 2, 3, 4, 5
    assert [b.tolist() for b in dec.band_split(n_iter, 2)] == [[0, 7, 8, 3, 5], [6, 1, 2, 4]]
    split4 = dec.band_split(n_iter, 4)
    assert [b.tolist() for b in split4] == [[0, 8, 5], [6, 2], [7, 3], [1, 4]]
    sums = [int(n_iter[b].sum()) for b in split4]
    assert max(sums) - min(sums) <= n_iter.max()
    assert sorted(np.concatenate(split4).tolist()) == list(range(len(n_iter)))


# ---------------------------------------------------- one rank, in this process
def test_one_rank_group_equals_single_device(tmp_path):
    """A mesh of one gloo rank runs every collective and gives the
    single-device values bit for bit."""
    t, data = synthetic_scan(width=30, height=22, n_time=64)
    cube = make_cube(t, data - data[:, :, :1], dx=1.0, dy=1.0, device="cpu")
    mesh = pm.init("cpu", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        assert mesh.shape == (1, 1) and mesh.group is not None
        whole = pm.shard_cube(cube, mesh)
        cfg = step.StepConfig(**CONFIGS["avg_in_fourier"])
        masks = torch.as_tensor(_masks(30, 22))
        a = step.lean_update(cube, step.StepParams(), cfg, masks, (4, 5))
        b = step.lean_update(whole, step.StepParams(), cfg, masks, (4, 5), mesh)
        for key in a:
            assert torch.equal(a[key], b[key]), key
        (ca, ia), (cb, ib) = (step.interactive_update(cube, step.StepParams(), cfg),
                              step.interactive_update(whole, step.StepParams(), cfg, mesh))
        assert torch.equal(ia, ib) and torch.equal(ca.avg_data, cb.avg_data)
        psf = convert.psf_from_numpy(synthetic_psf_arrays())
        geo = dec.plan_bands(dec.DeconvolutionParams(**worker.DECONV), psf, t, (30, 22), 1.0, 1.0)
        assert torch.equal(dec.deconvolve_cube(cube.data, geo),
                           dec.deconvolve_cube(cube.data, geo, mesh=mesh))
        args = (cube.data, 3.2, 1, (30, 22, 64))
        va = voxel.extract_instances_topk(*args, **worker.VIEW)
        vb = voxel.extract_instances_topk(*args, mesh=mesh, **worker.VIEW)
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(x, y)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the spawned runs
def _spawn(world, workdir, scan, psf):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, daemon=True,
                         args=(r, world, str(workdir / "store"), scan, psf, str(workdir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: (workdir / f"rank{r}.err").read_text()
              for r in range(world) if (workdir / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} still running after {SPAWN_TIMEOUT_S} s: {errors}"
    assert all(p.exitcode == 0 for p in procs), ([p.exitcode for p in procs], errors)
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan")
    t, cube = synthetic_scan(width=30, height=22, n_time=64)
    write_scan_thz(str(d / "scan.thzimg"), t, cube, dx=1.0, dy=1.0)
    np.savez(d / "psf.npz", **synthetic_psf_arrays())
    return str(d / "scan.thzimg"), str(d / "psf.npz")


@pytest.fixture(scope="module")
def reference(scan_files):
    """The unsharded port and JAX on the whole scan."""
    scan, psf = scan_files
    cube, img = finalize_scan(open_scan_host(scan), device="cpu")
    t = cube.time.numpy()
    out = {"cube": cube, "img": img.numpy()}
    jcube = jax_make_cube(t, cube.data.numpy(), dx=1.0, dy=1.0)
    for name, kw in worker.STEPS:
        s = kw.get("scale", 1)
        gx, gy = cube.width // s, cube.height // s
        masks, pix = _masks(gx, gy), worker.pixel(gx, gy)
        out[name] = step.lean_update(cube, step.StepParams(), step.StepConfig(**kw),
                                     torch.as_tensor(masks), pix)
        out[f"jax_{name}"] = {k: np.asarray(v) for k, v in jax_step.lean_update(
            jcube, jax_step.StepParams.defaults(), jax_step.StepConfig(**kw),
            jnp.asarray(masks), jnp.asarray(pix, jnp.int32)).items()}
    geo = dec.plan_bands(dec.DeconvolutionParams(**worker.DECONV), load_psf(psf), t,
                         (cube.width, cube.height), cube.dx, cube.dy)
    out["geometry"] = geo
    out["deconv"] = dec.deconvolve_cube(cube.data, geo).numpy()
    out["view"] = voxel.extract_instances_topk(cube.data, float(t[-1] - t[0]), 1,
                                               (cube.width, cube.height, cube.n_time),
                                               **worker.VIEW)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, scan_files, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"world{world}"), *scan_files)


def _block(full, origin, like):
    """``full``'s pixels under the block ``like`` at ``origin``."""
    x0, y0 = origin
    return full[x0: x0 + like.shape[0], y0: y0 + like.shape[1]]


def test_mesh_layout_and_blocks(ranks):
    world, got = ranks
    covered = np.zeros((30, 22), np.int32)
    for r, o in enumerate(got):
        assert tuple(o["mesh_shape"]) == pm.grid_shape(world)
        x0, y0 = o["all_stages_origin"]
        bx, by = o["all_stages_open"].shape[:2]
        assert (x0, x0 + bx, y0, y0 + by) == pm.Mesh(pm.grid_shape(world)).block(r, (30, 22))
        covered[x0:x0 + bx, y0:y0 + by] += 1
        assert bool(o["gathered_equals_whole"])
    assert (covered == 1).all()


def test_sharded_open_equals_loader(ranks, reference):
    _, got = ranks
    whole, img = reference["cube"].data.numpy(), reference["img"]
    for o in got:
        for name, _ in worker.STEPS:
            blk = o[f"{name}_open"]
            np.testing.assert_array_equal(blk, _block(whole, o[f"{name}_origin"], blk))
            np.testing.assert_array_equal(o[f"{name}_open_img"],
                                          _block(img, o[f"{name}_origin"], blk))


@pytest.mark.parametrize("name", [s[0] for s in worker.STEPS])
def test_sharded_lean_update_equals_unsharded(ranks, reference, name):
    world, got = ranks
    scale = dict(worker.STEPS)[name].get("scale", 1)
    ref = {k: (torch.view_as_real(v) if v.is_complex() else v).numpy()
           for k, v in reference[name].items()}
    out_grid = (30 // scale, 22 // scale)
    for r, o in enumerate(got):
        # the output is the mesh's block of the output grid
        origin = o[f"{name}_out_origin"]
        x0, x1, y0, y1 = pm.Mesh(pm.grid_shape(world)).block(r, out_grid)
        assert tuple(origin) == (x0, y0) and o[f"{name}_data"].shape[:2] == (x1 - x0, y1 - y0)
        for key in ("data", "img"):
            blk = o[f"{name}_{key}"]
            np.testing.assert_array_equal(blk, _block(ref[key], origin, blk), err_msg=key)
        for key in ("avg_signal", "roi_trace", "pix_sig", "pix_amp", "avg_amp", "roi_amp",
                    "avg_fft"):
            _close(o[f"{name}_{key}"], ref[key], MEAN_ATOL, MEAN_RTOL, key)
        for key in ("pix_ph", "avg_ph", "roi_ph"):
            _phase_close(o[f"{name}_{key}"], ref[key], key)


@pytest.mark.parametrize("name", [s[0] for s in worker.STEPS])
def test_sharded_lean_update_equals_jax(ranks, reference, name):
    _, got = ranks
    ref = reference[f"jax_{name}"]
    for o in got:
        origin = o[f"{name}_out_origin"]
        for key in ("data", "img"):
            blk = o[f"{name}_{key}"]
            _close(blk, _block(ref[key], origin, blk), what=key)
        _close(o[f"{name}_avg_fft"], np.stack([ref["avg_fft"].real, ref["avg_fft"].imag], -1),
               what="avg_fft")
        for key in ("avg_signal", "roi_trace", "pix_sig", "pix_amp", "pix_ph", "avg_amp",
                    "avg_ph", "roi_amp", "roi_ph"):
            _close(o[f"{name}_{key}"], ref[key], what=key)


def test_sharded_deconvolution_equals_unsharded(ranks, reference):
    world, got = ranks
    ref = reference["deconv"]
    scale = np.nanmax(np.abs(ref))
    n_groups = len(dec.rlsep._groups(int(reference["geometry"].n_iter.max())))
    for o in got:
        blk = o["deconv"]
        np.testing.assert_allclose(blk / scale, _block(ref, o["all_stages_origin"], blk) / scale,
                                   atol=1e-5)
        np.testing.assert_allclose(o["deconv_progress"],
                                   [k / (n_groups + 1) for k in range(n_groups + 1)] + [1.0])
    # the split leaves one rank with fewer checkpoints of its own than the
    # plan: it joins the rest after its run
    split = dec.band_split(reference["geometry"].n_iter, world)
    local = [len(dec.rlsep._groups(int(reference["geometry"].n_iter[b].max()))) for b in split]
    assert n_groups == 2 and min(local) < n_groups


def test_cancel_on_one_rank_stops_all(ranks):
    _, got = ranks
    for o in got:
        assert bool(o["cancel_returned_none"])
        # every rank was asked at both checkpoints, then all stopped
        assert int(o["cancel_checks"]) == 2


def test_sharded_live_view_equals_unsharded(ranks, reference):
    _, got = ranks
    pos, rgba, *dims, thr = reference["view"]
    want = {tuple(p): a for p, a in zip(np.round(pos, 5), rgba)}
    for o in got:
        assert float(o["view_thr"]) == thr
        np.testing.assert_array_equal(o["view_dims"], dims)
        have = {tuple(p): a for p, a in zip(np.round(o["view_pos"], 5), o["view_rgba"])}
        # ties at the threshold may pick other voxels of equal opacity
        for a, b in ((want, have), (have, want)):
            for key in set(a) - set(b):
                assert abs(a[key][3] - np.floor(thr * 63) / 63) < 1e-6, key
        common = set(want) & set(have)
        assert len(common) > 0.9 * len(want)
        for key in common:
            np.testing.assert_array_equal(want[key], have[key])
