"""The port's incremental ``Pipeline`` on one rank's block of a pixel-sharded
cube (``Pipeline(mesh=)``) and its publish, on the CPU.

* real multi-process runs: 2 (1x2) and 4 (2x2) ranks, one spawned process
  each, joined over gloo through a ``file://`` store
  (``tests/torch_pipeline_mesh_worker.py``), on a ragged 30x22x64 scan with
  dx and dy, 3 box ROIs and a pixel whose owner changes with the downscale.
  Each rank opens only its block and runs the scripted commands (the four
  filter stages, a slider step, downscales by 2, 3 and 7, tilt (2°, 2°),
  avg-in-Fourier, and back; tilt (2°, 1°), whose trace length is 2 mod 4,
  a downscale by 3 under it, and back), a click, the Apply and a slider step after it,
  and the dense 3-D extraction. Checked: (a) after every command each
  rank's slots equal the unsharded port's over its block bit for bit (in
  the rank); (b) the published series and images equal the unsharded
  ``Publisher``'s (per-pixel ones bit for bit, means within rtol 1e-5 /
  atol 1e-6, phases to the running sum of their increments); (c) the
  slider step's output, raw spectrum, pixel means and image match the JAX
  ``Pipeline`` on the whole cube (atol 5e-5 / rtol 1e-4, JAX in the parent
  only); (e) the Apply within 1e-5 * max of the unsharded one and no RL
  after it; (f) the dense extraction's threshold and points equal the
  unsharded port's (also with the cap lowered, so that the joined
  histograms run) and match JAX's; (i) a click reduces nothing;
* other trace lengths (63 and 65 samples, and 62 and 66, which are 2 mod
  4, beside 64): the same spawned runs and checks (a), (b), (c), (e), (f)
  and (g) on scans of those lengths (``ops/fourier.batch_fft`` pairs each
  row of an odd length with a zero row, ``ops/intensity`` sums the squares
  of a length that is not a multiple of 4 at an aligned stride);
* in this process: (d) every block's tilt shifts equal the whole grid's;
  (g) a one-rank mesh without a group equals ``Pipeline()`` bit for bit;
  (h) ``set_input`` refuses a foreign block and a whole cube; the owner
  rule; no CPU fallback.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pipeline_mesh_worker as worker
from make_sample import synthetic_scan, write_scan_thz
from test_torch_deconv import synthetic_psf_arrays
from thz_image_explorer_tpu.data import make_cube as jax_make_cube
from thz_image_explorer_tpu.ops import voxel as jvox
from thz_image_explorer_tpu.pipeline.executor import Pipeline as JaxPipeline
from thz_image_explorer_tpu_torch.data import make_cube
from thz_image_explorer_tpu_torch.io.dotthz import finalize_scan, open_scan_host
from thz_image_explorer_tpu_torch.ops import tilt
from thz_image_explorer_tpu_torch.ops.optical import calculate_optical_properties
from thz_image_explorer_tpu_torch.parallel import mesh as pm
from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline

#: port vs JAX (the main path's tolerance)
ATOL, RTOL = 5e-5, 1e-4
#: sharded vs unsharded means (tests/test_parallel.py's)
MEAN_ATOL, MEAN_RTOL = 1e-6, 1e-5
#: the Apply, |sharded - unsharded| <= this * max (tests/test_torch_parallel.py's)
APPLY_TOL = 1e-5
#: a spawned run's limit: a hung collective fails its test, not the suite
SPAWN_TIMEOUT_S = 150.0
#: tests/test_torch_voxel.py's opacity tolerance, port vs JAX
OPAC_ATOL = 2e-5
#: published series that come from one pixel's rows or per-pixel images
PER_PIXEL = ("signal", "signal_fft", "phase_fft", "filtered_signal", "filtered_signal_fft",
             "filtered_phase_fft", "image", "current_image", "time", "frequencies",
             "filtered_time", "filtered_frequencies")
PHASES = ("avg_phase_fft", "roi_ph")
OPTICAL = ("refractive_index", "absorption_coefficient", "extinction_coefficient")
STEPS = ["open"] + [name for name, _ in worker.COMMANDS] + ["click", "apply"]


def _phase_close(got, want, what=""):
    """Phase means are cumsums of mean phase increments: each increment is
    held to rtol 1e-5 / atol 1e-6 and the series to their running sum."""
    inc = np.abs(np.diff(want, axis=-1, prepend=0.0))
    tol = np.cumsum(MEAN_ATOL + MEAN_RTOL * inc, axis=-1)
    assert got.shape == want.shape, what
    assert (np.abs(got - want) <= tol).all(), (what, float(np.abs(got - want).max()))


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
    return [(json.loads((workdir / f"rank{r}.json").read_text()),
             dict(np.load(workdir / f"rank{r}.npz"))) for r in range(world)]


def _scan_files(tmp_path_factory, n_time):
    d = tmp_path_factory.mktemp(f"scan{n_time}")
    t, cube = synthetic_scan(width=30, height=22, n_time=n_time)
    write_scan_thz(str(d / "scan.thzimg"), t, cube, dx=1.0, dy=1.0)
    np.savez(d / "psf.npz", **synthetic_psf_arrays())
    return str(d / "scan.thzimg"), str(d / "psf.npz")


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    return _scan_files(tmp_path_factory, 64)


@pytest.fixture(scope="module")
def whole(scan_files):
    return finalize_scan(open_scan_host(scan_files[0]), device="cpu")[0]


@pytest.fixture(scope="module")
def reference(scan_files, whole):
    """The unsharded port's run of the commands."""
    return worker.drive(Pipeline("cpu"), whole, scan_files[1])


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, scan_files, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"world{world}"), *scan_files)


@pytest.fixture(scope="module", params=[62, 63, 65, 66], ids=["n62", "n63", "n65", "n66"])
def odd_scan_files(request, tmp_path_factory):
    """Scans of a trace length other than 64 (odd, or 2 mod 4), with the
    PSF."""
    return _scan_files(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def odd_whole(odd_scan_files):
    return finalize_scan(open_scan_host(odd_scan_files[0]), device="cpu")[0]


@pytest.fixture(scope="module")
def odd_reference(odd_scan_files, odd_whole):
    return worker.drive(Pipeline("cpu"), odd_whole, odd_scan_files[1])


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def odd_ranks(request, odd_scan_files, odd_whole, tmp_path_factory):
    world = request.param
    assert odd_whole.n_time % 4 != 0
    return world, _spawn(world, tmp_path_factory.mktemp(f"odd{odd_whole.n_time}_world{world}"),
                         *odd_scan_files)


def _block(full, origin, like):
    x0, y0 = (int(v) for v in origin)
    return full[x0: x0 + like.shape[0], y0: y0 + like.shape[1]]


# ------------------------------------------------------- the spawned runs
@pytest.mark.parametrize("step", STEPS[:-2])
def test_sharded_slots_equal_unsharded(ranks, step):
    """(a) every slot of every rank's block, after each command."""
    _check_slots(ranks, step)


def _check_slots(ranks, step):
    world, got = ranks
    for res, _ in got:
        assert step in res["origins"], (world, res["rank"], step)
        bad = [m for m in res["mismatches"] if m.split(" ")[0] == step]
        assert not bad, (world, res["rank"], bad)


def test_slots_keep_the_mesh_layout(ranks, whole):
    """Every slot is the mesh's block of its grid: the blocks of a
    downscaled grid too, whatever the factor."""
    world, got = ranks
    mesh = pm.Mesh(pm.grid_shape(world))
    for res, _ in got:
        for step, origins in res["origins"].items():
            scale = {"scale2": 2, "scale3": 3, "scale7": 7, "tilt_scale7": 7,
                     "tilt_2mod4_scale3": 3}.get(step, 1)
            grid = (whole.width // scale, whole.height // scale)
            x0, _, y0, _ = mesh.block(res["rank"], grid)
            assert origins[-1] == [x0, y0], (step, res["rank"], origins)
            assert origins[0] == list(mesh.block(res["rank"], (30, 22))[::2])


def test_second_tilt_runs_at_a_length_of_2_mod_4(ranks, whole):
    """The second tilt's trace length is 2 mod 4 at scale 1 and at scale 3,
    and at scale 3 a block's rows are not where the whole grid's rows of
    the same pixels lie modulo 2 rows (so at other 16-byte alignments)."""
    world, got = ranks
    mesh = pm.Mesh(pm.grid_shape(world))
    for _, out in got:
        for step in ("tilt_2mod4", "tilt_2mod4_scale3"):
            assert len(out[f"{step}/filtered_time"]) % 4 == 2, step
    grid = (whole.width // 3, whole.height // 3)
    blocks = [mesh.block(r, grid) for r in range(world)]
    assert any((x * (y1 - y0) + y) % 2 != ((x0 + x) * grid[1] + y0 + y) % 2
               for x0, x1, y0, y1 in blocks for x in range(x1 - x0) for y in range(y1 - y0))


@pytest.mark.parametrize("step", STEPS)
def test_sharded_publish_equals_unsharded(ranks, reference, step):
    """(b) the published series and the whole image on every rank."""
    _check_publish(ranks, reference, step)


def _check_publish(ranks, reference, step):
    world, got = ranks
    ref = reference[0]
    keys = [k[len("open/"):] for k in ref if k.startswith("open/")]
    assert {"avg_signal", "roi_trace", "image", "refractive_index"} <= set(keys)
    for res, out in got:
        for key in keys:
            g, w = out[f"{step}/{key}"], ref[f"{step}/{key}"]
            what = f"{world} ranks, rank {res['rank']}, {step} {key}"
            if key in PER_PIXEL:
                np.testing.assert_array_equal(g, w, err_msg=what)
            elif key in PHASES:
                _phase_close(g, w, what)
            elif key in OPTICAL:
                continue  # from the series above: test_sharded_optical_follows_the_series
            else:
                np.testing.assert_allclose(g, w, atol=MEAN_ATOL, rtol=MEAN_RTOL, err_msg=what)


@pytest.mark.parametrize("step", STEPS)
def test_sharded_optical_follows_the_series(ranks, step):
    """n, alpha and kappa on every rank are the optical formula of that
    rank's published pixel and ROI 0 series, bit for bit (those series are
    held to the unsharded ones above; the formula divides their
    differences by the frequency and the thickness, which magnifies a
    mean's last-bit differences)."""
    _, got = ranks
    for _, out in got:
        n, alpha, kappa = calculate_optical_properties(*(torch.as_tensor(out[f"{step}/{k}"]) for k in (
            "filtered_signal_fft", "filtered_phase_fft")), torch.as_tensor(out[f"{step}/roi_amp"][0]),
            torch.as_tensor(out[f"{step}/roi_ph"][0]),
            torch.as_tensor(out[f"{step}/filtered_frequencies"]), worker.THICKNESS)
        for key, want in zip(OPTICAL, (n, alpha, kappa)):
            np.testing.assert_array_equal(out[f"{step}/{key}"], want.numpy(), err_msg=key)


@pytest.fixture(scope="module")
def jax_slider(whole):
    """The JAX ``Pipeline`` on the whole cube at the slider step
    (tests/test_parallel.py's product-executor check)."""
    return _jax_slider(whole)


def _jax_slider(whole):
    p = JaxPipeline(record_timings=False)
    for uuid in worker.FILTERS:
        p.filters[uuid].active = True
    p.set_input(jax_make_cube(whole.time.numpy(), whole.data.numpy(), dx=1.0, dy=1.0))
    p.config.fft_window[0] = 1.5
    p.run_from(p.fft_index)
    v, out = p.raw_fd_view(), p.output
    return dict(output_data=np.asarray(out.data), raw_fd_amplitudes=np.asarray(v.amplitudes),
                raw_fd_phases=np.asarray(v.phases),
                output_avg_fft=np.stack([np.asarray(out.avg_fft).real,
                                         np.asarray(out.avg_fft).imag], -1),
                output_avg_signal_fft=np.asarray(out.avg_signal_fft),
                output_avg_phase_fft=np.asarray(out.avg_phase_fft),
                current_image=np.asarray(p.current_image()))


def test_sharded_pipeline_matches_jax(ranks, jax_slider):
    """(c) the port's mesh against the JAX Pipeline run unsharded."""
    _check_jax(ranks, jax_slider)


def _check_jax(ranks, jax_slider):
    world, got = ranks
    for res, out in got:
        origin = out["slider/origin"]
        for key in ("output_data", "raw_fd_amplitudes", "raw_fd_phases"):
            g = out[f"slider/{key}"]
            np.testing.assert_allclose(g, _block(jax_slider[key], origin, g), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{world} ranks {key}")
        for key in ("output_avg_fft", "output_avg_signal_fft", "output_avg_phase_fft",
                    "current_image"):
            np.testing.assert_allclose(out[f"slider/{key}"], jax_slider[key], atol=ATOL,
                                       rtol=RTOL, err_msg=f"{world} ranks {key}")


def test_sharded_apply_equals_unsharded(ranks, reference):
    """(e) the Apply through ``update_filter(..., force=True)`` and a
    slider step after it that runs no RL."""
    _check_apply(ranks, reference)


def _check_apply(ranks, reference):
    world, got = ranks
    ref, counts = reference
    scale = np.nanmax(np.abs(ref["apply/data"]))
    assert counts["apply_rl_runs"] == 1 and counts["after_apply_rl_runs"] == 0
    for res, out in got:
        g = out["apply/data"]
        np.testing.assert_allclose(g / scale, _block(ref["apply/data"], out["apply/origin"], g)
                                   / scale, atol=APPLY_TOL)
        assert res["apply_rl_runs"] == 1 and res["after_apply_rl_runs"] == 0, res
        assert not np.array_equal(g, out["dense/data"])  # the slider step changed the data


@pytest.mark.parametrize("name", ["dense", "dense_low"])
def test_sharded_dense_extraction_equals_unsharded(ranks, reference, name):
    """(f) the same threshold and the same points in the same order."""
    _check_dense(ranks, reference, name)


def _check_dense(ranks, reference, name):
    world, got = ranks
    ref = reference[0]
    if name == "dense":
        assert float(ref["dense/thr"]) == 0.0  # fewer voxels than MAX_INSTANCES
    else:
        assert 0 < float(ref["dense_low/thr"]) and 0 < len(ref["dense_low/pos"]) <= worker.LOW_CAP
    for res, out in got:
        for key in ("pos", "rgba", "dims", "thr"):
            np.testing.assert_array_equal(out[f"{name}/{key}"], ref[f"{name}/{key}"],
                                          err_msg=f"{world} ranks, rank {res['rank']} {key}")


def test_dense_extraction_matches_jax(ranks, reference, whole):
    """(f) against JAX's ``extract_instances`` on the same final data."""
    _check_dense_jax(ranks, reference, whole)


def _check_dense_jax(ranks, reference, whole):
    world, got = ranks
    ref = reference[0]
    t = whole.time.numpy()
    want = jvox.extract_instances(
        jnp.asarray(ref["dense/data"]), time_span=float(t[-1] - t[0]), scaling=1,
        original_dims=(30, 22, whole.n_time), valid_grid=(30, 22), **worker.DENSE)
    for _, out in got:
        np.testing.assert_array_equal(out["dense/pos"], want[0])
        np.testing.assert_allclose(out["dense/rgba"], want[1], atol=OPAC_ATOL)
        assert tuple(out["dense/dims"]) == tuple(want[2:5]) and float(out["dense/thr"]) == want[5]


def test_click_reduces_nothing(ranks, reference):
    """(i) a click on the mesh leaves the reductions cached and makes one
    collective (the selection's); a slider step and its publish reduce
    once and make two (the iFFT's means, the publish's sums)."""
    _, got = ranks
    for res, _ in got + [(reference[1], None)]:
        assert res["click_sums_calls"] == 0 and res["slider_sums_calls"] == 1, res
    assert reference[1]["click_collectives"] == reference[1]["slider_collectives"] == 0
    for res, _ in got:
        assert res["click_collectives"] == 1 and res["slider_collectives"] == 2, res


# ------------------------------------------------- odd trace lengths
def test_odd_length_sharded_slots_equal_unsharded(odd_ranks):
    """(a) at an odd trace length: every slot after every command."""
    for step in STEPS[:-2]:
        _check_slots(odd_ranks, step)


def test_odd_length_sharded_publish_equals_unsharded(odd_ranks, odd_reference):
    """(b) at an odd trace length: every published series after every
    command."""
    for step in STEPS:
        _check_publish(odd_ranks, odd_reference, step)


def test_odd_length_sharded_pipeline_matches_jax(odd_ranks, odd_whole):
    """(c) at an odd trace length, against the JAX Pipeline."""
    _check_jax(odd_ranks, _jax_slider(odd_whole))


def test_odd_length_sharded_apply_and_dense_equal_unsharded(odd_ranks, odd_reference,
                                                           odd_whole):
    """(e), (f) at an odd trace length, the dense points also against JAX's."""
    _check_apply(odd_ranks, odd_reference)
    for name in ("dense", "dense_low"):
        _check_dense(odd_ranks, odd_reference, name)
    _check_dense_jax(odd_ranks, odd_reference, odd_whole)


def test_odd_length_one_rank_mesh_equals_pipeline(odd_scan_files, odd_whole, odd_reference):
    """(g) at an odd trace length."""
    _check_one_rank(odd_scan_files, odd_whole, odd_reference)


@pytest.mark.parametrize("n", [62, 63, 64, 65, 66])
def test_batch_fft_pairs_odd_rows_with_zero_rows(n, monkeypatch):
    """At an odd length the transform sees each row followed by a zero row
    (the batch twice as long) and gives the plain transform's values; an
    even length, 0 or 2 mod 4, reaches it as it is. The intensity image
    sums the squares of each row, from rows 16-byte aligned at every
    length."""
    from thz_image_explorer_tpu_torch.ops import fourier
    from thz_image_explorer_tpu_torch.ops.intensity import intensity_image

    seen = []

    def recording(fn):
        def run(x, **kw):
            seen.append(x.clone())
            return fn(x, **kw)
        return run

    x = torch.randn(5, 3, n, generator=torch.Generator().manual_seed(n))
    cube = make_cube((np.arange(n) * 0.05).astype(np.float32), x.numpy(), device="cpu")
    spec = fourier.batch_fft(recording(torch.fft.rfft), x, cube)
    back = fourier.batch_fft(recording(torch.fft.irfft), spec, cube, n=n)
    assert fourier.pairs_rows(n) == bool(n % 2)
    if n % 2:
        assert seen[0].shape == (30, n) and seen[1].shape == (30, n // 2 + 1)
        assert torch.equal(seen[0][0::2], x.reshape(15, n)) and not seen[0][1::2].any()
        assert torch.equal(seen[1][0::2], spec.reshape(15, -1)) and not seen[1][1::2].any()
    else:
        assert seen[0].shape == x.shape and seen[1].shape == spec.shape
    assert spec.shape == (5, 3, n // 2 + 1) and spec.is_contiguous() and back.shape == x.shape
    assert torch.equal(spec, torch.fft.rfft(x, dim=-1))
    torch.testing.assert_close(back, x, atol=1e-5, rtol=1e-5)

    summed, real_sum = [], torch.sum

    def recording_sum(t, *a, **kw):
        summed.append((t.stride(-2), t.data_ptr() % 16))
        return real_sum(t, *a, **kw)

    monkeypatch.setattr(torch, "sum", recording_sum)
    img = intensity_image(x[1:])
    monkeypatch.setattr(torch, "sum", real_sum)
    assert summed and all(stride % 4 == 0 and offset == 0 for stride, offset in summed), summed
    torch.testing.assert_close(img, (x[1:] * x[1:]).sum(-1), atol=1e-5, rtol=1e-6)


# ------------------------------------------------------ in this process
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 3)])
@pytest.mark.parametrize("grid,tilts", [((30, 22), (2.0, 2.0)), ((4, 3), (-5.0, 3.0)),
                                        ((31, 17), (12.0, -7.5))])
def test_block_tilt_shifts_equal_whole(shape, grid, tilts):
    """(d) each block's shifts at its origin equal the whole grid's over it,
    and so does the tilted block."""
    mesh = pm.Mesh(shape)
    n = tilt.extension_steps(*grid, 0.5, 0.7, *tilts)
    full = tilt.pixel_shifts(*grid, grid, 0.5, 0.7, *tilts, n)
    rng = np.random.default_rng(3)
    t = (np.arange(48) * 0.05).astype(np.float32)
    cube = make_cube(t, rng.normal(size=(*grid, 48)).astype(np.float32), dx=0.5, dy=0.7,
                     device="cpu")
    out = tilt.tilt_compensate(cube, *tilts)
    for r in range(mesh.world):
        if any(g < s for g, s in zip(grid, shape)):
            continue
        x0, x1, y0, y1 = mesh.block(r, grid)
        got = tilt.pixel_shifts(x1 - x0, y1 - y0, grid, 0.5, 0.7, *tilts, n, (x0, y0))
        np.testing.assert_array_equal(got, full[x0:x1, y0:y1])
        blk = tilt.tilt_compensate(pm.shard_cube(cube, mesh, r), *tilts)
        assert torch.equal(blk.data, out.data[x0:x1, y0:y1]) and torch.equal(blk.time, out.time)


def test_one_rank_mesh_equals_pipeline(scan_files, whole, reference):
    """(g) a mesh of one rank without a process group: the whole script
    bit for bit, the Apply and the dense extraction included."""
    _check_one_rank(scan_files, whole, reference)


def _check_one_rank(scan_files, whole, reference):
    mesh = pm.Mesh((1, 1))
    assert mesh.group is None
    got, counts = worker.drive(Pipeline("cpu", mesh=mesh), pm.shard_cube(whole, mesh),
                               scan_files[1])
    ref, ref_counts = reference
    assert set(got) == set(ref) and counts == ref_counts
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("case", ["foreign_origin", "whole_cube", "foreign_grid"])
def test_set_input_refuses_what_is_not_this_ranks_block(whole, case):
    """(h) the refusals come before any collective (the mesh has no
    group)."""
    mesh = pm.Mesh((1, 2), rank=0)
    cube = {"foreign_origin": pm.shard_cube(whole, mesh, 1),
            "whole_cube": whole,
            "foreign_grid": pm.shard_cube(whole, mesh, 0).replace(grid=(30, 30))}[case]
    with pytest.raises(ValueError, match="whole cube|not rank 0's"):
        Pipeline("cpu", mesh=mesh).set_input(cube)


def test_owner_is_the_block_that_holds_the_pixel():
    mesh = pm.Mesh((2, 3))
    for grid in ((30, 22), (10, 7), (4, 3)):
        for x in range(grid[0]):
            for y in range(grid[1]):
                x0, x1, y0, y1 = mesh.block(mesh.owner((x, y), grid), grid)
                assert x0 <= x < x1 and y0 <= y < y1
    with pytest.raises(ValueError, match="outside"):
        mesh.owner((30, 0), (30, 22))


def test_mesh_pipeline_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(mesh=pm.Mesh((1, 1)))
