"""One rank of the sharded-pipeline runs (``tests/test_torch_pipeline_mesh.py``).

Started by ``torch.multiprocessing`` with the spawn method, one process a
rank, joined over gloo on the CPU through a ``file://`` store. Each rank
first runs the scripted commands (:func:`drive`) on an unsharded
``Pipeline`` of the whole scan, keeping each slot's part over the block it
will hold, then opens only its block of the scan file
(``parallel.open_scan_sharded``) into a ``Pipeline(mesh=)`` and runs the
same commands, checking after every command that each slot equals the kept
part bit for bit. The commands: the commands of :data:`COMMANDS`, each
followed by a publish; a click; the Apply and a slider step after it; the
dense 3-D extraction, also with ``voxel.MAX_INSTANCES`` lowered so that the
joined two-level histogram runs. What the sharded run published goes
to ``rank<r>.npz`` and the checks and counts to ``rank<r>.json``, for the
parent to compare with the unsharded port and the JAX package. It imports
neither ``jax`` nor the JAX package; a failure is written to
``rank<r>.err``.
"""

from __future__ import annotations

import json
import os
import traceback

from torch_parallel_worker import DECONV, roi_masks

FILTERS = ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch",
           "time_band_pass_after_fft")
#: the selected pixel at native resolution: on another rank than its
#: downscaled pixel at scale 7 on both meshes (a click crosses a block edge)
PIXEL = (14, 12)
#: the click of the caching check
CLICK = (3, 20)
#: the slot fields compared bit for bit
SLOT_FIELDS = ("data", "fft", "amplitudes", "phases")
#: the dense extraction's settings (the small scan's final traces peak at
#: ~0.02: a low contrast spreads their opacities), and the lowered cap of
#: its second run
DENSE = dict(opacity_threshold=1e-3, contrast=0.5)
LOW_CAP = 5_000
#: the sample thickness of the optical selection (m)
THICKNESS = 1e-3


def _tilt(on: bool, angles=(2.0, 2.0)):
    def run(p):
        f = p.filters["tilt_compensation"]
        f.active, (f.tilt_x, f.tilt_y) = on, angles
        p.update_filter("tilt_compensation")
    return run


def _scale(s: int):
    def run(p):
        p.config.scale_factor = s
        p.run_from(p.scaling_index)
    return run


def _fourier(on: bool):
    def run(p):
        p.config.avg_in_fourier_space = on
        p.run_from(p.ifft_index)
    return run


def _slider(p):
    p.config.fft_window[0] = 1.5
    p.run_from(p.fft_index)


def _back(p):
    p.filters["tilt_compensation"].active = False
    p.config.scale_factor = 1
    p.config.avg_in_fourier_space = False
    p.run_from(1)


#: the second tilt: on the 30x22x64 scan (dx = dy = 1 mm) its trace length
#: is 2 mod 4 at scale 1 (158) and, on the 10x7 grid, at scale 3 (158),
#: where a rank's rows lie at other alignments than the whole grid's
TILT_2MOD4 = (2.0, 1.0)
#: the scripted commands after the open (every one followed by a publish)
COMMANDS = (("slider", _slider), ("scale2", _scale(2)), ("scale3", _scale(3)),
            ("scale7", _scale(7)), ("tilt_scale7", _tilt(True)), ("tilt", _scale(1)),
            ("fourier", _fourier(True)), ("back", _back),
            ("tilt_2mod4", _tilt(True, TILT_2MOD4)), ("tilt_2mod4_scale3", _scale(3)),
            ("back_2mod4", _back))


def open_pipeline(pipeline, cube):
    """The open: the four filter stages on, then ``set_input``."""
    for uuid in FILTERS:
        pipeline.filters[uuid].active = True
    pipeline.set_input(cube)


def publish(publisher, pipeline, pixel=PIXEL, with_image=True):
    """One publish with the 3 box ROIs on the final grid (keyed on it) and
    n/alpha/kappa of the pixel against ROI 0; and the pipeline's
    ``current_image``."""
    import numpy as np
    import torch

    gx, gy = pipeline.output.grid_wh
    masks = torch.as_tensor(roi_masks(gx, gy), device=pipeline.device)
    optical = dict(ref_mode="roi", ref_idx=0, samp_mode="pixel", thickness=THICKNESS)
    host = publisher.publish(pipeline, masks, (gx, gy), tuple(pixel), optical)
    if not with_image:
        return host
    return dict(host, current_image=np.asarray(pipeline.current_image()))


def drive(pipeline, cube, psf: str, after_step=lambda step, pipeline: None):
    """The scripted commands on ``pipeline`` (sharded or not): the open and
    :data:`COMMANDS`, each followed by ``after_step`` and a publish; a
    click; the Apply and a slider step after it; the dense extraction at
    the cap and at :data:`LOW_CAP`. Returns ``(arrays, counts)``: the
    published series and images by ``"<step>/<key>"``, and how often the
    publish reduced the spectra and the deconvolution ran its RL."""
    import numpy as np
    import torch

    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import voxel
    from thz_image_explorer_tpu_torch.pipeline import publish as pub
    from thz_image_explorer_tpu_torch.pipeline.publish import Publisher

    import torch.distributed as dist

    out, counts, publisher = {}, {}, Publisher()
    sums, rl, reduces = [], [], []
    real_sums, real_rl = pub.lean_spectral_sums, dec.rl_bands_separable
    pub.lean_spectral_sums = lambda *a, **k: (sums.append(1), real_sums(*a, **k))[1]
    dec.rl_bands_separable = lambda *a, **k: (rl.append(1), real_rl(*a, **k))[1]
    real_reduce = dist.all_reduce
    dist.all_reduce = lambda *a, **k: (reduces.append(1), real_reduce(*a, **k))[1]
    try:
        open_pipeline(pipeline, cube)
        for step, command in (("open", None),) + COMMANDS:
            if command is not None:
                command(pipeline)
            after_step(step, pipeline)
            out.update({f"{step}/{k}": v for k, v in publish(publisher, pipeline).items()})
            if step == "slider":  # held against the JAX Pipeline by the parent
                raw_fd, final = pipeline.raw_fd_view(), pipeline.output
                out.update({"slider/origin": np.asarray(final.origin),
                            "slider/output_data": final.data.numpy(),
                            "slider/raw_fd_amplitudes": raw_fd.amplitudes.numpy(),
                            "slider/raw_fd_phases": raw_fd.phases.numpy()})
                for key in ("avg_fft", "avg_signal_fft", "avg_phase_fft"):
                    v = getattr(final, key)
                    out[f"slider/output_{key}"] = (torch.view_as_real(v) if v.is_complex()
                                                   else v).numpy()
        # a click reuses the reductions and joins the selection alone; a
        # slider step joins the iFFT's means, then the publish's sums
        before, joins = len(sums), len(reduces)
        out.update({f"click/{k}": v for k, v in publish(publisher, pipeline, CLICK, False).items()})
        counts["click_sums_calls"] = len(sums) - before
        counts["click_collectives"] = len(reduces) - joins
        out["click/current_image"] = np.asarray(pipeline.current_image())
        joins = len(reduces)
        _slider(pipeline)
        publish(publisher, pipeline, with_image=False)
        counts["slider_sums_calls"] = len(sums) - before
        counts["slider_collectives"] = len(reduces) - joins

        pipeline.psf = load_psf(psf)
        stage = pipeline.filters["deconvolution"]
        for key, value in DECONV.items():
            setattr(stage.params, key, value)
        stage.active = True
        pipeline.update_filter("deconvolution", force=True)
        counts["apply_rl_runs"] = len(rl)
        out["apply/data"] = pipeline.output.data.numpy()
        out["apply/origin"] = np.asarray(pipeline.output.origin)
        out.update({f"apply/{k}": v for k, v in publish(publisher, pipeline).items()})
        pipeline.config.fft_window[0] = 1.6
        pipeline.run_from(pipeline.fft_index)
        counts["after_apply_rl_runs"] = len(rl) - counts["apply_rl_runs"]
    finally:
        pub.lean_spectral_sums = real_sums
        dec.rl_bands_separable, dist.all_reduce = real_rl, real_reduce

    final = pipeline.output
    t = final.time.numpy()
    kw = dict(time_span=float(t[-1] - t[0]), scaling=final.scaling,
              original_dims=(*cube.grid_wh, cube.n_time), valid_grid=pipeline.valid_for(final),
              **DENSE)
    if pipeline.mesh is not None:
        kw.update(mesh=pipeline.mesh, origin=final.origin, grid=final.grid_wh)
    for name, cap in (("dense", voxel.MAX_INSTANCES), ("dense_low", LOW_CAP)):
        saved, voxel.MAX_INSTANCES = voxel.MAX_INSTANCES, cap
        try:
            pos, rgba, *dims, thr = voxel.extract_instances(final.data, **kw)
        finally:
            voxel.MAX_INSTANCES = saved
        out.update({f"{name}/pos": pos, f"{name}/rgba": rgba, f"{name}/dims": np.asarray(dims),
                    f"{name}/thr": np.asarray(thr)})
    out["dense/data"] = final.data.numpy()
    out["dense/origin"] = np.asarray(final.origin)
    return out, counts


def run(rank: int, world: int, store: str, scan: str, psf: str, outdir: str) -> None:
    try:
        _run(rank, world, store, scan, psf, outdir)
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _run(rank, world, store, scan, psf, outdir):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from thz_image_explorer_tpu_torch.io.dotthz import finalize_scan, open_scan_host
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_scan_sharded
    from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline

    mesh = pm.init("cpu", init_method=f"file://{store}", rank=rank, world_size=world,
                   timeout_s=90.0)
    res = dict(rank=rank, mesh=list(mesh.shape), mismatches=[], origins={})
    try:
        block, _, _ = open_scan_sharded(scan, mesh, device="cpu")
        whole, _ = finalize_scan(open_scan_host(scan), device="cpu")
        # the unsharded run first, keeping each slot's part over the block
        # the sharded slot of the same step must hold: the mesh's block of
        # the slot's grid
        layout = pm.Mesh(mesh.shape, rank)
        want = {}

        def keep(step, p):
            for i, c in enumerate(p.slots):
                x0, x1, y0, y1 = layout.block(None, (c.width, c.height))
                want[step, i] = ((x0, y0), c.n_time, {
                    f: getattr(c, f)[x0:x1, y0:y1].clone() for f in SLOT_FIELDS})

        def compare(step, p):
            res["origins"][step] = [list(c.origin) for c in p.slots]
            for i, c in enumerate(p.slots):
                origin, n_time, fields = want[step, i]
                try:
                    pm.check_rank_block(c, mesh)
                except ValueError as e:
                    res["mismatches"].append(f"{step} slot {i}: {e}")
                if tuple(c.origin) != origin or c.n_time != n_time:
                    res["mismatches"].append(f"{step} slot {i}: origin {c.origin} x {c.n_time}, "
                                             f"want {origin} x {n_time}")
                    continue
                res["mismatches"] += [f"{step} slot {i} {f}" for f, w in fields.items()
                                      if not torch.equal(getattr(c, f), w)]

        drive(Pipeline("cpu"), whole, psf, keep)
        out, counts = drive(Pipeline("cpu", mesh=mesh), block, psf, compare)
        res.update(counts)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
