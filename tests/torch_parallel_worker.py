"""One rank of the port's multi-process runs (``tests/test_torch_parallel.py``).

Started by ``torch.multiprocessing`` with the spawn method, one process a
rank, joined over gloo on the CPU through a ``file://`` store. Each rank
opens only its block of the scan file (``parallel.open_scan_sharded``),
runs the sharded update steps (each output on the mesh's block of the
output grid, downscaled or not), the sharded Apply (and one cancelled on a
single rank), the sharded live view, and writes what it got to
``rank<r>.npz`` for the parent to compare with the unsharded port and the
JAX package. It imports neither ``jax`` nor the JAX package; a failure is
written to ``rank<r>.err``.
"""

from __future__ import annotations

import os
import traceback

#: lean_update's ROI stack: (x0, x1, y0, y1) boxes on the output grid as
#: fractions of its size, and the selected pixel as fractions
ROI_BOXES = ((0.1, 0.5, 0.1, 0.6), (0.5, 1.0, 0.4, 1.0), (0.2, 0.3, 0.7, 0.9))
PIXEL = (0.55, 0.3)
#: the steps each rank runs: (name, StepConfig keywords); 3 and 7 divide
#: neither the 30x22 grid nor its 1x2 and 2x2 blocks
STEPS = (
    ("all_stages", dict(td_before_active=True, fd_active=True, notch_active=True,
                        td_after_active=True)),
    ("scale2", dict(scale=2, fd_active=True, notch_active=True)),
    ("scale3", dict(scale=3, td_before_active=True, fd_active=True, notch_active=True)),
    ("scale7", dict(scale=7, fd_active=True, td_after_active=True, avg_in_fourier_space=True)),
)
DECONV = dict(n_iterations=80, n_filters=6, start_freq=0.25, end_freq=4.0)
VIEW = dict(max_points=3000, opacity_threshold=0.005, contrast=1.0)


def roi_masks(x: int, y: int):
    import numpy as np

    masks = np.zeros((len(ROI_BOXES), x, y), np.float32)
    for m, (a, b, c, d) in zip(masks, ROI_BOXES):
        m[int(a * x): int(b * x), int(c * y): int(d * y)] = 1.0
    return masks


def pixel(x: int, y: int) -> tuple[int, int]:
    return int(PIXEL[0] * x), int(PIXEL[1] * y)


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
    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import voxel
    from thz_image_explorer_tpu_torch.parallel import open_scan_sharded
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel.step import StepConfig, StepParams, lean_update

    mesh = pm.init("cpu", init_method=f"file://{store}", rank=rank, world_size=world,
                   timeout_s=90.0)
    out = {"mesh_shape": np.asarray(mesh.shape)}
    try:
        whole, _ = finalize_scan(open_scan_host(scan), device="cpu")
        mine = pm.shard_cube(whole, mesh)
        out["gathered_equals_whole"] = np.asarray(torch.equal(
            pm.grid_gather(mine.data, mesh, mine.grid, mine.origin), whole.data))
        for name, kw in STEPS:
            cube, img, md = open_scan_sharded(scan, mesh, device="cpu")
            out[f"{name}_open"] = cube.data.numpy()
            out[f"{name}_open_img"] = img.numpy()
            out[f"{name}_origin"] = np.asarray(cube.origin)
            cfg = StepConfig(**kw)
            gx, gy = cube.grid[0] // cfg.scale, cube.grid[1] // cfg.scale
            out[f"{name}_out_origin"] = np.asarray(mesh.block(None, (gx, gy))[::2])
            got = lean_update(cube, StepParams(), cfg, torch.as_tensor(roi_masks(gx, gy)),
                              pixel(gx, gy), mesh)
            out.update({f"{name}_{k}": v.numpy() for k, v in got.items()
                        if not v.is_complex()})
            out[f"{name}_avg_fft"] = torch.view_as_real(got["avg_fft"]).numpy()

        cube, _, _ = open_scan_sharded(scan, mesh, device="cpu")
        geometry = dec.plan_bands(dec.DeconvolutionParams(**DECONV), load_psf(psf),
                                  cube.time.numpy(), cube.grid, cube.dx, cube.dy)
        progress = []
        u = dec.deconvolve_cube(cube.data, geometry, progress.append, mesh=mesh,
                                origin=cube.origin, grid=cube.grid)
        out["deconv"] = u.numpy()
        out["deconv_progress"] = np.asarray(progress)
        # a cancel on the last rank only, at its second checkpoint
        asked = []

        def cancelled():
            asked.append(1)
            return rank == world - 1 and len(asked) >= 2

        stopped = dec.deconvolve_cube(cube.data, geometry, cancelled=cancelled, mesh=mesh,
                                      origin=cube.origin, grid=cube.grid)
        out["cancel_returned_none"] = np.asarray(stopped is None)
        out["cancel_checks"] = np.asarray(len(asked))

        t = cube.time.numpy()
        pos, rgba, *dims, thr = voxel.extract_instances_topk(
            cube.data, float(t[-1] - t[0]), 1, (*cube.grid, cube.n_time), mesh=mesh,
            origin=cube.origin, grid=cube.grid, **VIEW)
        out.update(view_pos=pos, view_rgba=rgba, view_dims=np.asarray(dims),
                   view_thr=np.asarray(thr))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
