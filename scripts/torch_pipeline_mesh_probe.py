#!/usr/bin/env python3
"""Which slots of the sharded ``Pipeline`` differ from the single device's?

    python3 scripts/torch_pipeline_mesh_probe.py [--n-time 1023] [--size 200]
        [--worlds 2 4] [--device cuda] [--tilt 3 2]

Saves the synthetic size x size x n_time scan of ``chip_smoke.py`` as a
memory-mapped ``.npy`` and, for each world size, spawns that many ranks
over gloo (all on the one card, or on the CPU with ``--device cpu``). Each
rank runs the commands below on an unsharded ``Pipeline`` of the whole scan,
keeping each slot's part over the block the mesh gives it, then opens only
its block (``parallel.open_arrays_sharded``) into ``Pipeline(mesh=)`` and
runs the same commands, comparing after each one every slot's ``data``,
``fft``, ``amplitudes`` and ``phases`` and the final slot's intensity image
with the kept parts, bit for bit. Commands: the open with the main path's
filters (TD band-pass before the FFT, FD band-pass, water notch), with
``--tilt X Y`` a tilt to (X°, Y°) (at 200x200x1024, (3, 2) gives T = 1606
at scale 1 and 1600 at scale 3, (3, 2.1) 1616 and 1610), 3 slider steps, a
downscale to 3 and back to 1. Prints one JSON line per world: for each
command, the differing ``slot:stage:field`` entries of each rank (the
first slot in chain order says where the values part), and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import scan_metadata, synthetic_scan  # noqa: E402

FILTERS = ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch")
FIELDS = ("data", "fft", "amplitudes", "phases")


def commands(tilt=None):
    def tilt_to(xy):
        def run(p):
            stage = p.filters["tilt_compensation"]
            stage.active, (stage.tilt_x, stage.tilt_y) = True, xy
            p.update_filter("tilt_compensation")
        return run

    def slider(v):
        def run(p):
            p.config.fft_window[0] = v
            p.run_from(p.fft_index)
        return run

    def scale(s):
        def run(p):
            p.config.scale_factor = s
            p.run_from(p.scaling_index)
        return run

    tilted = [("tilt", tilt_to(tuple(tilt)))] if tilt else []
    return tilted + [("slider1", slider(1.05)), ("slider2", slider(1.10)),
                     ("slider3", slider(1.15)), ("downscale3", scale(3)), ("downscale1", scale(1))]


def drive(pipeline, cube, after, tilt):
    for uuid in FILTERS:
        pipeline.filters[uuid].active = True
    pipeline.set_input(cube)
    after("open", pipeline)
    for name, run in commands(tilt):
        run(pipeline)
        after(name, pipeline)


def rank_main(rank, world, store, npy, t, device, outdir, tilt):
    try:
        _rank_main(rank, world, store, npy, t, device, outdir, tilt)
    except BaseException:
        pathlib.Path(outdir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _rank_main(rank, world, store, npy, t, device, outdir, tilt):
    import torch
    import torch.distributed as dist

    from thz_image_explorer_tpu_torch.io.dotthz import finalize_scan, open_scan_arrays
    from thz_image_explorer_tpu_torch.ops.intensity import intensity_image
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_arrays_sharded
    from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline

    torch.set_num_threads(1)
    mesh = pm.init(device, backend="gloo", init_method=f"file://{store}", rank=rank,
                   world_size=world, timeout_s=300.0)
    layout = pm.Mesh(mesh.shape, rank)
    mm = np.load(npy, mmap_mode="r")
    whole, _ = finalize_scan(open_scan_arrays(t, np.load(npy), scan_metadata(0.5)), device)
    want, diffs = {}, {}

    def keep(name, p):
        for i, c in enumerate(p.slots):
            x0, x1, y0, y1 = layout.block(None, c.grid_wh)
            want[name, i] = {f: getattr(c, f)[x0:x1, y0:y1].clone() for f in FIELDS}
        x0, x1, y0, y1 = layout.block(None, p.output.grid_wh)
        want[name, "image"] = intensity_image(p.output.data)[x0:x1, y0:y1].clone()

    def compare(name, p):
        bad = []
        for i, c in enumerate(p.slots):
            for f, w in want[name, i].items():
                g = getattr(c, f)
                if g.shape != w.shape or not torch.equal(g, w):
                    bad.append(f"{i}:{p.chain[i]}:{f}")
        if not torch.equal(intensity_image(p.output.data), want[name, "image"]):
            bad.append("image")
        diffs[name] = bad

    drive(Pipeline(device), whole, keep, tilt)
    del whole
    block, _, _ = open_arrays_sharded(t, mm, mesh, metadata=scan_metadata(0.5), device=device)
    drive(Pipeline(device, mesh=mesh), block, compare, tilt)
    pathlib.Path(outdir, f"rank{rank}.json").write_text(json.dumps(diffs))
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-time", type=int, default=1023)
    ap.add_argument("--size", type=int, default=200)
    ap.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tilt", type=float, nargs=2, default=None, metavar=("X", "Y"),
                    help="tilt compensation (degrees) after the open")
    args = ap.parse_args()

    import torch

    card = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("probe: CUDA is not available", file=sys.stderr)
            return 1
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        from thz_image_explorer_tpu_torch import kernels

        kernels.build()
    t, cube = synthetic_scan(args.size, args.size, args.n_time, seed=args.seed)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        npy = str(pathlib.Path(tmp, "scan.npy"))
        np.save(npy, cube)
        ctx = torch.multiprocessing.get_context("spawn")
        for world in args.worlds:
            wdir = pathlib.Path(tmp, f"world{world}")
            wdir.mkdir()
            t0 = time.perf_counter()
            procs = [ctx.Process(target=rank_main, daemon=True,
                                 args=(r, world, str(wdir / "store"), npy, t, args.device,
                                       str(wdir), args.tilt))
                     for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=600)
                if p.is_alive():
                    p.kill()
            errors = {e.name: e.read_text()[-2000:] for e in wdir.glob("rank*.err")}
            ranks = [json.loads((wdir / f"rank{r}.json").read_text())
                     if (wdir / f"rank{r}.json").exists() else None for r in range(world)]
            ok = ok and not errors and all(r is not None for r in ranks)
            print(json.dumps({"card": card, "n_time": args.n_time, "size": args.size,
                              "tilt": args.tilt,
                              "world": world, "seconds": time.perf_counter() - t0,
                              "differ": ranks, "errors": errors}), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
