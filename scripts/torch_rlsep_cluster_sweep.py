#!/usr/bin/env python3
"""Block shapes of the cluster Richardson-Lucy kernel, compared on one GPU.

    python3 scripts/torch_rlsep_cluster_sweep.py [--seed 0]

Builds ``csrc/rlsep_cluster.cu`` once per block shape (``-DRL_STRIPS``:
strips of 256 threads a pass, ``-DRL_SR``: rows per strip), runs each on
the reference Apply's RL inputs (200x200x1024 synthetic scan, synthetic
PSF, default parameters: 25 bands on a 246x256 canvas) at cluster sizes 8
and 16, checks it against the plain version (per band 1e-3 * max) and two
runs bit for bit, and prints one JSON line per shape and size with its
median time from CUDA events; then the time of each launch (checkpoint
group) of the built default shape at both sizes, and the half-iteration
kernel's time in the same process.

Then where one iteration's time goes: one band alone (B = 1, a 246x256
canvas, 47 x 57 taps of reach 23 and 28 as the Apply's band 0), 200
iterations, in copies of the source with a part replaced (``PARTS``): the
axis-0 rows read from the CTA's own slab instead of their owners
(distributed shared memory left out), the axis-0 correlation left out, and
both correlations left out. Those copies compute wrong values on purpose and
are timed only. Needs a CUDA device; prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import half_iteration_route, synthetic_psf, synthetic_scan, time_ms  # noqa: E402

SHAPES = {"strips1_sr8": (1, 8), "strips2_sr8": (2, 8), "strips4_sr8": (4, 8),
          "strips1_sr16": (1, 16), "strips2_sr16": (2, 16)}

_AXIS0 = "blocked_correlation<kSR>(tqr, mr, acc, [&](int m) { return win[m][c]; });"
_AXIS1 = "blocked_correlation<kCB>(tqc, mc, acc, [&](int m) { return sp[m * (kPass + 1)]; });"
_OWNER = """        const int o = owner(h2, a.s, j);
        int olo, on;
        slab(h2, a.s, o, olo, on);
        const size_t off = (size_t)(j - olo) * L.ws;"""
_LOCAL = """        const int o = q, olo = lo;
        const size_t off = (size_t)min(max(j - lo, 0), n - 1) * L.ws;"""
#: source edits of the timing-only copies: (text, replacement) pairs
PARTS = {
    "axis0_rows_local": [(_OWNER, _LOCAL)],
    "no_axis0": [(_AXIS0, "for (int i = 0; i < kSR; ++i) acc[i] = win[hr + i][c];")],
    "no_axis0_axis1": [(_AXIS0, "for (int i = 0; i < kSR; ++i) acc[i] = win[hr + i][c];"),
                       (_AXIS1, "for (int i = 0; i < kCB; ++i) acc[i] = sp[(hc + i) * (kPass + 1)];")],
}


def build_variants(kernels):
    """Every block shape of SHAPES and every timing-only copy of PARTS."""
    out_dir = kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (kernels.CSRC / "rlsep_cluster.cu").read_text()
    jobs = {name: ([f"-DRL_STRIPS={strips}", f"-DRL_SR={sr}"], kernels.CSRC / "rlsep_cluster.cu")
            for name, (strips, sr) in SHAPES.items()}
    for name, edits in PARTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old[:40]!r}")
            text = text.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        jobs[name] = ([], path)
    procs = {}
    for name, (defines, src) in jobs.items():
        out = out_dir / f"rlsep_cluster_{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = kernels.declare(ctypes.CDLL(str(out)), "rlsep_cluster")
        regs = [x.strip() for x in log.splitlines() if "Used" in x or "spill" in x]
        libs[name] = (lib, regs)
    return libs


def run_cluster(lib, padded, px, py, n_iter, s, events=None):
    """The wrapper's launch loop on ``lib`` (no checkpoints)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    b, h2, w2 = padded.shape
    order = torch.as_tensor(np.argsort(-n_iter, kind="stable").astype(np.int32),
                            device=padded.device)
    n_dev = torch.as_tensor(n_iter.astype(np.int32), device=padded.device)
    u = padded.clone()
    stream = torch.cuda.current_stream().cuda_stream
    for i0, i1, nb in rlsep.launch_schedule(n_iter):
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        err = lib.thz_rlsep_cluster(u.data_ptr(), padded.data_ptr(), px.data_ptr(),
                                    py.data_ptr(), order.data_ptr(), n_dev.data_ptr(), nb, i0, i1,
                                    b, h2, w2, px.shape[1], py.shape[1], s, stream)
        if err != 0:
            raise RuntimeError(f"launch refused: CUDA error {err}")
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    return u


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import rlsep

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build(("rlsep", "rlsep_cluster"))
    libs = build_variants(kernels)
    dev = torch.device("cuda")
    t, cube = synthetic_scan(200, 200, 1024, seed=args.seed)
    geometry = dec.plan_bands(dec.DeconvolutionParams(), synthetic_psf(), t, (200, 200),
                              0.5, 0.5)
    padded, px, py, n_iter = dec.rl_inputs(torch.as_tensor(cube, device=dev), geometry)
    ref = rlsep.rl_bands_separable_plain(padded, px, py, n_iter)
    scale = ref.abs().amax(dim=(1, 2))
    for name, (lib, regs) in libs.items():
        if name in PARTS:
            continue
        for s in (16, 8):
            got = run_cluster(lib, padded, px, py, n_iter, s)
            again = run_cluster(lib, padded, px, py, n_iter, s)
            torch.cuda.synchronize()
            rel = float(((got - ref).abs().amax(dim=(1, 2)) / scale).max())
            assert torch.equal(got, again) and rel <= 1e-3, (name, s, rel)
            ms = time_ms(lambda: run_cluster(lib, padded, px, py, n_iter, s),
                         reps=5, inner=1, warm=1)
            print(json.dumps({"shape": name, "cluster_size": s, "ms": ms, "max_rel_err": rel,
                              "ptxas": regs, "card": card}), flush=True)
    default = kernels.load("rlsep_cluster")
    run_cluster(default, padded, px, py, n_iter, 16)  # the library's first launch loads it
    for s in (16, 8):
        events = []
        run_cluster(default, padded, px, py, n_iter, s, events)
        torch.cuda.synchronize()
        print(json.dumps({"per_launch_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
                          "schedule": rlsep.launch_schedule(n_iter), "cluster_size": s,
                          "card": card}), flush=True)
    def tiled_run():
        with half_iteration_route():
            rlsep.rl_bands_separable(padded, px, py, n_iter)

    tiled_ms = time_ms(tiled_run, reps=5, inner=1, warm=1)
    print(json.dumps({"half_iteration_ms": tiled_ms, "card": card}), flush=True)

    # one band alone: where an iteration's time goes
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.arange(47, device=dev, dtype=torch.float32) - 23
    y = torch.arange(57, device=dev, dtype=torch.float32) - 28
    px1 = torch.exp(-(x - 2.0) ** 2 / 60.0)[None].contiguous()
    py1 = torch.exp(-(y + 3.0) ** 2 / 90.0)[None].contiguous()
    one = (0.2 + torch.rand((1, 246, 256), device=dev, generator=gen)).contiguous()
    n1 = np.array([200])
    parts = {"full": default, **{name: libs[name][0] for name in PARTS}}
    for s in (16, 8):
        for name, lib in parts.items():
            ms = time_ms(lambda: run_cluster(lib, one, px1, py1, n1, s), reps=5, inner=2, warm=1)
            print(json.dumps({"one_band": name, "cluster_size": s,
                              "us_per_iteration": ms * 1e3 / int(n1[0]), "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
