#!/usr/bin/env python3
"""Block shapes of the cluster Richardson-Lucy kernel, compared on one GPU.

    python3 scripts/torch_rlsep_cluster_sweep.py [--seed 0] [--routes-only]

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
are timed only.

Then the two routes of each checkpoint launch (``--routes-only``: this part
alone), at the Apply's RL inputs of the 200x200 and the 512x512 scan (a
246x256 and a 558x568 canvas, the same 25 bands): every launch of the
schedule timed on the cluster route and on the wide route (``rlsep.
launch_plan`` with the crossover set so that none, or every launch
``rlsep.wide_blocks`` can split, goes wide), device time from CUDA events recorded at the
wrapper's checkpoints behind a spin, the three outputs (cluster, wide, the
package's rule) bit for bit equal; the card's SMs; at 512x512 a launch of
seven bands (the seven with the most iterations, 50 each: a rank's subset
of a sharded Apply can hold seven) on both routes; and band 0 alone for 100
iterations, µs per iteration on the cluster route and on the wide route at
several block counts above the cluster's. These are the data behind
``rlsep.launch_plan``'s rule. Needs a CUDA device; prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    _patched, half_iteration_route, rl_route, synthetic_psf, synthetic_scan, time_ms)

#: cycles the stream spins before a timed run (~10 ms), longer than the host
#: needs to queue its launches
_HOLD = 20_000_000

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


_BARRIER = "    band_barrier(arrivals, target);"
_STAGE_U = "    stage_rows(stage_u, src_u, count, bar, phase);"
_STAGE_REL = "    stage_rows(stage_rel, src_rel, count, bar, phase);"
_HALF0 = ("    half<false, true>(rows_u, rb + (size_t)lo * w2, pb, tr_a, tc_a, strip, n, hr, hc, L, "
          "w2);")
_HALF1 = ("    half<true, true>(rows_rel, ub + (size_t)lo * w2, pb, tr_b, tc_b, strip, n, hr, hc, L, "
          "w2);")
#: timing-only copies of the wide route: its barrier, its staging or its two
#: halves left out
WIDE_PARTS = {
    "wide_no_barrier": [(_BARRIER, "    __syncthreads();")],
    "wide_no_stage": [(_STAGE_U, ""), (_STAGE_REL, "")],
    "wide_no_stage_no_barrier": [(_BARRIER, "    __syncthreads();"), (_STAGE_U, ""),
                                 (_STAGE_REL, "")],
    "wide_no_halves": [(_HALF0, ""), (_HALF1, "")],
}


def build_variants(kernels, shapes=True):
    """Every block shape of SHAPES (``shapes``) and every timing-only copy
    of PARTS and WIDE_PARTS."""
    out_dir = kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (kernels.CSRC / "rlsep_cluster.cu").read_text()
    jobs = {name: ([f"-DRL_STRIPS={strips}", f"-DRL_SR={sr}"], kernels.CSRC / "rlsep_cluster.cu")
            for name, (strips, sr) in SHAPES.items() if shapes}
    for name, edits in {**PARTS, **WIDE_PARTS}.items():
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


def apply_rl_inputs(size, seed, dev):
    """The Apply's RL inputs for a synthetic size x size x 1024 scan with
    the synthetic PSF and default parameters."""
    import torch

    from thz_image_explorer_tpu_torch.ops import deconvolution as dec

    t, cube = synthetic_scan(size, size, 1024, seed=seed)
    geometry = dec.plan_bands(dec.DeconvolutionParams(), synthetic_psf(), t, (size, size),
                              0.5, 0.5)
    return dec.rl_inputs(torch.as_tensor(cube, device=dev), geometry)


def launch_ms(inputs, route, reps=5):
    """``rl_bands_separable`` on ``route`` (``chip_smoke.rl_route``:
    ``"cluster"``, ``"wide"`` or the package's ``"rule"``): its output and
    the median device ms of each launch over ``reps`` runs (CUDA events
    recorded at each checkpoint, the runs queued behind a spin)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    runs = []
    for _ in range(reps + 1):
        events = []

        def mark(_done, _total):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            return False

        torch.cuda.synchronize()
        torch.cuda._sleep(_HOLD)
        with rl_route(route):
            u = rlsep.rl_bands_separable(*inputs, between=mark)
        mark(0, 0)
        torch.cuda.synchronize()
        runs.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    return u, [statistics.median(r[i] for r in runs[1:]) for i in range(len(runs[0]))]


def band0_wide_parts(inputs, libs, counts, card):
    """Band 0 alone for 100 iterations on the wide route at each block
    count of ``counts``, the built source and each timing-only copy of
    WIDE_PARTS: µs per iteration."""
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import rlsep

    padded, px, py, n_iter = inputs
    b0 = int(np.argmax(n_iter))
    one = (padded[b0:b0 + 1].contiguous(), px[b0:b0 + 1].contiguous(),
           py[b0:b0 + 1].contiguous(), np.array([100]))
    parts = {"full": kernels.load("rlsep_cluster"), **{k: libs[k][0] for k in WIDE_PARTS}}
    for c in counts:
        for name, lib in parts.items():
            with _patched(kernels, "load", lambda _name, lib=lib: lib), \
                    _patched(rlsep, "wide_blocks", lambda *_a, c=c: (c,)):
                _, ms = launch_ms(one, "wide")
            print(json.dumps({"canvas": list(padded.shape[1:]), "wide_part": name, "blocks": c,
                              "us_per_iteration": sum(ms) * 10, "card": card}), flush=True)


def routes(size, seed, dev, card, libs=None):
    """Each launch's device ms on both routes at the ``size``² Apply's RL
    inputs, the outputs bit for bit; band 0 alone at several block counts."""
    import torch

    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import rlsep

    inputs = apply_rl_inputs(size, seed, dev)
    padded, px, py, n_iter = inputs
    _, h2, w2 = padded.shape
    kr, kc = px.shape[1], py.shape[1]
    s = rlsep.cluster_size_for(h2, w2, kr, kc)
    sms = rlsep._sms(dev.index or 0)
    smem = kernels.load("rlsep_cluster").thz_rlsep_wide_smem
    for rows in (8, 9, 16, 33, -(-h2 // 16)):
        assert smem(h2, w2, kr, kc, rows) == rlsep.wide_smem_bytes(h2, w2, kr, kc, rows), rows
    cluster, cluster_ms = launch_ms(inputs, "cluster")
    wide, wide_ms = launch_ms(inputs, "wide")
    rule, rule_ms = launch_ms(inputs, "rule")
    torch.cuda.synchronize()
    equal = torch.equal(cluster.view(torch.int32), wide.view(torch.int32)) and \
        torch.equal(cluster.view(torch.int32), rule.view(torch.int32))
    with rl_route("wide"):
        forced = rlsep.launch_plan(n_iter, h2, w2, kr, kc, s, sms)
    plan = rlsep.launch_plan(n_iter, h2, w2, kr, kc, s, sms)
    for k, ((i0, i1, nb, blocks), (*_, chosen)) in enumerate(zip(forced, plan)):
        print(json.dumps({"canvas": [h2, w2], "launch": k, "iterations": [i0, i1], "nb": nb,
                          "wide_blocks": blocks, "cluster_ms": cluster_ms[k],
                          "wide_ms": wide_ms[k] if blocks else None,
                          "rule": "wide" if chosen else "cluster", "rule_ms": rule_ms[k],
                          "card": card}), flush=True)
    print(json.dumps({"canvas": [h2, w2], "sms": sms, "cluster_size": s,
                      "cluster_total_ms": sum(cluster_ms), "wide_total_ms": sum(wide_ms),
                      "rule_total_ms": sum(rule_ms), "bit_for_bit": equal, "card": card}),
          flush=True)
    assert equal, f"{size}: the routes differ"
    del cluster, wide, rule
    if size == 512:
        # seven bands, 50 iterations each: one launch, on both routes
        top = torch.as_tensor(np.argsort(-n_iter, kind="stable")[:7], device=dev)
        seven = tuple(x.index_select(0, top).contiguous() for x in (padded, px, py))
        seven += (np.full(7, 50),)
        (uc, ms_c), (uw, ms_w) = launch_ms(seven, "cluster"), launch_ms(seven, "wide")
        with rl_route("wide"):
            blocks = rlsep.launch_plan(seven[3], h2, w2, kr, kc, s, sms)[0][3]
        (rule_plan,) = rlsep.launch_plan(seven[3], h2, w2, kr, kc, s, sms)
        print(json.dumps({"canvas": [h2, w2], "seven_bands": 50, "wide_blocks": blocks,
                          "cluster_ms": sum(ms_c), "wide_ms": sum(ms_w),
                          "rule": "wide" if rule_plan[3] else "cluster",
                          "bit_for_bit": torch.equal(uc.view(torch.int32), uw.view(torch.int32)),
                          "card": card}), flush=True)
        del seven, uc, uw
    # band 0 alone, 100 iterations
    b0 = int(np.argmax(n_iter))
    one = (padded[b0:b0 + 1].contiguous(), px[b0:b0 + 1].contiguous(),
           py[b0:b0 + 1].contiguous(), np.array([100]))
    counts = [None] + [c for c in (17, 24, 32, 40, 48, 56, 64, 69, 96, 132)
                       if s < c <= h2 // rlsep.WIDE_MIN_ROWS and rlsep.wide_smem_bytes(
                           h2, w2, kr, kc, -(-h2 // c)) <= rlsep.SMEM_PER_BLOCK]
    ref = None
    for c in counts:
        with _patched(rlsep, "wide_blocks", lambda *_a, c=c: (c,)):
            u, ms = launch_ms(one, "cluster" if c is None else "wide")
        ref = u if ref is None else ref
        print(json.dumps({"canvas": [h2, w2], "band0_alone": "cluster" if c is None else "wide",
                          "blocks": s if c is None else c, "us_per_iteration": sum(ms) * 10,
                          "bit_for_bit": torch.equal(u.view(torch.int32), ref.view(torch.int32)),
                          "card": card}), flush=True)
    del one, ref
    if libs is not None:
        band0_wide_parts(inputs, libs, counts[-2:], card)
    del inputs, padded, px, py
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--routes-only", action="store_true",
                    help="time the two routes of each checkpoint launch only")
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
    dev = torch.device("cuda", torch.cuda.current_device())
    if args.routes_only:
        libs = build_variants(kernels, shapes=False)
        for name in WIDE_PARTS:
            print(json.dumps({"variant": name, "ptxas": libs[name][1]}), flush=True)
        for size in (200, 512):
            routes(size, args.seed, dev, card, libs)
        return 0
    libs = build_variants(kernels)
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
    for size in (200, 512):
        routes(size, args.seed, dev, card, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
