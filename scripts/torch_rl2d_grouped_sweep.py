#!/usr/bin/env python3
"""The cluster 2-D Richardson-Lucy kernel and the grouped cluster kernel,
checked and timed on one GPU.

    python3 scripts/torch_rl2d_grouped_sweep.py [--seed 0] [--check]

Inputs: the reference Apply's RL inputs (200x200x1024 synthetic scan,
synthetic PSF, default parameters: 25 bands on a 246x256 canvas) and, for
``csrc/rl2d_cluster.cu``, band 0's canvas with an asymmetric 9x9 PSF at band
0's 408 iterations (``chip_smoke.py``'s ``rl2d_kernel_vs_plain`` case).

``--check`` (the short first run after a kernel change) builds the sources
and checks: the cluster 2-D kernel against the plain version on that case
and on ragged images (per image |kernel - plain| <= 1e-3 * max, two runs bit
for bit), the grouped kernel at G = 5 and on ragged stacks bit for bit
against ``rl_bands_separable``'s cluster route, a group past the fit
refused, and the libraries' shared-memory sizes against the modules'
mirrors. Prints one JSON line per check and the new kernels' ptxas lines.

Without ``--check`` it also times, in turns in this one process (device time
behind a spin, ``chip_smoke.device_ms``):

- rl2d: the cluster route against the tiled one (the previous design,
  ``csrc/rl2d.cu``), builds with other output rows a thread
  (``-DRL2_ROWS``), the tap crossover (square PSFs, both routes, 100
  iterations), and one iteration's parts in copies of the source with a part
  replaced (``PARTS``: halo rows read from the CTA's own slab, the
  correlation left out, both halves left out; they compute wrong values on
  purpose and are timed only);
- the grouped kernel: microseconds per band-iteration of one cluster (its
  time over G x 200) at G = 1, 2 and 5 on five copies of band 0 (47 x 57
  taps, 200 iterations) and the same parts,
  and the Apply's stack at G = 1, 2, 5 against the previous design of the
  group mode, commit 71e894e's ``csrc/rlsep.cu``; and the Apply's own
  cluster route (G = 1) against commit 71e894e's ``csrc/rlsep_cluster.cu``,
  where ``build/previous_design/`` holds the two sources::

    mkdir -p build/previous_design && for k in rlsep rlsep_cluster; do git show \\
      71e894e:thz_image_explorer_tpu_torch/csrc/$k.cu > build/previous_design/$k.cu; done

  (the directory is not part of a checkout; a source that is not that
  commit's is refused, since its calling convention may differ).

Writes every line also to ``chiprun_out/rl2d_grouped_sweep.jsonl``. Needs a
CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

OUT = Path(__file__).resolve().parents[1] / "chiprun_out" / "rl2d_grouped_sweep.jsonl"
PREVIOUS_DIR = Path(__file__).resolve().parents[1] / "build" / "previous_design"
#: the git blob ids of commit 71e894e's sources: the group mode's previous
#: design and the cluster route before the group template
PREVIOUS_BLOBS = {"rlsep": "1f7540162a1b47cc2317f782614b917defd9ff59",
                  "rlsep_cluster": "11e30235a0ae9c30caa099c2556f55cbf19fa11c"}
#: output rows a thread of the cluster 2-D kernel (-DRL2_ROWS)
ROWS = (2, 4, 8)
#: square PSF sizes of the tap crossover
CROSSOVER = (9, 11, 13, 15, 17, 19, 21, 25, 31)

_RL2_OWNER = """      const int o = owner(h2, a.s, j);
      int olo, on;
      slab(h2, a.s, o, olo, on);
      const size_t off = (size_t)(j - olo) * L.ws;"""
_RL2_LOCAL = """      const int o = q, olo = lo;
      const size_t off = (size_t)min(max(j - lo, 0), n - 1) * L.ws;"""
_GR_OWNER = """        const int o = owner(h2, a.s, j);
        int olo, on;
        slab(h2, a.s, o, olo, on);
        const size_t off = (size_t)(j - olo) * L.ws;"""
_GR_LOCAL = """        const int o = q, olo = lo;
        const size_t off = (size_t)min(max(j - lo, 0), n - 1) * L.ws;"""
_GR_AXIS0 = "blocked_correlation<kSR>(tqr, mr, acc, [&](int m) { return win[m][c]; });"
_GR_AXIS1 = ("blocked_correlation<kCB>(tqc, mc, acc, "
             "[&](int m) { return sp[m * (kPass + 1)]; });")
#: timing-only copies: (source, [(text, replacement), ...])
PARTS = {
    "rl2d_halo_local": ("rl2d_cluster", [(_RL2_OWNER, _RL2_LOCAL)]),
    "rl2d_no_correlation": ("rl2d_cluster", [
        ("for (int ta = 0; ta < L.ntr; ++ta) {", "for (int ta = 0; ta < 0; ++ta) {")]),
    "rl2d_barriers_only": ("rl2d_cluster", [
        ("half<T, false>(rows_u, srel, sp, bank_a, n, w2, L);", ""),
        ("half<T, true>(rows_rel, su, sp, bank_b, n, w2, L);", "")]),
    "grouped_halo_local": ("rlsep_cluster", [(_GR_OWNER, _GR_LOCAL)]),
    "grouped_no_correlation": ("rlsep_cluster", [
        (_GR_AXIS0, "for (int i = 0; i < kSR; ++i) acc[i] = win[hr + i][c];"),
        (_GR_AXIS1, "for (int i = 0; i < kCB; ++i) acc[i] = sp[(hc + i) * (kPass + 1)];")]),
    "grouped_barriers_only": ("rlsep_cluster", [
        ("      if (it < n_it[g]) {", "      if (false) {")]),
}


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def build_variants(kernels, with_previous):
    """The -DRL2_ROWS builds, the PARTS copies and, where present, the
    previous group mode: ``{name: (library, ptxas lines)}``; all nvcc
    processes at once."""
    out_dir = kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {f"rl2d_rows{r}": ("rl2d_cluster", [f"-DRL2_ROWS={r}"], kernels.CSRC /
                              "rl2d_cluster.cu") for r in ROWS}
    for name, (source, edits) in PARTS.items():
        text = (kernels.CSRC / f"{source}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {source}.cu no longer holds {old[:50]!r}")
            text = text.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        jobs[name] = (source, [], path)
    for name, blob in PREVIOUS_BLOBS.items():
        prev = PREVIOUS_DIR / f"{name}.cu"
        if with_previous and prev.exists():
            data = prev.read_bytes()
            got = hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()
            if got != blob:
                raise RuntimeError(f"{prev} is not 71e894e's {name}.cu (blob {got})")
            jobs[f"previous_{name}"] = (f"previous_{name}", [], prev)
    procs = {}
    for name, (source, defines, src) in jobs.items():
        out = out_dir / f"{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", str(out), str(src)]
        procs[name] = (source, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (source, proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        if source == "previous_rlsep":
            # u, rel, padded, px, py, order, counts, it0, it1, b, h2, w2, kr,
            # kc, group, stream
            lib.thz_rlsep.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
                [ctypes.c_void_p]
            lib.thz_rlsep.restype = ctypes.c_int
        elif source == "previous_rlsep_cluster":
            lib.thz_rlsep_cluster.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
                [ctypes.c_void_p]
            lib.thz_rlsep_cluster.restype = ctypes.c_int
        else:
            kernels.declare(lib, source)
        libs[name] = (lib, [x.strip() for x in log.splitlines() if "Used" in x or "spill" in x])
    return libs


def run_rl2d(lib, padded, psf, n_iter, s):
    """The cluster route's launch loop on ``lib``."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    u = padded.clone()
    stream = torch.cuda.current_stream().cuda_stream
    for i0, i1, _ in rlsep.launch_schedule(np.array([n_iter])):
        err = lib.thz_rl2d_cluster(u.data_ptr(), padded.data_ptr(), psf.data_ptr(), i1 - i0,
                                   *padded.shape, *psf.shape, s, stream)
        assert err == 0, f"rl2d_cluster launch refused: CUDA error {err}"
    return u


def run_grouped(lib, padded, px, py, n_iter, s, g):
    """The grouped mode's launch loop on ``lib``."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    b, h2, w2 = padded.shape
    order = torch.as_tensor(np.argsort(-n_iter, kind="stable").astype(np.int32),
                            device=padded.device)
    n_dev = torch.as_tensor(n_iter.astype(np.int32), device=padded.device)
    u = padded.clone()
    stream = torch.cuda.current_stream().cuda_stream
    for i0, i1, nb in rlsep.launch_schedule(n_iter):
        err = lib.thz_rlsep_grouped(u.data_ptr(), padded.data_ptr(), px.data_ptr(),
                                    py.data_ptr(), order.data_ptr(), n_dev.data_ptr(), nb, i0, i1,
                                    b, h2, w2, px.shape[1], py.shape[1], s, g, stream)
        assert err == 0, f"grouped launch refused: CUDA error {err}"
    return u


def run_cluster_route(lib, padded, px, py, n_iter, s):
    """``thz_rlsep_cluster``'s launch loop (the Apply's route) on ``lib``."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    b, h2, w2 = padded.shape
    order = torch.as_tensor(np.argsort(-n_iter, kind="stable").astype(np.int32),
                            device=padded.device)
    n_dev = torch.as_tensor(n_iter.astype(np.int32), device=padded.device)
    u = padded.clone()
    stream = torch.cuda.current_stream().cuda_stream
    for i0, i1, nb in rlsep.launch_schedule(n_iter):
        err = lib.thz_rlsep_cluster(u.data_ptr(), padded.data_ptr(), px.data_ptr(),
                                    py.data_ptr(), order.data_ptr(), n_dev.data_ptr(), nb, i0, i1,
                                    b, h2, w2, px.shape[1], py.shape[1], s, stream)
        assert err == 0, f"cluster launch refused: CUDA error {err}"
    return u


def run_previous_grouped(lib, padded, px, py, n_iter, g):
    """Commit 71e894e's group mode: two launches an iteration, ``g`` bands
    a block one after the other."""
    import torch

    b, h2, w2 = padded.shape
    max_iter = int(n_iter.max())
    order = torch.as_tensor(np.argsort(-n_iter, kind="stable").astype(np.int32),
                            device=padded.device)
    counts = np.ascontiguousarray((n_iter[None, :] > np.arange(max_iter)[:, None]).sum(axis=1),
                                  dtype=np.int32)
    u = padded.clone()
    rel = torch.empty_like(padded)
    err = lib.thz_rlsep(u.data_ptr(), rel.data_ptr(), padded.data_ptr(), px.data_ptr(),
                        py.data_ptr(), order.data_ptr(), counts.ctypes.data, 0, max_iter, b, h2,
                        w2, px.shape[1], py.shape[1], g, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"previous grouped launch refused: CUDA error {err}"
    return u


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="build and check only (no timing)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import rl2d, rlsep

    OUT.parent.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    logs = kernels.build(("rlsep", "rlsep_cluster", "rl2d", "rl2d_cluster"))
    emit({"ptxas": {k: [x.strip() for x in v.splitlines() if "Used" in x or "spill" in x]
                    for k, v in logs.items()}, "card": card})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t, cube = smoke.synthetic_scan(200, 200, 1024, seed=args.seed)
    geometry = dec.plan_bands(dec.DeconvolutionParams(), smoke.synthetic_psf(), t, (200, 200),
                              0.5, 0.5)
    padded, px, py, n_iter = dec.rl_inputs(torch.as_tensor(cube, device=dev), geometry)
    del cube
    _, h2, w2 = padded.shape
    kr, kc = px.shape[1], py.shape[1]

    # the layouts: library == module mirror
    lib2 = kernels.load("rl2d_cluster")
    libg = kernels.load("rlsep_cluster")
    for shape in [(h2, w2, 9, 9), (h2, w2, kr, kc), (37, 45, 9, 9), (11, 70, 5, 7),
                  (21, 26, 6, 4), (40, 33, 21, 3), (61, 97, 13, 11), (40, 1100, 9, 1001)]:
        for s in (1, 8, 16):
            if s <= shape[0]:
                lay = rl2d.cluster_layout(*shape, s)
                assert lib2.thz_rl2d_cluster_smem(*shape, s) == lay["bytes"], (shape, s)
                assert lib2.thz_rl2d_cluster_tile(shape[3]) == lay["tile"], shape
                for g in (1, 2, 5):
                    assert libg.thz_rlsep_grouped_smem(*shape, s, g) == \
                        rlsep.grouped_smem_bytes(*shape, s, g), (shape, s, g)
    emit({"layouts": "thz_rl2d_cluster_smem/tile and thz_rlsep_grouped_smem == the mirrors"})

    # rl2d: band 0's canvas, 9x9, n0 iterations; ragged images
    canvas, n0 = padded[0], int(n_iter[0])
    psf9 = torch.as_tensor(smoke.gauss2d(9, 9, 1.3, -0.8, 1.5, 2.2), device=dev)
    err, rel, counted = smoke.check_rl2d(canvas, psf9, n0, "band0 9x9", "cluster")
    assert counted == (2 * len(rlsep.launch_schedule([n0])), 0), counted
    emit({"rl2d": "band0_9x9", "n_iter": n0, "max_abs_err": err, "max_rel_err": rel,
          "launches": counted, "card": card})
    for label, (img, psf, n) in smoke.ragged_rl2d_cases(dev, gen).items():
        route, s = rl2d.route_for(*img.shape, *psf.shape)
        err, rel, counted = smoke.check_rl2d(img, psf, n, label, route)
        emit({"rl2d": label, "route": route, "cluster_size": s,
              "tile": rl2d.cluster_layout(*img.shape, *psf.shape, s or 1)["tile"],
              "max_rel_err": rel, "launches": counted})

    # grouped: bit for bit the cluster route
    ref = rlsep.rl_bands_separable(padded, px, py, n_iter)
    for g in (5, 1):
        before = rlsep.rl_bands_separable_grouped.launches
        got = rlsep.rl_bands_separable_grouped(padded, px, py, n_iter, group=g)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"group {g} differs from the cluster route"
        assert rlsep.rl_bands_separable_grouped.launches - before == \
            len(rlsep.launch_schedule(n_iter))
    for label, inputs in smoke.ragged_rl_cases(dev, gen).items():
        b = inputs[0].shape[0]
        ref = rlsep.rl_bands_separable(*inputs)
        shape = (*inputs[0].shape[1:], inputs[1].shape[1], inputs[2].shape[1])
        done = []
        for g in sorted({2, b}):
            if b % g == 0 and rlsep.cluster_size_for(*shape, g) is not None:
                got = rlsep.rl_bands_separable_grouped(*inputs, group=g)
                torch.cuda.synchronize()
                assert torch.equal(got, ref), (label, g)
                done.append(g)
        emit({"grouped": label, "bit_identical_groups": done})
    try:
        rlsep.rl_bands_separable_grouped(padded[:6].contiguous(), px[:6].contiguous(),
                                         py[:6].contiguous(), n_iter[:6], group=6)
        raise AssertionError("group 6 at the Apply's canvas was not refused")
    except ValueError as e:
        assert "do not fit" in str(e), e
    emit({"grouped": "apply", "bit_identical_groups": [5, 1], "group6": "ValueError",
          "card": card})
    if args.check:
        return 0

    # ---- timing, in turns
    libs = build_variants(kernels, with_previous=True)
    emit({"variants_ptxas": {k: v[1] for k, v in libs.items()}, "card": card})
    s16 = rl2d.route_for(h2, w2, 9, 9)[1]
    cluster_fn = lambda: rl2d.richardson_lucy_direct(canvas, psf9, n0)  # noqa: E731

    def tiled_fn():
        with smoke.tiled_rl2d():
            rl2d.richardson_lucy_direct(canvas, psf9, n0)

    rows = {}
    for name, fn in (("cluster", cluster_fn), ("tiled", tiled_fn), ("tiled", tiled_fn),
                     ("cluster", cluster_fn)):
        rows.setdefault(name, []).append(smoke.device_ms(fn, reps=5, inner=1, warm=1))
    for r in ROWS:
        lib = libs[f"rl2d_rows{r}"][0]
        rows[f"rows{r}"] = smoke.device_ms(lambda: run_rl2d(lib, canvas, psf9, n0, s16), reps=5,
                                           inner=1, warm=1)
    emit({"rl2d_ms": rows, "n_iter": n0, "shape": [h2, w2, 9, 9],
          "floor_ms": smoke.rl2d_floor_ms(h2, w2, 9, 9, n0, s16), "card": card})

    # rl2d: one iteration's parts (200 iterations)
    parts = {"full": lib2, **{n: libs[n][0] for n in PARTS if n.startswith("rl2d")}}
    emit({"rl2d_us_per_iteration": {
        n: smoke.device_ms(lambda: run_rl2d(lib, canvas, psf9, 200, s16), reps=5, inner=1,
                           warm=1) * 1e3 / 200 for n, lib in parts.items()}, "card": card})

    # the tap crossover: square PSFs, 100 iterations, both routes in turns
    crossover = {}
    for k in CROSSOVER:
        psf = torch.as_tensor(smoke.gauss2d(k, k, 0.7, -0.4, k / 4, k / 3), device=dev)
        lay = rl2d.cluster_layout(h2, w2, k, k, 16)
        c = smoke.device_ms(lambda: run_rl2d(lib2, canvas, psf, 100, 16), reps=3, inner=1,
                            warm=1)

        def tiled_k():
            with smoke.tiled_rl2d():
                rl2d.richardson_lucy_direct(canvas, psf, 100)

        tl = smoke.device_ms(tiled_k, reps=3, inner=1, warm=1)
        crossover[k * k] = dict(k=k, tile=lay["tile"], cluster_ms=c, tiled_ms=tl)
        emit({"crossover_taps": k * k, **crossover[k * k], "card": card})
    wins = [taps for taps, v in crossover.items() if v["cluster_ms"] < v["tiled_ms"]]
    emit({"crossover": {"cluster_wins_up_to_taps": max(wins) if wins else None,
                        "module_constant": rl2d.CLUSTER_MAX_TAPS}, "card": card})

    # grouped: us per band-iteration at G = 1, 2, 5 on five copies of band 0
    x = torch.arange(kr, device=dev, dtype=torch.float32) - kr // 2
    y = torch.arange(kc, device=dev, dtype=torch.float32) - kc // 2
    px5 = torch.exp(-(x - 2.0) ** 2 / 60.0).repeat(5, 1).contiguous()
    py5 = torch.exp(-(y + 3.0) ** 2 / 90.0).repeat(5, 1).contiguous()
    five = (0.2 + torch.rand((5, h2, w2), device=dev, generator=gen)).contiguous()
    n5 = np.full(5, 200)
    gparts = {"full": libg, **{n: libs[n][0] for n in PARTS if n.startswith("grouped")}}
    per = {}
    for turn in range(2):
        for g in (1, 2, 5):
            for name, lib in gparts.items():
                ms = smoke.device_ms(lambda: run_grouped(lib, five, px5, py5, n5, 16, g),
                                     reps=3, inner=1, warm=1)
                # a cluster's band-iterations: its G bands (1, 2, 2 or 5) x 200
                per.setdefault(f"G{g}", {}).setdefault(name, []).append(
                    ms * 1e3 / (g * 200))
    emit({"grouped_us_per_band_iteration": per, "bands": 5, "n_iter": 200,
          "shape": [h2, w2, kr, kc], "card": card})

    # grouped on the Apply's stack: G = 1, 2, 5 and the previous design
    apply = {}
    for g in (1, 2, 5, 5, 2, 1):
        apply.setdefault(f"G{g}", []).append(smoke.device_ms(
            lambda: run_grouped(libg, padded, px, py, n_iter, 16, g), reps=3, inner=1, warm=1))
    if "previous_rlsep" in libs:
        prev = libs["previous_rlsep"][0]
        got = run_previous_grouped(prev, padded, px, py, n_iter, 5)
        ref = rlsep.rl_bands_separable_plain(padded, px, py, n_iter)
        smoke.rl_errors(got, ref, "previous group mode")
        apply["previous_G5"] = smoke.device_ms(
            lambda: run_previous_grouped(prev, padded, px, py, n_iter, 5), reps=3, inner=1,
            warm=1)
        apply["G5_after"] = smoke.device_ms(
            lambda: run_grouped(libg, padded, px, py, n_iter, 16, 5), reps=3, inner=1, warm=1)
    else:
        apply["previous_G5"] = "build/previous_design/rlsep.cu is not in this checkout"
    emit({"grouped_apply_ms": apply, "shape": list(padded.shape), "n_iter_sum":
          int(n_iter.sum()), "card": card})

    # the Apply's cluster route: this source's G = 1 kernel against 71e894e's
    if "previous_rlsep_cluster" in libs:
        prev = libs["previous_rlsep_cluster"][0]
        assert torch.equal(run_cluster_route(prev, padded, px, py, n_iter, 16),
                           run_cluster_route(libg, padded, px, py, n_iter, 16))
        route = {}
        for name, lib in (("this", libg), ("previous", prev), ("previous", prev),
                          ("this", libg)):
            route.setdefault(name, []).append(smoke.device_ms(
                lambda: run_cluster_route(lib, padded, px, py, n_iter, 16), reps=5, inner=1,
                warm=1))
        emit({"cluster_route_ms": route, "bit_identical": True, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
