#!/usr/bin/env python3
"""Shapes and parts of the FFT stage's polar kernel (``csrc/polar.cu``),
compared on one GPU.

    python3 scripts/torch_polar_sweep.py [--seed 0]

Builds ``csrc/polar.cu`` once per launch shape (``-DPOLAR_WARPS``: warps a
block, ``-DPOLAR_BLOCKS_PER_SM``: resident blocks an SM, ``-DPOLAR_UNROLL``:
chunks of 32 bins loaded ahead) and once per copy of the source in
``VARIANTS`` (edits by exact text: the script raises where a kernel change
leaves one unmatched), all nvcc processes at once. A variant is either
another design of the same function, checked bit for bit against the
package's build, or a part (``copies``: the loads, the wrap, the scan and
the stores without ``hypotf`` and ``atan2f``; ``arithmetic``: everything
but the loads and stores), which computes wrong values on purpose and is
only timed. Each build is timed by ``chip_smoke.device_ms`` (calls queued
behind a spin: device time) on 512x512 spectra at F = 513 and 825 (the
drag and tilt cells' shapes), the package's build first and last. Prints
one JSON line per build and writes them to
``chiprun_out/polar_sweep.jsonl``, the SASS of the package's build to
``chiprun_out/polar.sass``. Needs a CUDA device; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
#: (warps a block, blocks an SM, chunks ahead) of the shape builds
SHAPES = {"w8_b3_u8": (8, 3, 8), "w8_b2_u8": (8, 2, 8), "w4_b6_u8": (4, 6, 8),
          "w8_b4_u8": (8, 4, 8), "w8_b3_u12": (8, 3, 12), "w8_b6_u4": (8, 6, 4)}

_SCAN_OLD = """        const float sum = __fadd_rn(v, __shfl_sync(kFull, v, (lane & ~(2 * s - 1)) + s - 1));
        v = lane & s ? sum : v;"""
_SCAN_NEW = """        const float t = __shfl_sync(kFull, v, (lane & ~(2 * s - 1)) + s - 1);
        if (lane & s) v = __fadd_rn(v, t);"""
_ARITH_OLD = ("      next[u] = r1 < a.rows && k < a.f ? a.spec[r1 * a.f + k] : "
              "make_float2(0.f, 0.f);")
_ARITH_NEW = "      next[u] = make_float2((float)(k - 300), (float)((k * 7) % 61 - 30));"
_STORE_OLD = """        amp[k] = m;
        phase[k] = v;"""
_STORE_NEW = """        if (m == -1.f) amp[k] = m;
        if (v == 1.2345e30f) phase[k] = v;"""
_MATH_OLD = """      const float m = hypotf(z[u].x, z[u].y);
      const float g = atan2f(z[u].y, z[u].x);"""
_MATH_NEW = """      const float m = z[u].x;
      const float g = z[u].y;"""
#: {name: (edits, bit for bit with the package's build, extra nvcc flags)}
VARIANTS = {
    "predicated_scan": (((_SCAN_OLD, _SCAN_NEW),), True, []),
    "part_copies": (((_MATH_OLD, _MATH_NEW),), False, []),
    "part_arithmetic": (((_ARITH_OLD, _ARITH_NEW), (_STORE_OLD, _STORE_NEW)), False, []),
}


def variant_source(edits) -> str:
    from thz_image_explorer_tpu_torch import kernels

    text = (kernels.CSRC / "polar.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"edit not matched once in csrc/polar.cu: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_all():
    """{build name: (library, path)}: the package's build, each shape and
    each variant, all nvcc processes at once."""
    from thz_image_explorer_tpu_torch import kernels

    kernels.build(("polar",))
    work = ROOT / "build" / "polar_sweep"
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (w, b, u) in SHAPES.items():
        jobs[name] = (kernels.CSRC / "polar.cu",
                      [f"-DPOLAR_WARPS={w}", f"-DPOLAR_BLOCKS_PER_SM={b}", f"-DPOLAR_UNROLL={u}"])
    for name, (edits, _, flags) in VARIANTS.items():
        src = work / f"{name}.cu"
        src.write_text(variant_source(edits))
        jobs[name] = (src, flags)
    procs = {}
    for name, (src, flags) in jobs.items():
        digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
        out = work / f"{name}-{digest}.so"
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o",
                                         str(out), str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {"package": (kernels.load("polar"), kernels.library_path("polar"))}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [x.strip() for x in log.splitlines() if "Used " in x or "spill" in x]
        libs[name] = (kernels.declare(ctypes.CDLL(str(out)), "polar"), out)
        emit(dict(build=name, ptxas=regs))
    return libs


def runner(lib, spec):
    """A call of ``lib``'s ``thz_polar_unwrap`` on ``spec`` as the package's
    wrapper makes it (its own compiled shape), returning (amp, phase)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import polar

    fn = lib.thz_polar_unwrap
    warps, per_sm, _ = polar.config(lib)
    f = spec.shape[-1]
    rows = spec.numel() // f
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = min(-(-rows // warps), per_sm * sms)
    amp = torch.empty(spec.shape, dtype=torch.float32, device="cuda")
    ph = torch.empty_like(amp)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(spec.data_ptr(), amp.data_ptr(), ph.data_ptr(), None, rows, f, blocks, stream)
        assert err == 0, err
        return amp, ph

    return call


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT / "polar_sweep.jsonl", "a") as fh:
        fh.write(line + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_polar_sweep: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    OUT.mkdir(exist_ok=True)
    libs = build_all()
    (OUT / "polar.sass").write_text(smoke.sass_text(libs["package"][1]))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    order = ["package", *SHAPES, *VARIANTS, "package"]
    for t in (1024, 1648):
        spec = torch.fft.rfft(torch.randn((512, 512, t), generator=gen, device="cuda"), dim=-1)
        f = spec.shape[-1]
        bound = spec.numel() * 16 / smoke.memory_rate(torch.cuda.get_device_name(0)) * 1e3
        want = [x.clone() for x in runner(libs["package"][0], spec)()]
        for name in order:
            call = runner(libs[name][0], spec)
            got = call()
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want))
            exact = name in SHAPES or name == "package" or VARIANTS[name][1]
            assert same or not exact, (name, t)
            ms = smoke.device_ms(call)
            emit(dict(card=smi, build=name, F=f, kernel_ms=ms, bound_ms=bound,
                      roofline_pct=100.0 * bound / ms, bit_for_bit=same))
        del spec, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
