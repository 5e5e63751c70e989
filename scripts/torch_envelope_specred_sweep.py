#!/usr/bin/env python3
"""Block shapes of the envelope and spectral-reduction kernels, compared on
one GPU.

    python3 scripts/torch_envelope_specred_sweep.py [--seed 0] [--check]

Builds ``csrc/envelope.cu`` once per block shape (``-DENV_WARPS``: warps a
block, ``-DENV_STAGES``: input buffers a warp) and ``csrc/specred.cu`` once
per tile shape (``-DSR_ROWS``: spectrum rows a tile, ``-DSR_STAGES``: tile
buffers), all nvcc processes at once, and the previous designs of both
kernels where ``build/previous_design/`` holds their sources as commit
dea24f1 has them (one warp per trace; a partial pass over 128-column tiles
and a finishing kernel, ``thz_specred`` with 11 arguments)::

    mkdir -p build/previous_design
    for k in specred envelope; do git show \
      dea24f1:thz_image_explorer_tpu_torch/csrc/$k.cu > build/previous_design/$k.cu
    done

(the directory is not part of a checkout; a source that is not that
commit's is refused, since its calling convention would differ).
Each build is checked against the plain version on the main path's shapes
(200x200x1024: 40 000 traces of 1024 samples at the view's radius 9 and
contrast 2; a 40 000 x 513 spectrum with 5 masks), two runs bit for bit,
and timed there and at 512x512x1024 by ``chip_smoke.device_ms`` (the calls
queued behind a spin, so the CUDA events see device time only). Then the
parts of each default kernel, in copies of the source with a part replaced
(``PARTS``; they compute wrong values on purpose and are timed only): the
copies alone, the arithmetic alone, and the spectral reduction's finish
alone. The defaults and the previous designs are timed in turns (default,
previous, default). Prints one JSON line per build or part, the built kernels' registers, and the SASS counts per element
that ``chip_smoke.py`` turns into issue floors.

``--check`` builds only the default sources and checks them against the
plain versions on the main and ragged shapes (a short first run on the
card after a kernel change). Needs a CUDA device; prints the card's name
and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402

ENVELOPE_SHAPES = {"w4_s2": (4, 2), "w4_s4": (4, 4), "w4_s1": (4, 1), "w8_s2": (8, 2),
                   "w16_s2": (16, 2)}
SPECRED_SHAPES = {"r4_s4": (4, 4), "r4_s2": (4, 2), "r2_s4": (2, 4), "r8_s2": (8, 2)}

_ENV_CORR = "correlate_run<R>(buf + t0 + lh - round4(R), tap, acc);"
_ENV_POW = "power_in_place(buf + lh, t, contrast, bulk != 0, lane);"
_ENV_WAIT = "mbar_wait(smem_addr(my_bars + s), (uint32_t)((j / stages) & 1));"
_SR_ELEM = "aab[i] = make_float2(amp, atan2f(z.y, z.x));"
_SR_AMP = "const float amp = sqrtf(__fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y)));"
_SR_WAIT = "mbar_wait(smem_addr(bars + s), (uint32_t)((q / stages) & 1));"
_SR_COLUMNS = "      if (tid < cw) {\n        const int k = k0 + tid;"
#: timing-only copies: (source, [(text, replacement), ...])
PARTS = {
    # envelope: the bulk copies in and out with no power and no correlation
    "envelope_copies_only": ("envelope", [
        (_ENV_CORR, "for (int i = 0; i < kRun; ++i) acc[i] = buf[t0 + lh + i];"),
        (_ENV_POW, "")]),
    # envelope: the arithmetic on one trace per warp, read once, no waits
    "envelope_arithmetic_only": ("envelope", [
        (_ENV_WAIT, "if (j == 0) " + _ENV_WAIT),
        ("if (bulk && lane == 0 && j + stages < nj)", "if (false)"),
        ("if (lane == 0) bulk_store(out + (size_t)row * t, ob, row_bytes);", "")]),
    # envelope: the bulk copies with an L2 evict-first policy (streamed
    # once: traces in, opacities out)
    "envelope_evict_first": ("envelope", [
        ('"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n"',
         '"{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"'
         '"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint '
         '[%0], [%1], %2, [%3], pol;\\n}\\n"'),
        ('"cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"',
         '"{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"'
         '"cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, pol;\\n}\\n"')]),
    # specred: the tile copies with no square root and no angle
    "specred_copies_only": ("specred", [
        (_SR_AMP, "const float amp = z.x;"),
        (_SR_ELEM, "aab[i] = make_float2(amp, z.y);")]),
    # specred: the element pass's square root and angle alone, on the first
    # tile over and over (no waits, no refills, no column pass)
    "specred_transcendentals_only": ("specred", [
        (_SR_WAIT, "if (j == 0) " + _SR_WAIT),
        ("if (tid == 0 && j >= 1 && j - 1 + stages < ntl) {", "if (false) {"),
        (_SR_COLUMNS, _SR_COLUMNS.replace("tid < cw", "false"))]),
    # specred: the tile copies and waits alone (no element or column pass)
    "specred_waits_only": ("specred", [
        ("for (int i = tid; i < rows * w1; i += nt) {", "for (int i = rows * w1; i < rows * w1; i += nt) {"),
        (_SR_COLUMNS, _SR_COLUMNS.replace("tid < cw", "false"))]),
    # specred: launch, partial sums, grid barrier and sliced sums alone
    "specred_finish_only": ("specred", [
        ("for (long long j = 0; j < ntl; ++j) {", "for (long long j = 0; j < 0; ++j) {"),
        ("for (int s = 0; s < stages && s < ntl; ++s) {", "for (int s = 0; s < 0; ++s) {")]),
}


# ------------------------------------------- the previous kernel designs
#: where the previous designs' sources are put (see the docstring)
PREVIOUS_DIR = Path(__file__).resolve().parents[1] / "build" / "previous_design"
#: the git blob ids of the previous designs' sources (commit dea24f1)
PREVIOUS_BLOBS = {"specred": "8703604d6ecded3a267a747469e568e609915476",
                  "envelope": "7b608e39a7f1af72d821d87689242fbdf00d32c5"}


def previous_design_libs(kernels):
    """``{name: ctypes library}`` of the previous designs found in
    PREVIOUS_DIR, built there with the package's nvcc flags, and ``{name:
    reason}`` for those missing. Refuses a source that is not commit
    dea24f1's (its blob id differs)."""
    libs, missing, procs = {}, {}, {}
    for name, blob in PREVIOUS_BLOBS.items():
        src = PREVIOUS_DIR / f"{name}.cu"
        if not src.exists():
            missing[name] = f"build/previous_design/{name}.cu is not in this checkout"
            continue
        data = src.read_bytes()
        got = hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()
        if got != blob:
            raise RuntimeError(f"{src} is not dea24f1's {name}.cu (blob {got}, want {blob})")
        out = PREVIOUS_DIR / f"{name}.so"
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the previous {name}.cu:\n{log}")
        lib = libs[name] = ctypes.CDLL(str(out))
        if name == "specred":
            # spec, masks, partial, out, n, f, m, with_complex, rows_per_chunk,
            # chunks, stream
            lib.thz_specred.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
                [ctypes.c_void_p]
        else:
            # x, out, taps, n, t, r, contrast, thr, stream
            lib.thz_envelope.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
    return libs, missing


def previous_specred(lib, spec, masks, with_complex):
    """One call of the previous spectral reduction (a partial pass over row
    chunks of 128-column tiles, then a finishing kernel): (n_out, M, F)."""
    import torch

    n, f = spec.shape
    m = masks.shape[0]
    n_out = 4 if with_complex else 2
    sms = torch.cuda.get_device_properties(spec.device).multi_processor_count
    chunks = max(1, min(-(-n // 32), -(-8 * sms // -(-f // 128))))
    rows = -(-n // chunks)
    chunks = -(-n // rows)
    partial = torch.empty((chunks, n_out, m, f), dtype=torch.float32, device=spec.device)
    out = torch.empty((n_out, m, f), dtype=torch.float32, device=spec.device)
    err = lib.thz_specred(torch.view_as_real(spec).data_ptr(), masks.data_ptr(),
                          partial.data_ptr(), out.data_ptr(), n, f, m, int(with_complex), rows,
                          chunks, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"previous specred launch failed: CUDA error {err}"
    return out


def previous_envelope(lib, flat, taps, contrast, thr):
    """One call of the previous envelope kernel (one warp per trace)."""
    import torch

    taps = torch.as_tensor(np.asarray(taps, np.float32), device=flat.device)
    out = torch.empty_like(flat)
    err = lib.thz_envelope(flat.data_ptr(), out.data_ptr(), taps.data_ptr(), flat.shape[0],
                           flat.shape[1], taps.shape[0] // 2, float(contrast), float(thr),
                           torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"previous envelope launch failed: CUDA error {err}"
    return out


#: every line in full (the ptxas lines are long); stdout gets them without
#: the ptxas lines, and the largest register count instead
OUT = Path(__file__).resolve().parents[1] / "chiprun_out" / "envelope_specred_sweep.jsonl"


def emit(obj):
    with OUT.open("a") as f:
        f.write(json.dumps(obj) + "\n")
    short = {k: v for k, v in obj.items() if k != "ptxas"}
    if "ptxas" in obj:
        text = json.dumps(obj["ptxas"])
        short["max_registers"] = max((int(x.split("Used ")[1].split()[0])
                                      for x in text.split('"') if "Used " in x), default=None)
    print(json.dumps(short), flush=True)


def build(kernels, check_only):
    """{label: (library path, ptxas lines)} of every variant, built at once."""
    out_dir = kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    if not check_only:
        for name, (w, s) in ENVELOPE_SHAPES.items():
            jobs[f"envelope_{name}"] = ([f"-DENV_WARPS={w}", f"-DENV_STAGES={s}"],
                                        kernels.CSRC / "envelope.cu")
        for name, (r, s) in SPECRED_SHAPES.items():
            jobs[f"specred_{name}"] = ([f"-DSR_ROWS={r}", f"-DSR_STAGES={s}"],
                                       kernels.CSRC / "specred.cu")
        for label, (src, edits) in PARTS.items():
            text = (kernels.CSRC / f"{src}.cu").read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{label}: the source no longer holds {old[:50]!r}")
                text = text.replace(old, new)
            path = out_dir / f"{label}.cu"
            path.write_text(text)
            jobs[label] = ([], path)
    procs = {}
    for label, (defines, src) in jobs.items():
        out = out_dir / f"{label}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", str(out), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), out)
    built = {}
    for label, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        built[label] = (out, [x.strip() for x in log.splitlines() if "Used" in x or "spill" in x])
    return built


@contextlib.contextmanager
def library(name, path):
    """The wrappers of ``name`` on the library at ``path``."""
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import envelope, specred

    kept = kernels._loaded.get(name)
    kernels._loaded[name] = kernels.declare(ctypes.CDLL(str(path)), name)
    specred._plans.clear()
    envelope._plans.clear()
    try:
        yield
    finally:
        kernels._loaded[name] = kept
        specred._plans.clear()
        envelope._plans.clear()
        if kept is None:
            del kernels._loaded[name]


def inputs(size, seed, dev):
    """The envelope's traces and the spectral reduction's spectrum and
    masks of a size x size x 1024 synthetic scan, as the main path gives
    them (the preprocessed cube and its windowed spectrum, 5 masks)."""
    import torch

    from thz_image_explorer_tpu_torch.data import load_preprocess, make_cube
    from thz_image_explorer_tpu_torch.ops.fourier import forward_fft
    from thz_image_explorer_tpu_torch.ops.windows import WindowType

    t, cube = smoke.synthetic_scan(size, size, 1024, seed=seed)
    data, _ = load_preprocess(torch.as_tensor(cube, device=dev))
    flat = data.reshape(-1, 1024).contiguous()
    spec = forward_fft(make_cube(t, data, device=dev), WindowType.ADAPTED_BLACKMAN, 1.0,
                       7.0).fft.reshape(size * size, 513).contiguous()
    n = size * size
    masks = torch.zeros((5, n), device=dev)
    masks[0] = 1
    for i in range(1, 5):
        masks[i, (i * n) // 7:(i * n) // 7 + n // 9] = 1
    return flat, spec, masks


def check(label, flat, spec, masks, taps, thr):
    """Envelope and spectral reduction vs plain on these inputs, twice bit
    for bit: (envelope max error, specred max relative error)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import specred as sr

    out = env.envelope(flat, taps, 2.0, thr)
    assert torch.equal(out, env.envelope(flat, taps, 2.0, thr)), label
    env_err = float((out - env.envelope_plain(flat, taps, 2.0, thr)).abs().max())
    got = sr.spectral_reduction_sums(spec, masks, False)
    again = sr.spectral_reduction_sums(spec, masks, False)
    ref = sr.spectral_reduction_sums_plain(spec, masks, False)
    scale = smoke.abs_term_sums(spec, masks, False)
    rel = 0.0
    for g, g2, r, sc in zip(got[:2], again[:2], ref[:2], scale):
        assert torch.equal(g, g2), label
        rel = max(rel, float(((g - r).abs() / (sc + 1e-30)).max()))
    return env_err, rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true", help="build and check the defaults only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import specred as sr
    from thz_image_explorer_tpu_torch.ops.voxel import gaussian_kernel1d

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text("")
    logs = kernels.build(("specred", "envelope"))
    emit({"ptxas": {k: [x.strip() for x in v.splitlines()
                        if any(w in x for w in ("Used", "spill", "error", "Function properties"))]
                    for k, v in logs.items()}})
    built = build(kernels, args.check)
    dev = torch.device("cuda")
    taps = gaussian_kernel1d(3.0, 9)
    thr = 0.02
    main_in = inputs(200, args.seed, dev)
    env_err, sr_rel = check("default", *main_in, taps, thr)
    plans = {"envelope": smoke.check_envelope_plan(main_in[0].shape[0], 1024, 9),
             "specred": smoke.check_specred_plan(40_000, 513, 5)}
    emit({"default": True, "envelope_max_abs_err": env_err,
                      "specred_max_rel_err": sr_rel, "plans": plans, "card": card})
    if args.check:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        for label, case in smoke.ragged_envelope_cases(dev, gen).items():
            print(json.dumps({"envelope_case": label,
                              "max_abs_err_edges": smoke.check_envelope(*case, label)}),
                  flush=True)
        for nn, ff, mm in smoke.SPECRED_EDGE_SHAPES:
            spec = torch.randn((nn, ff), dtype=torch.complex64, device=dev, generator=gen)
            m = (torch.rand((mm, nn), device=dev, generator=gen) > 0.5).float()
            for wc in (False, True):
                smoke.check_specred(spec, m, wc, f"n={nn} f={ff} m={mm} wc={wc}")
            print(json.dumps({"specred_case": [nn, ff, mm], "ok": True}), flush=True)
        return 0

    big_in = inputs(512, args.seed + 1, dev)
    shapes = {"200": main_in, "512": big_in}
    prev, missing = previous_design_libs(kernels)

    def times(env_fn, sr_fn):
        return {size: {"envelope_ms": smoke.device_ms(lambda: env_fn(flat, taps, 2.0, thr)),
                       "specred_ms": smoke.device_ms(lambda: sr_fn(spec, masks, False))}
                for size, (flat, spec, masks) in shapes.items()}

    rows = {"default": times(env.envelope, sr.spectral_reduction_sums)}
    if prev:
        rows["previous_design"] = times(
            lambda *a: previous_envelope(prev["envelope"], *a),
            lambda *a: previous_specred(prev["specred"], *a))
    for label, (path, regs) in built.items():
        name = label.split("_")[0]
        with library(name, path):
            if label not in PARTS:
                errs = check(label, *main_in, taps, thr)
            else:
                errs = None
            fn = env.envelope if name == "envelope" else sr.spectral_reduction_sums
            row = {size: smoke.device_ms(
                (lambda: fn(flat, taps, 2.0, thr)) if name == "envelope"
                else (lambda: fn(spec, masks, False)))
                for size, (flat, spec, masks) in shapes.items()}
        emit({"build": label, "ms": row, "max_err": errs, "ptxas": regs, "card": card})
    rows["default_again"] = times(env.envelope, sr.spectral_reduction_sums)
    emit({"in_turns": rows, "previous_missing": missing, "card": card})
    env_so = kernels.library_path("envelope")
    sr_so = kernels.library_path("specred")
    emit({"sass_per_element": {
        "envelope_r9": smoke.envelope_instructions(env_so, 9),
        "specred_m5": smoke.specred_instructions(sr_so, 5)},
        "loops_envelope_r9": [dict(c.most_common(6), n=sum(c.values()))
                              for c in smoke.sass_loops(env_so, "envelope_kernelILi9E")],
        "loops_specred_m5": [dict(c.most_common(6), n=sum(c.values()))
                             for c in smoke.sass_loops(sr_so, "specred_kernelILi5ELb0E")],
        "sm_clock_hz": smoke.sm_clock_hz(), "card": card})
    (OUT.parent / "envelope_r9.sass").write_text(smoke.sass_text(env_so))
    (OUT.parent / "specred_m5.sass").write_text(smoke.sass_text(sr_so))
    return 0


if __name__ == "__main__":
    sys.exit(main())
