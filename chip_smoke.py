#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds every hand-written kernel of the port from ``thz_image_explorer_tpu_
torch/csrc`` with nvcc, holds each against its plain PyTorch version on the
card, then drives the main path through the ``Explorer`` facade at the
README's reference scan size (200x200x1024): open (the scan saved with
``save_file`` and reopened with ``open_file`` through the port's own HDF5
module, bit for bit), filter chain, ROI set, slider updates and pixel
clicks; then the 3-D voxel view of that scan as
the web view serves it (the live top-k view and one dense extraction); then
the deconvolution Apply path on the same scan with a synthetic asymmetric
PSF (25 bands, 500 iterations: one cluster-kernel launch per progress
checkpoint), followed by slider steps and clicks that must not rerun it and
a 3-D view of the deconvolved scan; both separable Richardson-Lucy routes
(the cluster kernel and the half-iteration kernel), both routes of the
general 2-D kernel (the cluster kernel and the tiled one) and the grouped
cluster kernel on the Apply's own inputs and ragged ones; the band-sum
kernel (the gains and the weighted spectrum, one launch an Apply) on the
Apply's own inputs at 200x200, at a tilted T and at 512x512; then the
same commands, the 3-D view and SaveVTU on a small scan on the card and on
the CPU; then tilt compensation on the reference scan (tilts of 2 and 3
degrees: T = 1488 and 1606, slider steps, clicks and tilt steps, a live
view on the envelope's plain-load route, an Apply after tilt, the kernels
at the new F and T, card vs CPU on a small tilted scan; ``tilt_kernel``:
the tilt kernel against its plain route bit for bit at those scans and at
512x512 (T' = 1620, 1648), its shifts against ``pixel_shifts`` for every
pixel over -15 to +15 degrees in 0.05 degree steps on three grids and the
pipeline_mesh blocks, its device ms beside its bound; ``--only
tilt_kernel`` runs that phase alone after the build); ``polar_kernel``: the
FFT stage's kernel (``csrc/polar.cu``) against its plain route at 512x512
(F = 513, 811, 825), at T = 13000, a single row and a NaN bin, the
amplitudes and wrapped steps bit for bit, the phases bit for bit where
PyTorch's scan takes the kernel's chunks, its device ms beside its bound,
the plain route's ms and the issue floor (``--only polar_kernel``); the
main path counts its launches (one a slider step, none a click); the PSF tool on
knife-edge traces of the reference fixture's shape (300 x 1001, 20 bands),
written as ``.thz`` files and loaded by the tool's loader, its PSF
exported, loaded and applied; a reference pulse loaded as the
optical reference, and skipped once a tilt changes the bin count; the
web/CLI shell on the reference scan (``shell``: the worker with its
coalescing FIFO, the page's open of a dotTHz file and the two-phase open's
preview, an HTTP server on loopback
answering a 100-event slider drag, state polls, clicks, 3-D views, a web
Apply and an aborted one, the web state against a direct Explorer, a small
scan card vs CPU through two WebApps, and ``psf-diagnostics`` in a
subprocess); a 512x512x1024 scan with one live 3-D view; dotTHz files
(``dotthz_file``: at 200x200 and 512x512 the save, the host read in GB/s,
the two-phase open from the file against ``open_arrays``, metadata load
and update, a pulse; ``dotthz_features``: the same scans saved chunked one
line a chunk with gzip + shuffle and with lzf + shuffle, read back bit for
bit, the C LZF decoder (``csrc/lzf.c``, host C) beside its plain version,
the 200x200 lzf file opened through the page and driven bit for bit
against the contiguous file's open, and the committed HDF5 fixtures of
``tests/data/torch_hdf5`` opened without h5py); and finally
multiple devices (``multi_device``: the pixel-grid mesh of ``parallel/``,
its sharded update, Apply and live view on each rank's block, each rank's
block opened from a ``.npy`` and through ``open_scan_sharded`` from the same
scan's ``.thz``, one rank over
NCCL in this process against the single-device calls, 2 and 4 spawned ranks
sharing the card over gloo against the one-rank results, 4 ranks at
512x512x1024, and a sharded step downscaled by 3 against the single
device); and the incremental ``Pipeline`` with its publish on each rank's
block (``pipeline_mesh``: open, slider steps, clicks, a downscale by 3,
tilt to T = 1488 and then to lengths of 2 mod 4 (1606, and 1610 on the
downscaled blocks) with slider steps, clicks and a dense extraction there,
the Apply and a dense 3-D extraction, then the same at an odd trace
length, 1023; one rank over NCCL in lockstep with the single-device
``Pipeline``, bit for bit, and 2 and 4 ranks over gloo against it, run by
the multi-device phase's rank processes after their own work). The main
path also clicks with a stage overriding the ``show_data`` hook, and times
the ROI rasterizer (``csrc/roi.c``, host C) beside its plain version at
200x200 and 512x512. Each of the tilt, PSF tool, open_ref,
shell, multi-device and pipeline_mesh paths is driven with every kernel's
launch count set to 0 just before it and read just after (in each rank's
own process). Each
phase prints one JSON line; the script exits non-zero as soon as a phase
fails, and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It needs a CUDA device and the package beside it; it imports nothing of
JAX. Numbers it prints are taken on the card it runs on, whose name and
power limit it prints first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: device-memory bandwidth (bytes/s) by card, for the kernels' bounds
#: (NVIDIA data sheets: H100 SXM HBM3, H100 PCIe HBM2e, H200 SXM HBM3e)
_MEMORY_RATE = (("H200", 4.8e12), ("HBM3", 3.35e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
#: f32 peak outside the tensor cores (H100 SXM data sheet)
_F32_PEAK = 67e12
#: the TPU kernels the port's kernels replace (the Pallas kernel bodies)
_SPECRED_REPLACES = "thz_image_explorer_tpu/ops/pallas_specred.py:124"
_RLSEP_REPLACES = "thz_image_explorer_tpu/ops/pallas_rl.py:140"
_ENVELOPE_REPLACES = "thz_image_explorer_tpu/ops/voxel.py:213"
_RL2D_REPLACES = "thz_image_explorer_tpu/ops/pallas_rl.py:61"
_RLSEP_GROUPED_REPLACES = "thz_image_explorer_tpu/ops/pallas_rl.py:157"
#: the band-sum kernel replaces no TPU kernel (the JAX package's einsums)
_BANDSUM_REPLACES = ("none: thz_image_explorer_tpu/ops/deconvolution.py:_spectral_band_sum's "
                     "two jnp.einsum calls and products, in XLA")
#: why the kernels line has no previous-design time for the kernels
#: redesigned in place: the smoke builds only the checkout's sources
_PREVIOUS_DESIGN = ("the smoke builds only this checkout's sources; "
                    "scripts/torch_envelope_specred_sweep.py times the previous design "
                    "(commit dea24f1) in one call with this one, PERF.md section 6")
_GROUPED_PREVIOUS_DESIGN = ("the previous design, the group mode of commit 71e894e's "
                            "csrc/rlsep.cu, is deleted and the smoke builds only this "
                            "checkout's sources; scripts/torch_rl2d_grouped_sweep.py times it "
                            "in one call with this one, PERF.md section 6")
#: the SMs of an H100 SXM, for the cluster kernel's critical-path floor
_SMS = 132
#: kernel vs plain Richardson-Lucy, per band: |kernel - plain| <= this *
#: max|plain| (summation order, compounded over up to 500 multiplicative
#: iterations)
_RL_REL_TOL = 1e-3
#: kernel vs plain band sum, per bin: |kernel - plain| <= this * (2B + 8) *
#: |spec| * sum_b g_b |T_b| (each side sums B products in its own order, then
#: one complex product: B + 2 f32 roundings a side of that scale)
_BANDSUM_TOL = 2.0 ** -24


#: the script's start, for each phase line's elapsed seconds
_T0 = time.perf_counter()


def emit(**obj):
    print(json.dumps({**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}), flush=True)


def synthetic_scan(width, height, n_time, dt=0.05, seed=0):
    """A THz-TDS scan: per-pixel pulse with position-dependent amplitude
    and delay, a lower-amplitude disc (the sample), noise and a DC bias.
    Returns (time (T,), cube (X, Y, T)) as float32."""
    rng = np.random.default_rng(seed)
    t = (np.arange(n_time) * dt).astype(np.float32)
    xs = np.arange(width, dtype=np.float32)[:, None]
    ys = np.arange(height, dtype=np.float32)[None, :]
    r2 = (xs - width / 2) ** 2 + (ys - height / 2) ** 2
    amp = 0.6 + 0.4 * np.exp(-r2 / (width * height / 8))
    amp = np.where(r2 < (width / 4) ** 2, amp * 0.5, amp).astype(np.float32)
    # the delay depends on x only, so the pulse shape is an (X, T) table
    tt = t[None, :] - (3.0 + 0.02 * xs)
    pulse = (np.exp(-(tt ** 2) / 0.5) * np.sin(2 * np.pi * 1.0 * tt)).astype(np.float32)
    cube = amp[:, :, None] * pulse[:, None, :]
    cube += 0.01 * rng.standard_normal(cube.shape, dtype=np.float32)
    cube += np.float32(0.03)
    return t, cube


def knife_edge_traces(n_pos=300, n_time=1001, dt=0.05, seed=0, width_scale=1.0):
    """A double-knife-edge measurement of one axis, the reference fixture's
    shape (300 positions x 1001 samples): positions over +-7.5 mm, the
    transmitted intensity an erf in the distance from the edges at -2.0 and
    +2.3 mm whose width falls with frequency, w(f) = (0.7 / f + 1.2) mm
    times ``width_scale``, carried by a pulse of 16 components over
    0.15-4 THz, plus noise. Returns (positions (P,), traces (P, T), time
    (T,)) as float64."""
    from scipy.special import erf

    rng = np.random.default_rng(seed)
    pos = np.linspace(-7.5, 7.5, n_pos)
    t = np.arange(n_time) * dt
    dist = np.where(pos < 0, -pos - 2.0, pos - 2.3)
    traces = np.zeros((n_pos, n_time))
    for f in np.geomspace(0.15, 4.0, 16):
        w = width_scale * (0.7 / f + 1.2)
        amp = np.sqrt((1.0 + erf(np.sqrt(2.0) * dist / w)) / 2.0)
        carrier = np.exp(-((t - 12.0) ** 2) / (2 * (1.5 / f) ** 2)) * np.sin(
            2 * np.pi * f * (t - 12.0))
        traces += amp[:, None] * carrier[None, :]
    traces += 1e-4 * rng.standard_normal(traces.shape)
    return pos, traces, t


def memory_rate(name: str) -> float:
    for key, rate in _MEMORY_RATE:
        if key in name:
            return rate
    raise SystemExit(f"no memory bandwidth known for {name!r}")


def time_ms(fn, reps=21, inner=10, warm=3):
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, from CUDA events, after ``warm`` warm-up calls."""
    import torch

    for _ in range(warm):
        fn()
    samples = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


#: cycles the stream spins (torch.cuda._sleep) before timed calls, longer
#: than the host needs to queue them (~2 ms at the H100's clock)
_HOLD_CYCLES = 4_000_000


def device_ms(fn, reps=11, inner=10, warm=3):
    """The kernels' own device time per call: median over ``reps`` of the
    mean of ``inner`` calls queued behind a ``torch.cuda._sleep`` spin, so
    the CUDA events time the device work and not the wrappers' host work
    (checks, allocation, the ctypes call)."""
    import torch

    for _ in range(warm):
        fn()
    samples = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(_HOLD_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


# ------------------------------------------------------- the issue floor
def sass_text(so_path):
    """``cuobjdump -sass`` of the library at ``so_path``."""
    from thz_image_explorer_tpu_torch import kernels

    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(so_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def sass_loops(so_path, kernel_key):
    """The innermost loops of the kernel whose mangled name holds
    ``kernel_key`` in the library at ``so_path``, from ``cuobjdump -sass``:
    one ``collections.Counter`` of opcodes per loop body (a backward branch
    to a label and the instructions from the label to it)."""
    import collections
    import re

    body = next(part for part in sass_text(so_path).split("Function : ")[1:]
                if part.split(None, 1)[0].find(kernel_key) >= 0)
    ops, at, loops = [], {}, []
    for line in body.splitlines():
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not ins:
            continue
        addr = int(ins.group(1), 16)
        words = ins.group(2).split()
        op = words[1] if words[0].startswith("@") else words[0]
        at[addr] = len(ops)
        ops.append(op)
        target = re.search(r"BRA(?:\.\S+)?\s+(?:!?U?P\d,\s*)?0x([0-9a-f]+)", ins.group(2))
        if op.startswith("BRA") and target and int(target.group(1), 16) <= addr:
            loops.append((at[int(target.group(1), 16)], len(ops)))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    return [collections.Counter(ops[a:b]) for a, b in inner]


def sm_clock_hz():
    """The SMs' maximum clock (nvidia-smi ``clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def issue_floor_ms(per_element, elements, clock_hz, sms=_SMS):
    """The least time to issue ``per_element`` thread instructions for each
    of ``elements`` elements: 32 lanes a warp instruction, one warp
    instruction a clock on each of an SM's 4 schedulers."""
    return per_element * elements / 32 / (sms * 4 * clock_hz) * 1e3


def envelope_instructions(so_path, radius):
    """SASS instructions per sample of the envelope kernel's bulk route at
    contrast 2 (``envelope_kernel<radius>``), from its three loops in
    shared memory, each loop's instructions divided by the samples it
    takes, told by its arithmetic: the square (``FMUL`` alone, two a
    sample), the correlation runs (``2 radius + 1`` ``FFMA`` a sample,
    read as float4s) and the normalization (one ``MUFU.RCP`` a sample: the
    IEEE division; no ``FMUL``, which tells it from the powf loop). A
    static count: a branch a loop body holds counts whether taken or not,
    and the division's slow-path subroutine is not counted."""
    taps = 2 * radius + 1
    total = 0.0
    for c in sass_loops(so_path, f"envelope_kernelILi{radius}E"):
        n = sum(c.values())
        if not c["STS.128"] and not c["LDS.128"] or c["STG.E"]:
            continue
        if c["FMUL"] and not (c["FFMA"] or c["MUFU.RCP"]):
            total += n / (c["FMUL"] / 2)
        elif c["FFMA"] >= taps and not (c["MUFU.RCP"] or c["FMUL"]):
            total += n / (c["FFMA"] / taps)
        elif c["MUFU.RCP"] and not c["FMUL"]:
            total += n / c["MUFU.RCP"]
    return total


def specred_instructions(so_path, m):
    """SASS instructions per element of ``specred_kernel<m, false>``: the
    element loop (the one that takes a square root, MUFU.RSQ; one element
    per 64-bit shared store) and the column loop (2 m FFMA per row). A
    static count, as above: the slow paths of the accurate atan2f and
    sqrtf count too."""
    total = 0.0
    for loop in sass_loops(so_path, f"specred_kernelILi{m}ELb0E"):
        if loop["MUFU.RSQ"] and loop["STS.64"]:
            total += sum(loop.values()) / loop["STS.64"]
        elif loop["FFMA"] >= 2 * m:
            total += sum(loop.values()) / (loop["FFMA"] // (2 * m))
    return total


# ---------------------------------------------------------------- phase 3
def abs_term_sums(spec, masks, with_complex):
    """Per output and column, sum_n |mask * term|: the scale of each sum
    the tolerance is relative to."""
    import torch

    from thz_image_explorer_tpu_torch.ops.fourier import phase_increments

    c, s = spec.real, spec.imag
    terms = [torch.sqrt(c * c + s * s), phase_increments(torch.atan2(s, c))]
    if with_complex:
        terms += [c, s]
    am = masks.abs()
    return [am @ t.abs() for t in terms]


def check_specred(spec, masks, with_complex, label):
    """Kernel vs plain on the card: per column |kernel - plain| <=
    1e-5 * sum|terms| + 1e-6 (only the summation order differs: both use
    the card's atan2f), and two kernel runs bit-identical."""
    import torch

    from thz_image_explorer_tpu_torch.ops import specred as sr

    got = sr.spectral_reduction_sums(spec, masks, with_complex)
    again = sr.spectral_reduction_sums(spec, masks, with_complex)
    ref = sr.spectral_reduction_sums_plain(spec, masks, with_complex)
    scale = abs_term_sums(spec, masks, with_complex)
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for name, g, g2, r, sc in zip(("amp", "inc", "re", "im"), got, again, ref, scale):
        if not torch.equal(g, g2):
            raise AssertionError(f"{label} {name}: two kernel runs differ")
        err = (g - r).abs()
        bad = err > 1e-5 * sc + 1e-6
        if bool(bad.any()):
            raise AssertionError(
                f"{label} {name}: {int(bad.sum())} columns outside tolerance, "
                f"max err {float(err.max())}"
            )
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / (sc + 1e-30)).max()))
    return max_abs, max_rel


#: ragged spectral-reduction shapes (N, F, M): ragged F; N no multiple of a
#: tile, odd (a last row read with plain loads) and 1; M = 1, 16 and 21
#: masks (two launches: 16 + 5); F over one block's columns (2 and 4 column
#: chunks); F too wide for whole rows in a block (the wide route: 16 384-
#: sample traces, and 820 column chunks, more than the card's resident
#: blocks, which then take several items each)
SPECRED_EDGE_SHAPES = ((1009, 33, 1), (4099, 129, 16), (2053, 1025, 3), (3001, 513, 21),
                       (40_001, 513, 5), (1, 513, 2), (7, 2049, 4), (2, 17, 16),
                       (3001, 8193, 5), (3, 524_289, 2))


def specred_kernel_count(spec, masks):
    """CUDA kernels one call of the spectral reduction launches, by name,
    from the profiler (the call's ticket counters exist already)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from thz_image_explorer_tpu_torch.ops import specred as sr

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sr.spectral_reduction_sums(spec, masks, False)
        torch.cuda.synchronize()
    return {e.key[:60]: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def check_specred_plan(n, f, m):
    """The plan the launches of this shape were given (each group of at most
    16 masks) is ops/specred.py's own, at the library's compiled shape,
    which is the module's; the library's layout gives it the same shared
    memory."""
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import specred as sr

    lib = kernels.load("specred")
    assert sr.library_config() == dict(rows=sr.ROWS, stages=sr.STAGES,
                                       max_cols=sr.MAX_COLS,
                                       smem_per_block=sr.SMEM_PER_BLOCK)
    for g in range(0, m, sr.MAX_MASKS):
        mg = min(sr.MAX_MASKS, m - g)
        got = sr.kernel_plan(n, f, mg, False)
        want = sr.plan(n, f, mg, got["blocks_possible"])
        assert all(got[k] == v for k, v in want.items()), (n, f, mg, got, want)
        args = (f, got["cw"], mg, got["rows"], got["stages"], int(got["wide"]))
        assert lib.thz_specred_smem(*args) == sr.layout_bytes(*args) == got["smem"], args
    return {k: v for k, v in got.items() if k != "args"}


def phase_kernel_checks(pulse_spec, masks5, gen):
    import torch

    from thz_image_explorer_tpu_torch.ops import specred as sr

    dev = pulse_spec.device
    n, f = pulse_spec.shape
    rand_spec = torch.randn((n, f), dtype=torch.complex64, device=dev, generator=gen)
    main = {}
    for spec_name, spec in (("pulse", pulse_spec), ("random", rand_spec)):
        for wc in (False, True):
            main[(spec_name, wc)] = check_specred(spec, masks5, wc, f"{spec_name} wc={wc}")
    # one kernel per call of at most 16 masks, and no second kernel
    launched = specred_kernel_count(pulse_spec, masks5)
    assert len(launched) == 1 and list(launched.values()) == [1], launched
    ragged, routes = [], {}
    for nn, ff, mm in SPECRED_EDGE_SHAPES:
        spec = torch.randn((nn, ff), dtype=torch.complex64, device=dev, generator=gen)
        m = (torch.rand((mm, nn), device=dev, generator=gen) > 0.5).float()
        before = sr.spectral_reduction_sums.launches
        for wc in (False, True):
            check_specred(spec, m, wc, f"n={nn} f={ff} m={mm} wc={wc}")
        assert sr.spectral_reduction_sums.launches - before == 2 * -(-mm // sr.MAX_MASKS) * 2
        p = check_specred_plan(nn, ff, mm)
        routes[f"{nn}x{ff}x{mm}"] = dict(wide=p["wide"], chunks=p["chunks"], grid=p["grid"],
                                         items=p["ranges"] * p["chunks"])
        ragged.append([nn, ff, mm])
    assert routes["3001x8193x5"]["wide"] and not routes["40001x513x5"]["wide"]
    assert routes["3x524289x2"]["items"] > routes["3x524289x2"]["grid"]
    # two streams at once: small grids that can run side by side, each
    # with its own barrier counters
    spec = torch.randn((1009, 33), dtype=torch.complex64, device=dev, generator=gen)
    m = (torch.rand((3, 1009), device=dev, generator=gen) > 0.5).float()
    ref = sr.spectral_reduction_sums_plain(spec, m, False)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(20):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            on_side = sr.spectral_reduction_sums(spec, m, False)
        on_main = sr.spectral_reduction_sums(spec, m, False)
        torch.cuda.current_stream().wait_stream(side)
        for g, g2, r in zip(on_side[:2], on_main[:2], ref[:2]):
            assert torch.equal(g, g2) and bool(((g - r).abs() <= 1e-4 * r.abs().amax()
                                                + 1e-6).all())
    torch.cuda.synchronize()
    # a spectrum whose pointer is 8 bytes off a 16-byte boundary: the plain
    # route, chosen from the pointer before the launch
    whole = torch.randn(((3001 * 513) + 1,), dtype=torch.complex64, device=dev, generator=gen)
    shifted = whole[1:].view(3001, 513)
    assert shifted.data_ptr() % 16 == 8
    m = (torch.rand((5, 3001), device=dev, generator=gen) > 0.5).float()
    for wc in (False, True):
        check_specred(shifted, m, wc, f"8-byte aligned spectrum wc={wc}")
    ragged.append([3001, 513, 5, "8-byte aligned"])
    emit(
        phase="kernel_vs_plain",
        main_shape=[n, f, int(masks5.shape[0])],
        max_abs_err={f"{k[0]}/wc={k[1]}": v[0] for k, v in main.items()},
        max_rel_err={f"{k[0]}/wc={k[1]}": v[1] for k, v in main.items()},
        ragged_shapes=ragged,
        ragged_routes=routes,
        two_streams="20 pairs of launches on two streams, bit-identical, within 1e-4*max",
        kernels_per_call=launched,
        plan=check_specred_plan(n, f, int(masks5.shape[0])),
        deterministic=True,
        tolerance="per column |kernel-plain| <= 1e-5*sum|terms| + 1e-6",
    )
    return main[("pulse", False)]


# ------------------------------------------------ the Apply path's inputs
def scan_metadata(d_mm):
    """dotTHz metadata giving the scan a pixel pitch of ``d_mm`` (the
    deconvolution needs dx and dy)."""
    from thz_image_explorer_tpu_torch.io.dotthz import DotthzMetadata

    return DotthzMetadata(md={"dx [mm]": str(d_mm), "dy [mm]": str(d_mm)})


def write_scan_file(path, t, cube, metadata, **cube_storage):
    """The scan as a user's dotTHz file holds it, written by the port's own
    HDF5 writer: an "Image" group with the metadata, the time axis (ds1) and
    the raw cube (ds2; contiguous, or stored with h5py's ``chunks``,
    ``compression``, ``compression_opts`` and ``shuffle``)."""
    import dataclasses

    from thz_image_explorer_tpu_torch.io import hdf5
    from thz_image_explorer_tpu_torch.io.dotthz import write_group_metadata

    with hdf5.File(path, "w") as f:
        g = f.create_group("Image")
        write_group_metadata(g, dataclasses.replace(metadata, ds_description=["time", "dataset"]))
        g.create_dataset("ds1", data=np.asarray(t, np.float32))
        g.create_dataset("ds2", data=np.asarray(cube, np.float32), **cube_storage)
    return path


def write_knife_edge_file(path, positions, traces, times):
    """One axis's knife-edge measurement as the PSF tool reads it: a group a
    position, named ``Beam Width Measurement x=<position>`` (the shortest
    decimal that reads back as the same float64), holding a (T, 2) ``[time,
    signal]`` dataset; written by the port's own HDF5 writer."""
    from thz_image_explorer_tpu_torch.io import hdf5

    with hdf5.File(path, "w") as f:
        for p, trace in zip(positions, traces):
            name = f"Beam Width Measurement x={np.format_float_positional(p, unique=True)}"
            f.create_group(name).create_dataset("ds1", data=np.stack([times, trace], 1))
    return path


def two_phase_open(app, send, width, height, n_time):
    """``send()`` an open to the worker behind ``app``; (preview ms, final
    ms), host ms from the send: the first state (the host preview, no device
    results yet; the poll queues behind the open and ahead of the device
    phase the open defers), and the first state with the device phase done."""
    t0 = time.perf_counter()
    send()
    preview = app.state()
    preview_ms = (time.perf_counter() - t0) * 1e3
    assert preview["preview"] and preview["image"], "the first state carried no preview"
    assert preview["image_shape"] == [width, height] and len(preview["plots"]["signal"])
    assert not preview["plots"]["filtered_signal_fft"], "the preview has device results"
    while time.perf_counter() - t0 < _SHELL_WAIT_S:
        s = app.state()
        if not s["preview"] and not s.get("stale"):
            final_ms = (time.perf_counter() - t0) * 1e3
            break
    else:
        raise AssertionError(f"the open's device phase did not end in {_SHELL_WAIT_S} s")
    assert len(s["plots"]["filtered_signal_fft"]) == n_time // 2 + 1
    return preview_ms, final_ms


def synthetic_psf():
    """An asymmetric PSF: widths wx = 0.70/f + 0.50 mm, wy = 0.85/f + 0.55
    mm, centres x0 = 0.3 mm, y0 = -0.2 mm, knots over 0.1-10 THz, zero
    width correction. A constant centre sets both ``values`` and
    ``coeff_a``: outside the knots ``eval_const_extrap`` reads ``values``."""
    from thz_image_explorer_tpu_torch.models.psf import PSF, CubicSplineCoeffs, HybridFit

    knots = np.geomspace(0.1, 10.0, 6)
    zeros = np.zeros_like(knots)

    def const(v):
        c = np.full_like(knots, v)
        return CubicSplineCoeffs(knots, c, c, zeros, zeros, zeros)

    return PSF(wx_fit=HybridFit(0.70, 0.50, const(0.0)),
               wy_fit=HybridFit(0.85, 0.55, const(0.0)),
               x0_spline=const(0.3), y0_spline=const(-0.2))


# ---------------------------------------------------------------- phase 4
def roi_polygons(width, height):
    """Four polygon ROIs spread over the scan (pixel coordinates)."""
    w, h = width, height
    return [
        [(w // 10, h // 10), (w // 3, h // 10), (w // 3, h // 3), (w // 10, h // 3)],
        [(w // 2, h // 2), (2 * w // 3, h // 2), (2 * w // 3, 2 * h // 3)],
        [(w // 6, 2 * h // 3), (w // 3, 2 * h // 3), (w // 4, 5 * h // 6)],
        [(3 * w // 5, h // 8), (4 * w // 5, h // 8), (4 * w // 5, h // 3),
         (3 * w // 5, h // 3)],
    ]


def drive_commands(ex, open_scan, cube, n_slider, n_clicks, rng):
    """The main path as a user drives it: ``open_scan()`` opens ``cube`` in
    ``ex``, then filters, ROIs, the optical selection, slider updates and
    pixel clicks. Returns (slider ms, click ms, kernel launches per slider
    update, kernel launches per click)."""
    import torch

    from thz_image_explorer_tpu_torch.ops.specred import spectral_reduction_sums as sr

    open_scan()
    for uuid in ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch"):
        ex.set_filter_active(uuid, True)
    width, height = cube.shape[0], cube.shape[1]
    for i, poly in enumerate(roi_polygons(width, height)):
        ex.add_roi(f"roi-{i}", f"ROI {i}", poly)
    ex.set_reference("ROI 0")
    ex.set_sample("Selected Pixel")

    def run(cmd):
        before = sr.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cmd()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, sr.launches - before

    slider = [run(lambda i=i: ex.set_fft_window_low(1.0 + 0.05 * (i + 1)))
              for i in range(n_slider)]
    clicks = [run(lambda: ex.set_selected_pixel(int(rng.integers(width)),
                                                int(rng.integers(height))))
              for _ in range(n_clicks)]
    return [s[0] for s in slider], [c[0] for c in clicks], \
        [s[1] for s in slider], [c[1] for c in clicks]


def check_published(ex, width, height, n_time):
    import torch

    p = ex.plot
    nf = n_time // 2 + 1
    series = {
        "time": n_time, "signal": n_time, "filtered_time": n_time,
        "filtered_signal": n_time, "avg_signal": n_time, "frequencies": nf,
        "signal_fft": nf, "phase_fft": nf, "filtered_frequencies": nf,
        "filtered_signal_fft": nf, "filtered_phase_fft": nf,
        "avg_signal_fft": nf, "avg_phase_fft": nf,
    }
    for key, length in series.items():
        v = getattr(p, key)
        assert v.shape == (length,), (key, v.shape)
        assert np.isfinite(v).all(), f"{key} not finite"
    for d in (p.roi_signal, p.roi_signal_fft, p.roi_phase):
        assert len(d) == 4
        for _name, v in d.values():
            assert np.isfinite(v).all()
    # optical n/alpha/kappa divide by omega = 0 at the DC bin (the
    # reference's formula); every other bin must be finite
    for key in ("refractive_index", "absorption_coefficient", "extinction_coefficient"):
        v = getattr(p, key)
        assert v.shape == (nf,) and np.isfinite(v[1:]).all(), key
    assert ex.image.shape == (width, height) and np.isfinite(ex.image).all()
    for i, slot in enumerate(ex.pipeline.slots):
        for name in ("time", "data", "freq", "fft", "amplitudes", "phases",
                     "avg_data", "avg_fft", "avg_signal_fft", "avg_phase_fft"):
            assert getattr(slot, name).device.type == "cuda", (i, name)
    assert ex.device.type == "cuda" and torch.cuda.is_available()


def show_data_probe():
    """An inactive filter stage whose ``show_data`` records what a click
    hands it (an extension's preview hook; no built-in stage has one)."""
    from thz_image_explorer_tpu_torch.pipeline.stage import FilterConfig, FilterDomain, FilterStage

    class ShowDataProbe(FilterStage):
        uuid = "show_data_probe"

        def __init__(self):
            self.active, self.seen = False, []

        def config(self):
            return FilterConfig("Show-data probe", "records its show_data calls",
                                FilterDomain.TIME_AFTER_FFT)

        def apply(self, cube, context):
            return cube

        def show_data(self, cube, pixel):
            self.seen.append((cube, pixel))

    return ShowDataProbe()


def drive_show_data(ex, width, height, rng, n_clicks=10):
    """Clicks without and then with a stage overriding ``show_data`` (its
    instance in the Explorer's filters for those clicks only), each count
    set to 0 before them and read after. With the hook: each call gets the
    final slot itself (CUDA tensors, the same bits as ``pipeline.output``'s)
    and the pixel in its coordinates, clamped (one click lies past the
    grid's edge); neither kind of click launches a kernel."""
    pixels = [(int(x), int(y)) for x, y in rng.integers(0, width, size=(n_clicks - 1, 2))]
    pixels.append((width + 57, height // 3))

    def clicks():
        zero_counts()
        ms = [command_ms(lambda xy=xy: ex.set_selected_pixel(*xy))[0] for xy in pixels]
        return ms, read_counts()

    without_ms, without = clicks()
    probe = show_data_probe()
    ex.pipeline.filters[probe.uuid] = probe
    try:
        with_ms, with_hook = clicks()
    finally:
        del ex.pipeline.filters[probe.uuid]
    assert len(probe.seen) == len(pixels)
    out = ex.pipeline.output
    s = out.scaling
    vw, vh = ex.pipeline.valid_for(out)
    for (cube, pixel), (x, y) in zip(probe.seen, pixels):
        assert cube is out, "show_data got another cube than the final slot"
        assert pixel == (min(x // s, vw - 1), min(y // s, vh - 1)), (pixel, x, y)
        for f in _PM_SLOT_FIELDS:
            got = getattr(cube, f)
            assert got.device == ex.device and same_bits(got, getattr(out, f)), f
    assert all(v == 0 for v in without.values()), without
    assert all(v == 0 for v in with_hook.values()), with_hook
    return dict(clicks=len(pixels), click_ms_median=statistics.median(without_ms[1:]),
                click_ms=without_ms, hook_click_ms_median=statistics.median(with_ms[1:]),
                hook_click_ms=with_ms, launches_without_hook=without,
                launches_with_hook=with_hook, hook_calls=len(probe.seen),
                hook_pixel_last=list(probe.seen[-1][1]), hook_device=str(ex.device),
                hook_cube="the final slot itself (pipeline.materialize_output), tensors on the "
                          "Explorer's device, bit for bit pipeline.output's")


def inscribed_polygon(n, width, height):
    """A regular n-gon inscribed in a width x height grid."""
    a = 2 * np.pi * np.arange(n) / n
    cx, cy = (width - 1) / 2, (height - 1) / 2
    return [(int(round(cx + cx * np.cos(v))), int(round(cy + cy * np.sin(v)))) for v in a]


def rasterizer_timings(ex, width, height, with_downscale):
    """The ROI rasterizer at ``width`` x ``height``: for a 4- and a
    20-vertex polygon inscribed in the grid, the C function's ms (median of
    5) beside its plain Python version's (one run), their masks equal, and
    the ``add_roi`` command's host ms (its publish included) on ``ex``,
    the ROI deleted after; with ``with_downscale``, the downscale to 3 and
    back, which rasterize every polygon again."""
    from thz_image_explorer_tpu_torch.ops import roi

    out = {}
    for n in (4, 20):
        poly = inscribed_polygon(n, width, height)
        c_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            mask = roi.polygon_mask(poly, (width, height))
            c_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        plain = roi.polygon_mask_plain(poly, (width, height))
        plain_ms = (time.perf_counter() - t0) * 1e3
        assert np.array_equal(mask, plain) and mask.any(), n
        zero_counts()
        add_ms = command_ms(lambda: ex.add_roi(f"timed-{n}", f"timed {n}", poly))[0]
        add_launches = read_counts()
        ex.delete_roi(f"timed-{n}")
        out[f"vertices{n}"] = dict(c_ms_median=statistics.median(c_ms), c_ms=c_ms,
                                   plain_ms=plain_ms, masks_equal=True,
                                   pixels=int(mask.sum()), add_roi_ms=add_ms,
                                   add_roi_launches=add_launches)
    if with_downscale:
        out["downscale3_ms"] = command_ms(lambda: ex.set_downscaling(3))[0]
        out["downscale1_ms"] = command_ms(lambda: ex.set_downscaling(1))[0]
    return out


_SMALL_SERIES = ("signal", "signal_fft", "phase_fft", "filtered_signal",
                 "filtered_signal_fft", "filtered_phase_fft", "avg_signal",
                 "avg_signal_fft", "avg_phase_fft")


def compare_plots(g, gi, c, ci, tol):
    """Every data-derived PlotData series and the image, card vs CPU.
    ``tol(ref) -> (atol, rtol)``. Returns the largest absolute difference."""
    worst = 0.0
    pairs = [(key, getattr(g, key), getattr(c, key)) for key in _SMALL_SERIES]
    for key in ("roi_signal", "roi_signal_fft", "roi_phase"):
        pairs += [(f"{key}[{u}]", getattr(g, key)[u][1], getattr(c, key)[u][1])
                  for u in getattr(c, key)]
    pairs.append(("image", gi, ci))
    for key, a, b in pairs:
        atol, rtol = tol(b)
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=key)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def small_reference_check(seed, tmp):
    """The same command sequence on a small scan on the card and on the
    CPU (cuFFT + the kernels vs the CPU FFT + the plain versions): the
    main path; the 3-D view (live view, dense extraction, SaveVTU into
    ``tmp``) at an opacity threshold no trace sits at; an Apply of the
    deconvolution (few iterations, before the 2x downscale so the scan is
    still >= 16x16); then the downscale. Every published series and the
    image must agree after the Apply and at the end. Returns (3-D view
    comparison, worst difference after the Apply, at the end)."""
    from thz_image_explorer_tpu_torch.ops.rlsep import rl_bands_separable as rl
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    t, cube = synthetic_scan(24, 20, 128, seed=seed)
    exs = {}
    for device in ("cuda", "cpu"):
        ex = Explorer(device=device)
        drive_commands(ex, lambda: ex.open_arrays(t, cube, scan_metadata(1.0)), cube, 2, 2,
                       np.random.default_rng(seed))
        exs[device] = ex
    # the small scan's filtered traces are ~1e-2: at contrast 0.5 every
    # envelope range stays far above the 1e-6 edge
    for ex in exs.values():
        ex.set_3d_contrast(0.5)
    thr = gap_threshold(exs["cpu"].pipeline.output.data, exs["cpu"])
    views = []
    for device, ex in exs.items():
        ex.set_opacity_threshold(thr)
        views.append(view_products(ex, f"{tmp}/small_{device}.vtu"))
    view = compare_views(*views)
    applied, final = [], []
    for device, ex in exs.items():
        ex.set_avg_in_fourier_space(True)
        ex.apply_psf(synthetic_psf())
        for key, value in (("n_filters", 6.0), ("n_iterations", 20.0),
                           ("start_freq", 0.25), ("end_freq", 4.0)):
            ex.set_filter_param("deconvolution", key, value)
        ex.set_filter_active("deconvolution", True)
        before = rl.launches + rl.launches_tiled
        ex.update_filter("deconvolution", force=True)
        assert device == "cpu" or rl.launches + rl.launches_tiled > before, \
            "the small Apply launched no RL kernel"
        applied.append((ex.plot, ex.image))
        ex.set_downscaling(2)
        final.append((ex.plot, ex.image))
    (g, gi), (c, ci) = applied
    assert not np.allclose(gi, final[0][1]), "the Apply left the image unchanged"
    worst_apply = compare_plots(
        g, gi, c, ci, lambda ref: (1e-3 * float(np.abs(ref).max()), 0.0))
    (g, gi), (c, ci) = final
    worst = compare_plots(g, gi, c, ci, lambda ref: (5e-5, 1e-4))
    return dict(threshold=thr, live_points=view[0], dense_points=view[1],
                max_alpha_diff=view[2], max_opacity_diff=view[3]), worst_apply, worst


# ---------------------------------------------------------------- Apply
def drive_apply(ex, n_slider, n_clicks, n_again, rng):
    """The Apply path as a user drives it, on an open scan: the PSF, the
    deconvolution switched on (no rerun), Apply (the first one plans the
    bands on the host), then slider steps and clicks (the deconvolution is
    suppressed: no RL launch), then Apply ``n_again`` times more (the plan
    is cached; the median of the repeats is reported, their host time varies). Each
    Apply launches the cluster kernel once per non-empty checkpoint group
    (``rlsep.launch_plan`` takes the wide route for some of them: counted
    apart as well) and the half-iteration kernel never (the canvas fits a
    cluster).
    Returns (measurements, band geometry, the deconvolution's input at the
    first Apply)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep
    from thz_image_explorer_tpu_torch.ops.rlsep import launch_schedule
    from thz_image_explorer_tpu_torch.ops.rlsep import rl_bands_separable as rl

    def rl_launches():
        return rl.launches + rl.launches_tiled

    p = ex.pipeline
    image_before = ex.image.copy()
    ex.apply_psf(synthetic_psf())
    epoch = p.run_epoch
    ex.set_filter_active("deconvolution", True)
    assert p.run_epoch == epoch, "switching the deconvolution on ran the chain"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex.update_filter("deconvolution", force=True)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    apply_launches, tiled_launches = rl.launches, rl.launches_tiled
    wide_launches = rl.launches_wide
    geometry = p.filters["deconvolution"]._plan_cache[1]
    expected = len(launch_schedule(geometry.n_iter))
    h2 = ex.image.shape[0] + 2 * int(geometry.pad_r.max())
    w2 = ex.image.shape[1] + 2 * int(geometry.pad_c.max())
    kr, kc = geometry.px.shape[1], geometry.py.shape[1]
    s = rlsep.cluster_size_for(h2, w2, kr, kc)
    plan = rlsep.launch_plan(geometry.n_iter, h2, w2, kr, kc, s,
                             rlsep._sms(torch.cuda.current_device()))
    expected_wide = sum(1 for *_, blocks in plan if blocks)
    out = dict(apply_ms=apply_ms, stage_ms=p.timings_ms["deconvolution"],
               rl_launches=apply_launches, rl_launches_expected=expected,
               rl_wide_launches=wide_launches,
               rl_wide_blocks=[list(blocks) for *_, blocks in plan if blocks],
               rl_tiled_launches=tiled_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    assert apply_launches == expected > 0, (apply_launches, expected)
    assert wide_launches == expected_wide, (wide_launches, expected_wide)
    assert tiled_launches == 0, tiled_launches
    width, height = ex.image.shape
    assert np.isfinite(ex.image).all(), "deconvolved image not finite"
    for key in ("filtered_signal", "avg_signal", "signal_fft", "avg_signal_fft"):
        assert np.isfinite(getattr(ex.plot, key)).all(), f"{key} not finite"
    assert np.abs(ex.image - image_before).max() > 1e-3 * np.abs(image_before).max(), \
        "the Apply left the image unchanged"
    k = p.index_of("deconvolution")
    deconv_input = p.slots[k - 1].data

    def run(cmd):
        before = rl_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cmd()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, rl_launches() - before

    slider = [run(lambda i=i: ex.set_fft_window_low(1.3 + 0.05 * i)) for i in range(n_slider)]
    clicks = [run(lambda: ex.set_selected_pixel(int(rng.integers(width)),
                                                int(rng.integers(height))))
              for _ in range(n_clicks)]
    assert all(n == 0 for _ms, n in slider + clicks), (slider, clicks)
    assert p.slots[k] is p.slots[k - 1], "a slider step kept the deconvolved result"
    out.update(slider_ms=[m for m, _ in slider], slider_rl_launches=[n for _, n in slider],
               click_ms=[m for m, _ in clicks], click_rl_launches=[n for _, n in clicks])
    tiled_before, wide_before = rl.launches_tiled, rl.launches_wide
    again, again_stage = [], []
    for _ in range(n_again):
        again.append(run(lambda: ex.update_filter("deconvolution", force=True)))
        again_stage.append(p.timings_ms["deconvolution"])
    assert all(n == apply_launches for _ms, n in again) and rl.launches_tiled == tiled_before, \
        (again, apply_launches)
    assert rl.launches_wide - wide_before == n_again * wide_launches, rl.launches_wide
    assert np.isfinite(ex.image).all()
    again_ms = [m for m, _ in again]
    out.update(apply_again_ms=statistics.median(again_ms), apply_again_ms_runs=again_ms,
               apply_again_stage_ms_runs=again_stage, apply_again_rl_launches=again[0][1])
    return out, geometry, deconv_input


def geometry_summary(geometry, shape):
    n_iter = geometry.n_iter
    return dict(bands=int(len(n_iter)), n_iter_sum=int(n_iter.sum()),
                n_iter_max=int(n_iter.max()), pad_r_max=int(geometry.pad_r.max()),
                pad_c_max=int(geometry.pad_c.max()),
                fft_semantics_bands=int(geometry.use_fft_conv.sum()),
                canvas=[shape[0] + 2 * int(geometry.pad_r.max()),
                        shape[1] + 2 * int(geometry.pad_c.max())])


def rl_bound_ms(geometry, shape, name):
    """The least time for the Apply's RL work: the bytes (the padded
    canvases read and the estimates written once, the profiles read once)
    over the memory rate, and the band-limited operations over the f32
    peak: per band and iteration, on the band's own padded region
    (X + 2 pad_r) x (Y + 2 pad_c), two halves of a kr_b-tap row and a
    kc_b-tap column correlation (2 operations per tap) plus the guard add,
    the division and the multiply. No dense-matrix work is counted."""
    b = len(geometry.n_iter)
    h2 = shape[0] + 2 * int(geometry.pad_r.max())
    w2 = shape[1] + 2 * int(geometry.pad_c.max())
    n_bytes = 2 * b * h2 * w2 * 4 + (geometry.px.size + geometry.py.size) * 4
    kr = 2 * geometry.pad_r.astype(np.int64) + 1
    kc = 2 * geometry.pad_c.astype(np.int64) + 1
    area = (shape[0] + kr - 1) * (shape[1] + kc - 1)
    n_ops = int((geometry.n_iter.astype(np.int64) * area * (4 * kr + 4 * kc + 3)).sum())
    bytes_ms = n_bytes / memory_rate(name) * 1e3
    ops_ms = n_ops / _F32_PEAK * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), n_ops


def rl_errors(got, ref, label):
    """Per band |got - ref| <= _RL_REL_TOL * max|ref|, all finite. Returns
    (max abs error, max per-band relative error)."""
    import torch

    err = (got - ref).abs().amax(dim=(1, 2))
    scale = ref.abs().amax(dim=(1, 2))
    rel = err / torch.clamp(scale, min=1e-30)
    if bool((err > _RL_REL_TOL * scale).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: per-band err {err.tolist()} vs max {scale.tolist()}")
    return float(err.max()), float(rel.max())


def check_rl(padded, px, py, n_iter, label, route, ref=None):
    """``rl_bands_separable`` vs plain on the card, through ``route``
    ("cluster" or "tiled", which the shapes must select): per band
    |kernel - plain| <= _RL_REL_TOL * max|plain|, and two kernel runs
    bit-identical. Returns (max abs error, max per-band relative error)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    fn = rlsep.rl_bands_separable
    before = fn.launches, fn.launches_tiled
    got = fn(padded, px, py, n_iter)
    again = fn(padded, px, py, n_iter)
    counted = fn.launches - before[0], fn.launches_tiled - before[1]
    took = "cluster" if counted[1] == 0 else "tiled"
    assert took == route and (counted[0] == 0) == (route == "tiled"), (label, counted)
    if ref is None:
        ref = rlsep.rl_bands_separable_plain(padded, px, py, n_iter)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two kernel runs differ")
    return rl_errors(got, ref, label)


def check_wide(padded, px, py, n_iter, label, plain=False):
    """The wide route against the cluster route on the card, bit for bit:
    ``rl_bands_separable`` on each route of :func:`rl_route` (``"wide"``
    holds the wide kernel to the cluster route where the package's rule
    keeps the cluster route, as at 200²); each twice (reruns bit-identical),
    its launches and wide launches as the plan says, and timed (device
    time). With ``plain``, the package's rule and the forced wide route are
    also held to ``rl_bands_separable_plain`` run on the card, as
    :func:`check_rl` holds the cluster route at 200²."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    fn = rlsep.rl_bands_separable
    _, h2, w2 = padded.shape
    kr, kc = px.shape[1], py.shape[1]
    s = rlsep.cluster_size_for(h2, w2, kr, kc)
    assert s is not None, (label, padded.shape)
    sms = rlsep._sms(torch.cuda.current_device())
    ref = rlsep.rl_bands_separable_plain(padded, px, py, n_iter) if plain else None
    out, first = {}, None
    for route in ("cluster", "rule", "wide"):
        with rl_route(route):
            plan = rlsep.launch_plan(n_iter, h2, w2, kr, kc, s, sms)
            before = fn.launches, fn.launches_wide
            got = fn(padded, px, py, n_iter)
            counted = fn.launches - before[0], fn.launches_wide - before[1]
            again = fn(padded, px, py, n_iter)
            ms = device_ms(lambda: fn(padded, px, py, n_iter), reps=5, inner=1, warm=1)
        torch.cuda.synchronize()
        wide = [list(blocks) for *_, blocks in plan if blocks]
        assert counted == (len(plan), len(wide)), (label, route, counted, wide)
        bits = got.view(torch.int32)
        assert torch.equal(bits, again.view(torch.int32)), f"{label}: two {route} runs differ"
        if first is None:
            first = bits
        elif not torch.equal(bits, first):
            raise AssertionError(f"{label}: the {route} plan differs from the cluster route")
        out[route] = dict(ms=ms, launches=counted[0], launches_wide=counted[1], wide_blocks=wide)
        if ref is not None and route != "cluster":
            err, rel = rl_errors(got, ref, f"{label} {route} vs plain")
            out[route].update(max_abs_err_vs_plain=err, max_rel_err_vs_plain=rel)
    return dict(shape=list(padded.shape), taps=[kr, kc], n_iter=np.asarray(n_iter).tolist(),
                sms=sms, **out)


def phase_rl_wide(t, cube, dev, smi, seed):
    """The ``rl_wide_vs_cluster`` phase: :func:`check_wide` at the Apply's RL
    inputs of the 200x200 scan, of one rank's band subset of a sharded
    Apply (the last rank of 2 and of 4, as ``band_split`` gives them), of
    the PSF tool's PSF (knife-edge traces of the reference fixture's shape)
    on that scan, and of a 512x512 scan, each with the synthetic PSF at the
    default parameters but the tool's. At 512x512, where the package's rule
    takes the wide route, both routes are also held to the plain version
    on the card (per band |kernel - plain| <= _RL_REL_TOL * max|plain|)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import rlsep
    from thz_image_explorer_tpu_torch.psf_tool.app import PsfToolApp
    from thz_image_explorer_tpu_torch.psf_tool.data_loader import KnifeEdgeMeasurement

    params = dec.DeconvolutionParams()
    data = torch.as_tensor(cube, device=dev)
    n, m = cube.shape[:2]
    geometry = dec.plan_bands(params, synthetic_psf(), t, (n, m), 0.5, 0.5)
    inputs = dec.rl_inputs(data, geometry)
    cases = {"apply200": check_wide(*inputs, "apply200")}
    for world in (2, 4):
        bands = dec.band_split(inputs[3], world)[world - 1]
        mine = torch.as_tensor(bands, device=dev)
        sub = [x.index_select(0, mine).contiguous() for x in inputs[:3]]
        label = f"rank{world - 1}_of_{world}"
        cases[label] = check_wide(*sub, inputs[3][bands], label)
    del inputs, sub
    knife_x = KnifeEdgeMeasurement(*knife_edge_traces(seed=seed))
    knife_y = KnifeEdgeMeasurement(*knife_edge_traces(seed=seed + 1, width_scale=1.2))
    tool = PsfToolApp(device=dev)
    tool.result = drive_psf_tool(knife_x, knife_y, dev)[0]
    tool_geometry = dec.plan_bands(params, tool.runtime_psf(), t, (n, m), 0.5, 0.5)
    cases["psf_tool"] = check_wide(*dec.rl_inputs(data, tool_geometry), "psf_tool")
    del data
    t5, cube5 = synthetic_scan(512, 512, cube.shape[2], seed=seed)
    geometry5 = dec.plan_bands(params, synthetic_psf(), t5, (512, 512), 0.5, 0.5)
    inputs5 = dec.rl_inputs(torch.as_tensor(cube5, device=dev), geometry5)
    del cube5
    cases["apply512"] = check_wide(*inputs5, "apply512", plain=True)
    del inputs5
    torch.cuda.empty_cache()
    emit(phase="rl_wide_vs_cluster", card=smi, crossover=rlsep.WIDE_IDLE_SHARE,
         bit_for_bit=True, cases=cases,
         tolerance=f"apply512 vs plain: per band |kernel-plain| <= {_RL_REL_TOL} * max|plain|",
         timing="ms: the whole RL run, device time behind a spin (device_ms); cluster: no "
                "launch on the wide route; rule: the package's; wide: every launch "
                "rlsep.wide_blocks can split over more blocks than a cluster holds")


def check_bandsum(data, geometry, name):
    """The band-sum kernel against its plain version on the Apply's own
    inputs for the (X, Y, T) cube ``data`` (phases a and b, then the RL
    kernel, as ``deconvolve_cube`` runs them): per bin |kernel - plain| <=
    _BANDSUM_TOL (2B + 8) |spec| sum_b g_b |T_b|, NaN where the plain version
    has NaN, two kernel runs bit-identical, one launch a call. Times, on the
    device: the kernel (behind a spin), the plain version, and phase c both
    ways (with cuFFT's inverse transform and the centre window), against
    the kernel's byte bound."""
    import torch

    from thz_image_explorer_tpu_torch.ops import bandsum as bs
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import rlsep

    bd, spec, energy, padded = dec._rl_operands(data, geometry)
    u = rlsep.rl_bands_separable(padded, bd["px"], bd["py"], bd["n_iter"])
    del padded
    (n, m), bands = spec.shape, u.shape[0]
    x, cols = data.shape[0], data.shape[1]
    offset = (bd["pad_r_max"], bd["pad_c_max"])
    args = (u, energy, bd["taps"], offset, cols)
    plain = bs.weighted_spectrum_plain(spec.clone(), *args)
    before = bs.weighted_spectrum.launches
    got = bs.weighted_spectrum(spec.clone(), *args)
    again = bs.weighted_spectrum(spec.clone(), *args)
    torch.cuda.synchronize()
    assert bs.weighted_spectrum.launches - before == 2
    assert torch.equal(torch.view_as_real(got).view(torch.int32),
                       torch.view_as_real(again).view(torch.int32)), "two kernel runs differ"
    del again
    crop = u[:, offset[0]: offset[0] + x, offset[1]: offset[1] + cols]
    gains = torch.sqrt(torch.clamp(crop, min=0.0) / energy.T.reshape(bands, x, cols))
    scale = spec.abs() * (gains.reshape(bands, -1).T @ bd["taps"].abs())
    nan = torch.isnan(plain)
    assert torch.equal(nan, torch.isnan(got)), "NaN bins differ"
    diff = (got - plain).abs()[~nan]
    scale = scale[~nan]
    tol = _BANDSUM_TOL * (2 * bands + 8)
    worst = float((diff / torch.clamp(scale, min=1e-30)).max())
    assert bool((diff <= tol * scale).all()), (name, worst, tol)
    max_abs = float(diff.max())
    del plain, got, diff, scale, crop, gains, nan
    torch.cuda.empty_cache()
    work = spec.clone()
    shape, t0, t1 = tuple(data.shape), bd["shift"], bd["shift"] + data.shape[2]

    def phase_plain():
        out = torch.fft.irfft(bs.weighted_spectrum_plain(work, *args), n=bd["fft_len"])
        return out[:, t0:t1].reshape(shape)

    kernel_ms = device_ms(lambda: bs.weighted_spectrum(work, *args), reps=5, inner=5)
    plain_ms = time_ms(lambda: bs.weighted_spectrum_plain(work, *args), reps=5, inner=1)
    phase_ms = device_ms(lambda: dec._band_sum(work, u, energy, bd, shape, (0, 0)),
                         reps=5, inner=5)
    phase_plain_ms = time_ms(phase_plain, reps=5, inner=1)
    bound_ms = bs.bound_bytes(n, m, bands) / memory_rate(name) * 1e3
    return dict(shape=[n, m, bands], plan=bs.plan(n, m, bands), max_abs_err=max_abs,
                max_err_over_scale=worst, tolerance_over_scale=tol, kernel_ms=kernel_ms,
                plain_ms=plain_ms, phase_ms=phase_ms, phase_plain_ms=phase_plain_ms,
                bound_ms=bound_ms, bound_by="bytes")


@contextlib.contextmanager
def _patched(module, name, value):
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def rl_route(route):
    """``rlsep.launch_plan`` as the package has it (``"rule"``), with no
    launch on the wide route (``"cluster"``), or with every launch that
    ``rlsep.wide_blocks`` can split over more blocks than a cluster holds
    on the wide route (``"wide"``: the rule's conditions on the idle share
    and on passes lifted)."""
    from thz_image_explorer_tpu_torch.ops import rlsep

    stack = contextlib.ExitStack()
    if route == "cluster":
        stack.enter_context(_patched(rlsep, "wide_blocks", lambda *_a: None))
    elif route == "wide":
        stack.enter_context(_patched(rlsep, "WIDE_IDLE_SHARE", -1.0))
        stack.enter_context(_patched(rlsep, "passes", lambda rows: rows))
    return stack


def preferred_cluster(s):
    """The cluster route at ``s`` CTAs per band where that fits."""
    from thz_image_explorer_tpu_torch.ops import rlsep

    return _patched(rlsep, "PREFERRED_CLUSTER", s)


def half_iteration_route():
    """``rl_bands_separable`` on the half-iteration route whatever the
    canvas: no cluster size fits (``cluster_size_for`` returns None)."""
    from thz_image_explorer_tpu_torch.ops import rlsep

    return _patched(rlsep, "MAX_CLUSTER", 0)


def tiled_rl2d():
    """``richardson_lucy_direct`` on the tiled route whatever the taps."""
    from thz_image_explorer_tpu_torch.ops import rl2d

    return _patched(rl2d, "CLUSTER_MAX_TAPS", 0)


def rl_critical_path_ms(geometry, shape, s, group=1):
    """The cluster kernel's floor: the cluster with the most work (n_iter x
    its region x operations per pixel, as ``rl_bound_ms`` counts them,
    summed over the ``group`` consecutive bands of the descending-n_iter
    order it holds) on its ``s`` SMs at their share of the f32 peak."""
    kr = 2 * geometry.pad_r.astype(np.int64) + 1
    kc = 2 * geometry.pad_c.astype(np.int64) + 1
    area = (shape[0] + kr - 1) * (shape[1] + kc - 1)
    per_band = geometry.n_iter.astype(np.int64) * area * (4 * kr + 4 * kc + 3)
    per_band = per_band[np.argsort(-geometry.n_iter, kind="stable")]
    most = max(int(per_band[i: i + group].sum()) for i in range(0, len(per_band), group))
    return most / (_F32_PEAK * s / _SMS) * 1e3, most


def over_limit_rl_case(dev, gen):
    """B = 1 on a 720x720 canvas with the Apply's widest reach (47 x 57
    taps), 3 iterations: more than 16 CTAs' shared memory holds, so the
    half-iteration route runs it."""
    import torch

    x = torch.arange(47, device=dev, dtype=torch.float32) - 23
    y = torch.arange(57, device=dev, dtype=torch.float32) - 28
    px = torch.exp(-(x - 2.0) ** 2 / 60.0)[None].contiguous()
    py = torch.exp(-(y + 3.0) ** 2 / 90.0)[None].contiguous()
    padded = torch.zeros((1, 720, 720), device=dev)
    padded[0, 23:697, 28:692] = 0.2 + 1.3 * torch.rand((674, 664), device=dev, generator=gen)
    return padded, px, py, np.array([3], np.int64)


def ragged_rl_cases(dev, gen):
    """RL inputs the main Apply does not give: canvases that are no
    multiple of any tile, n_iter with zeros, B = 1, a band with kr*kc <=
    256, a flipped band, a tall canvas, and a column reach wide enough to
    need more than 48 KB of shared memory. Each band's image is positive
    inside its own region and zero in a margin, as a reflect pad leaves it."""
    import torch

    def gauss(k, x0, s):
        x = torch.arange(k, device=dev, dtype=torch.float32) - k // 2
        return torch.exp(-(x - x0) ** 2 / (2 * s * s))

    def case(h2, w2, rows, cols, n_iter, flip=()):
        b = len(n_iter)
        kr = max(len(r) for r in rows) | 1
        kc = max(len(c) for c in cols) | 1
        px = torch.zeros((b, kr), device=dev)
        py = torch.zeros((b, kc), device=dev)
        padded = torch.zeros((b, h2, w2), device=dev)
        for i in range(b):
            r, c = rows[i], cols[i]
            if i in flip:
                r, c = r.flip(0), c.flip(0)
            px[i, (kr - len(r)) // 2:(kr - len(r)) // 2 + len(r)] = r
            py[i, (kc - len(c)) // 2:(kc - len(c)) // 2 + len(c)] = c
            mr, mc = (kr - len(r)) // 2 + 1, (kc - len(c)) // 2 + 1
            padded[i, mr:h2 - mr, mc:w2 - mc] = 0.2 + 1.3 * torch.rand(
                (h2 - 2 * mr, w2 - 2 * mc), device=dev, generator=gen)
        return padded, px, py, np.asarray(n_iter, np.int64)

    return {
        "b1_37x45_5x7taps": case(37, 45, [gauss(5, 0.6, 1.0)], [gauss(7, -0.8, 1.5)], [3]),
        "b3_61x97_flipped_zero_iter": case(
            61, 97, [gauss(9, 1.2, 2.0), gauss(21, -2.5, 4.0), gauss(3, 0.2, 0.7)],
            [gauss(11, -1.0, 2.5), gauss(5, 0.4, 1.0), gauss(31, 3.3, 6.0)],
            [0, 17, 5], flip=(1,)),
        "b5_130x70_tall": case(
            130, 70, [gauss(k, 0.3 * k / 5, k / 4) for k in (13, 7, 25, 3, 41)],
            [gauss(k, -0.2 * k / 5, k / 5) for k in (9, 15, 5, 21, 3)],
            [1, 0, 40, 2, 40], flip=(2, 4)),
        "b2_40x1100_wide_reach": case(
            40, 1100, [gauss(5, 0.5, 1.2), gauss(9, -1.0, 2.0)],
            [gauss(1001, 40.0, 150.0), gauss(301, -12.0, 60.0)], [2, 3], flip=(1,)),
    }


# ---------------------------------------------------------------- 3-D view
#: envelope kernel vs plain: |kernel - plain| on the [0, 1] opacities (sums
#: in another order, powf vs torch.pow, fmaf vs mul + add)
_ENV_TOL = 1e-5
#: a trace whose envelope max lies within this relative distance of the
#: opacity threshold, or whose range lies within it of 1e-6, may take the
#: other branch on a 1-ulp difference; it is counted, not compared
_ENV_EDGE = 1e-5
#: web.py's view cap (web.py:766)
_VIEW_MAX_POINTS = 120_000
#: the view's opacity slider: the synthetic scan's per-trace envelope maxima
#: run ~0.004-0.07 at the default contrast, sigma and radius, so the default
#: 0.1 would zero every trace; a user lowers it so
_VIEW_OPACITY_THRESHOLD = 0.02


def envelope_edges(flat, taps, contrast, thr):
    """Per trace of ``flat`` (N, T): True where the envelope's max or range
    lies at a normalization edge (computed by the plain version's own
    steps, in f32)."""
    import torch
    import torch.nn.functional as F

    r = len(taps) // 2
    t = flat.shape[1]
    taps = torch.as_tensor(taps, device=flat.device)
    p = F.pad(torch.pow(flat * flat, float(contrast)), (r, r))
    env = sum(taps[k] * p[:, k: k + t] for k in range(2 * r + 1))
    lmax, lmin = env.amax(dim=1), env.amin(dim=1)
    rng = lmax - lmin
    return ((lmax - thr).abs() <= _ENV_EDGE * max(abs(thr), 1e-30)) | (
        (rng.abs() - 1e-6).abs() <= _ENV_EDGE * 1e-6)


def check_envelope(flat, taps, contrast, thr, label):
    """Kernel vs plain on the card: |kernel - plain| <= _ENV_TOL on every
    trace off the normalization edges, and two kernel runs bit-identical.
    Returns (max abs error, traces at an edge)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import envelope as env

    got = env.envelope(flat, taps, contrast, thr)
    again = env.envelope(flat, taps, contrast, thr)
    ref = env.envelope_plain(flat, taps, contrast, thr)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two kernel runs differ")
    edge = envelope_edges(flat, taps, contrast, thr)
    err = (got - ref).abs().amax(dim=1)
    err = torch.where(edge, 0.0, err)
    if bool((err > _ENV_TOL).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: max err {float(err.max())} over "
                             f"{int((err > _ENV_TOL).sum())} traces")
    return float(err.max()), int(edge.sum())


def ragged_envelope_cases(dev, gen):
    """Envelope inputs the main path does not give: T = 1000 and 4096, r = 0,
    12 (the largest radius with taps in registers), 13 and 40 (taps in
    shared memory), asymmetric taps, contrast 0 with all-zero traces and
    1.3 (powf) on both routes, taps longer than the trace, T = 777 (no
    multiple of 4: the plain route), N no multiple of a block's warps and
    fewer traces than one block's warps, a 29 000-sample trace (one warp
    with one buffer of each kind), the longest traces the previous kernel
    took at r = 9 and 0 and a longer one (no output buffer: the envelope
    goes through the output row), and traces 4 bytes off a 16-byte
    boundary (the plain route, chosen from the pointer)."""
    import torch

    from thz_image_explorer_tpu_torch.ops.voxel import gaussian_kernel1d

    def traces(n, t, offset=0):
        amp = 0.2 + 1.3 * torch.rand((n, 1), device=dev, generator=gen)
        x = torch.randn((n * t + offset,), device=dev, generator=gen)[offset:].view(n, t)
        return (x * amp) if offset == 0 else x.mul_(amp)

    def asym(k):
        return (0.05 + torch.rand(k, generator=torch.Generator().manual_seed(k))).numpy()

    zeros = traces(301, 512)
    zeros[::7] = 0.0
    shifted = traces(517, 1024, offset=1)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    return {
        # name: (flat, taps, contrast, thr)
        "t1000_n1003_gauss_r9": (traces(1003, 1000), gaussian_kernel1d(3.0, 9), 2.0, 0.1),
        "t1024_n517_r0": (traces(517, 1024), np.array([0.8], np.float32), 2.0, 0.3),
        "t1000_n999_asym_r40": (traces(999, 1000), asym(81), 2.0, 5.0),
        "t777_n1001_asym_r5_c1.3": (traces(1001, 777), asym(11), 1.3, 0.4),
        "t512_n301_c0_zero_traces": (zeros, asym(7), 0.0, 0.01),
        "t20_n64_taps_longer_r30": (traces(64, 20), asym(61), 2.0, 1.0),
        "t4096_n301_gauss_r9": (traces(301, 4096), gaussian_kernel1d(3.0, 9), 2.0, 0.1),
        "t1024_n513_asym_r12_c1.3": (traces(513, 1024), asym(25), 1.3, 0.5),
        "t1024_n257_asym_r13": (traces(257, 1024), asym(27), 2.0, 1.0),
        "t16_n3_r0": (traces(3, 16), np.array([1.1], np.float32), 2.0, 0.2),
        "t29000_n5_gauss_r9": (traces(5, 29_000), gaussian_kernel1d(3.0, 9), 2.0, 0.1),
        "t29037_n3_gauss_r9": (traces(3, 29_037), gaussian_kernel1d(3.0, 9), 2.0, 0.1),
        "t29055_n2_r0": (traces(2, 29_055), np.array([0.7], np.float32), 2.0, 0.1),
        "t40000_n3_gauss_r9": (traces(3, 40_000), gaussian_kernel1d(3.0, 9), 2.0, 0.1),
        "t1024_n517_4_byte_offset_r9": (shifted, gaussian_kernel1d(3.0, 9), 2.0, 0.1),
    }


def check_envelope_plan(n, t, r):
    """The plan the launches of this shape were given is ops/envelope.py's
    own, at the library's compiled shape, which is the module's; the
    library's layout gives it the same shared memory."""
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import envelope as env

    lib = kernels.load("envelope")
    assert env.library_config() == dict(warps=env.WARPS, stages=env.STAGES, run=env.RUN,
                                        max_r=env.MAX_R, smem_per_block=env.SMEM_PER_BLOCK)
    got = env.kernel_plan(n, t, r)
    want = env.plan(t, r)
    assert all(got[k] == v for k, v in want.items()), (n, t, r, got, want)
    args = (got["warps"], got["stages"], got["outs"], t, r)
    assert lib.thz_envelope_smem(*args) == env.layout_bytes(*args) == got["smem"], args
    assert got["blocks"] == env.blocks(n, got["warps"], got["blocks_possible"])
    return got


def view_args(ex):
    """web.py's ``voxels`` call (web.py:790-803) on the Explorer's final
    slot with its 3-D settings: ``(data, keyword arguments)``."""
    out, inp = ex.pipeline.output, ex.pipeline.input
    t = out.time.cpu().numpy()
    v0 = ex.pipeline.valid_wh0 or (inp.width, inp.height)
    v3 = ex.view3d
    return out.data, dict(
        time_span=float(t[-1] - t[0]) if len(t) > 1 else 1.0, scaling=out.scaling,
        original_dims=(v0[0], v0[1], inp.n_time), valid_grid=ex.pipeline.valid_for(out),
        opacity_threshold=float(v3["opacity_threshold"]), contrast=float(v3["contrast"]),
        kernel_sigma=float(v3["kernel_sigma"]), kernel_radius=int(v3["kernel_radius"]))


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def live_view(ex):
    """The live 3-D view as web.py serves it: ``(host ms, result)``."""
    from thz_image_explorer_tpu_torch.ops import voxel

    data, kw = view_args(ex)
    return timed(lambda: voxel.extract_instances_topk(data, max_points=_VIEW_MAX_POINTS, **kw))


def specred_bound_ms(n, f, m, name):
    """Bytes: the spectrum and the masks read once, the amp and increment
    sums written once. Operations per element: amp 4 (2 mul, add, sqrt),
    angle 2 (atan2, the wrapped difference), 2 outputs x m masks x one FMA
    (2 operations)."""
    n_bytes = n * f * 8 + m * n * 4 + 2 * m * f * 4
    n_ops = n * f * (4 + 2 + 2 * 2 * m)
    bytes_ms = n_bytes / memory_rate(name) * 1e3
    ops_ms = n_ops / _F32_PEAK * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def envelope_bound_ms(n, t, r, name):
    """Bytes: the (N, T) f32 traces read and the opacities written once.
    Operations per sample: 2 (2r + 1) for the taps (FMA = 2), the square 1,
    powf 3 (lg2, multiply, ex2), min and max 2, subtract and divide 2."""
    n_bytes = 2 * n * t * 4
    n_ops = n * t * (2 * (2 * r + 1) + 8)
    bytes_ms = n_bytes / memory_rate(name) * 1e3
    ops_ms = n_ops / _F32_PEAK * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def gap_threshold(cube, ex):
    """An opacity threshold midway in the widest gap between the per-trace
    envelope maxima of the (X, Y, T) ``cube`` at ``ex``'s 3-D settings,
    inside their middle half: no trace sits at it, and both branches run."""
    import torch
    import torch.nn.functional as F

    from thz_image_explorer_tpu_torch.ops.voxel import gaussian_kernel1d

    v3 = ex.view3d
    r = int(v3["kernel_radius"])
    taps = gaussian_kernel1d(v3["kernel_sigma"], r).astype(np.float64)
    flat = cube.reshape(-1, cube.shape[-1]).double()
    p = F.pad(torch.pow(flat * flat, float(v3["contrast"])), (r, r))
    env = sum(float(taps[k]) * p[:, k: k + flat.shape[1]] for k in range(2 * r + 1))
    m = np.sort(env.amax(dim=1).cpu().numpy())
    lo, hi = len(m) // 4, 3 * len(m) // 4
    i = lo + int(np.argmax(np.diff(m[lo:hi])))
    assert (env.amax(dim=1) - env.amin(dim=1)).min() > 1e-4, "a trace's range is near 1e-6"
    return float((m[i] + m[i + 1]) / 2)


def view_products(ex, path):
    """The live view, the dense extraction and a SaveVTU of ``ex``'s final
    slot: ``(live result, dense result, points in the .vtu)``."""
    from thz_image_explorer_tpu_torch.ops import voxel

    data, kw = view_args(ex)
    live = voxel.extract_instances_topk(data, max_points=_VIEW_MAX_POINTS, **kw)
    dense = voxel.extract_instances(data, **kw)
    ex.save_vtu(path)
    with open(path) as f:
        head = f.read(400)
    n_vtu = int(head.split('NumberOfPoints="')[1].split('"')[0])
    return live, dense, n_vtu


def compare_views(g, c):
    """Card vs CPU 3-D products. Live view: the same points (keyed by
    position) with alpha within its 1/63 quantization step, except points
    at the q = 1 cut (alpha 1/63) that one side's rounding dropped; the
    threshold within a step. Dense: the same points, opacity within 1e-3
    (the chain's atol 5e-5 raised by the contrast and the per-trace
    normalization), colours within 4e-3 (jet has slope 4). The .vtu holds
    the dense points. Returns (live points, dense points, worst alpha
    difference, worst opacity difference)."""
    (gl, gd, gn), (cl, cd, cn) = g, c
    step = 1.0 / 63.0
    gk = {tuple(np.round(p, 5)): a for p, a in zip(gl[0], gl[1][:, 3])}
    ck = {tuple(np.round(p, 5)): a for p, a in zip(cl[0], cl[1][:, 3])}
    for a, b in ((gk, ck), (ck, gk)):
        for key in set(a) - set(b):
            assert abs(a[key] - step) < 1e-6, ("live view point only on one side", key, a[key])
    common = set(gk) & set(ck)
    assert len(common) > 0
    worst_alpha = max(abs(gk[k] - ck[k]) for k in common)
    assert worst_alpha <= step + 1e-6, worst_alpha
    assert abs(gl[5] - cl[5]) <= step + 1e-6 and gl[2:5] == cl[2:5]
    np.testing.assert_array_equal(gd[0], cd[0])
    np.testing.assert_allclose(gd[1][:, 3], cd[1][:, 3], atol=1e-3)
    np.testing.assert_allclose(gd[1][:, :3], cd[1][:, :3], atol=4e-3)
    assert gd[2:6] == cd[2:6]
    assert gn == len(gd[0]) and cn == len(cd[0])
    return (len(gl[0]), len(gd[0]), float(worst_alpha),
            float(np.abs(gd[1][:, 3] - cd[1][:, 3]).max()))


# ------------------------------------------------------ the 2-D RL kernels
def gauss2d(kr, kc, r0, c0, sr, sc):
    """A normalized off-centre (asymmetric) Gaussian PSF canvas."""
    a = np.arange(kr, dtype=np.float64)[:, None] - kr // 2
    b = np.arange(kc, dtype=np.float64)[None, :] - kc // 2
    k = np.exp(-((a - r0) ** 2) / (2 * sr * sr) - ((b - c0) ** 2) / (2 * sc * sc))
    return (k / k.sum()).astype(np.float32)


def rl2d_bound_ms(h2, w2, kr, kc, n_iter, name):
    """Bytes: the image read, the estimate written and the taps read once.
    Operations: per iteration and pixel 2 kr kc FMAs (4 kr kc operations),
    the guard add, the division and the multiply."""
    n_bytes = (2 * h2 * w2 + kr * kc) * 4
    n_ops = n_iter * h2 * w2 * (4 * kr * kc + 3)
    bytes_ms = n_bytes / memory_rate(name) * 1e3
    ops_ms = n_ops / _F32_PEAK * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def rl2d_floor_ms(h2, w2, kr, kc, n_iter, s):
    """The cluster 2-D kernel's floor: its operations (as ``rl2d_bound_ms``
    counts them) on the ``s`` SMs of its cluster at their share of the f32
    peak."""
    return n_iter * h2 * w2 * (4 * kr * kc + 3) / (_F32_PEAK * s / _SMS) * 1e3


def ragged_rl2d_cases(dev, gen):
    """rl2d inputs ``(padded, psf, n_iter)`` the main case does not give: an
    odd number of rows and a width no multiple of 4, fewer rows than 16, an
    even PSF (whose window sits one sample below "SAME"), a reach longer
    than one slab, 8 x 8 tap tiles (a bank over 9 columns), a 3 x 3 PSF."""
    import torch

    def case(h2, w2, kr, kc, n_iter, r0=0.6, c0=-0.4):
        img = 0.2 + 1.3 * torch.rand((h2, w2), device=dev, generator=gen)
        psf = torch.as_tensor(gauss2d(kr, kc, r0, c0, kr / 4 + 0.5, kc / 4 + 0.5), device=dev)
        return img, psf, n_iter

    return {
        "odd_rows_37x45_9x9": case(37, 45, 9, 9, 20),
        "under_16_rows_11x70_5x7": case(11, 70, 5, 7, 12),
        "even_psf_21x26_6x4": case(21, 26, 6, 4, 9, 0.4, -0.3),
        "reach_past_slab_40x33_21x3": case(40, 33, 21, 3, 7),
        "tiles8_61x97_13x11": case(61, 97, 13, 11, 11),
        "psf3x3_130x70": case(130, 70, 3, 3, 55),
    }


def check_rl2d(padded, psf, n_iter, label, route, ref=None):
    """``richardson_lucy_direct`` vs plain (or ``ref``) on the card through
    ``route`` ("cluster" or "tiled", which the shapes must select): |kernel
    - plain| <= _RL_REL_TOL * max|plain|, all finite, and two kernel runs
    bit-identical. Returns (max abs error, max relative error, (cluster
    launches, tiled launches) of the two runs)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rl2d

    fn = rl2d.richardson_lucy_direct
    took = rl2d.route_for(*padded.shape, *psf.shape)[0]
    assert took == route, (label, took, route)
    before = fn.launches, fn.launches_tiled
    got = fn(padded, psf, n_iter)
    again = fn(padded, psf, n_iter)
    counted = fn.launches - before[0], fn.launches_tiled - before[1]
    assert (counted[1] == 0) == (route == "cluster") and (counted[0] == 0) == (route == "tiled")
    if ref is None:
        ref = rl2d.richardson_lucy_direct_plain(padded, psf, n_iter)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two rl2d kernel runs differ")
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if err > _RL_REL_TOL * scale or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: rl2d err {err} vs max {scale}")
    return err, err / scale, counted


def check_grouped(padded, px, py, n_iter, group, ref, label):
    """The grouped kernel equals ``ref``, ``rl_bands_separable``'s cluster
    route on the same inputs, bit for bit, in one launch per non-empty
    checkpoint group. Returns its launches."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    before = rlsep.rl_bands_separable_grouped.launches
    got = rlsep.rl_bands_separable_grouped(padded, px, py, n_iter, group=group)
    launches = rlsep.rl_bands_separable_grouped.launches - before
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        diff = float((got - ref).abs().max())
        raise AssertionError(f"{label} group={group}: differs from the cluster route by {diff}")
    assert launches == len(rlsep.launch_schedule(n_iter)), (label, group, launches)
    return launches

# ------------------------------------------------------------ tilt, PSF tool
TILT = "tilt_compensation"
DEC = "deconvolution"
#: card vs CPU port, PSF-tool fits (cuFFT vs pocketfft, both float64): the
#: fitted (x0, w) per band and the fitted curves, mm
_PSF_CPU_ATOL = 1e-6


def command_ms(cmd, counter=None):
    """Host ms of one command with a synchronize on each side, and the
    launches ``counter()`` (the sum of the wrappers' counts) grew by."""
    import torch

    before = counter() if counter else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cmd()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, (counter() - before if counter else 0)


def zero_counts():
    """Every kernel wrapper's launch count set to 0."""
    from thz_image_explorer_tpu_torch.ops import bandsum as bs
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import polar, rl2d, rlsep
    from thz_image_explorer_tpu_torch.ops import specred as sr
    from thz_image_explorer_tpu_torch.ops import tilt

    sr.spectral_reduction_sums.launches = 0
    tilt.tilt_insert.launches = 0
    polar.amplitude_phase.launches = 0
    env.envelope.launches = 0
    bs.weighted_spectrum.launches = 0
    rlsep.rl_bands_separable.launches = 0
    rlsep.rl_bands_separable.launches_wide = 0
    rlsep.rl_bands_separable.launches_tiled = 0
    rlsep.rl_bands_separable_grouped.launches = 0
    rl2d.richardson_lucy_direct.launches = 0
    rl2d.richardson_lucy_direct.launches_tiled = 0


def read_counts():
    from thz_image_explorer_tpu_torch.ops import bandsum as bs
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import polar, rl2d, rlsep
    from thz_image_explorer_tpu_torch.ops import specred as sr
    from thz_image_explorer_tpu_torch.ops import tilt

    return dict(specred=sr.spectral_reduction_sums.launches,
                tilt=tilt.tilt_insert.launches,
                polar=polar.amplitude_phase.launches,
                bandsum=bs.weighted_spectrum.launches,
                envelope=env.envelope.launches,
                rlsep_cluster=rlsep.rl_bands_separable.launches,
                rlsep_wide=rlsep.rl_bands_separable.launches_wide,
                rlsep=rlsep.rl_bands_separable.launches_tiled,
                rlsep_grouped=rlsep.rl_bands_separable_grouped.launches,
                rl2d=rl2d.richardson_lucy_direct.launches + rl2d.richardson_lucy_direct.launches_tiled)


def spectral_inputs(ex):
    """The FFT stage's spectrum as (N, F) and the publish's mask stack (the
    pixel mean's all-ones row, then the ROIs): the specred kernel's inputs."""
    import torch

    p = ex.pipeline
    spec = p.slots[p.fft_index].fft
    n = spec.shape[0] * spec.shape[1]
    masks = torch.cat([torch.ones((1, n), device=spec.device), ex._mask_stack.reshape(-1, n)])
    return spec.reshape(n, -1), masks


def check_tilted_publish(ex, n_time):
    p = ex.plot
    nf = n_time // 2 + 1
    for key in ("filtered_time", "filtered_signal", "avg_signal"):
        assert getattr(p, key).shape == (n_time,) and np.isfinite(getattr(p, key)).all(), key
    for key in ("filtered_frequencies", "filtered_signal_fft", "filtered_phase_fft",
                "avg_signal_fft", "avg_phase_fft", "signal_fft"):
        assert getattr(p, key).shape == (nf,) and np.isfinite(getattr(p, key)).all(), key
    assert p.time.shape == (ex.pipeline.input.n_time,)
    assert np.isfinite(p.refractive_index[1:]).all() and p.refractive_index.shape == (nf,)
    assert np.isfinite(ex.image).all()


def drive_tilt(ex, rng, n_slider, n_clicks, n_steps):
    """The tilt path on an open scan with the main path's filters and ROIs:
    tilt on at (2, 2) degrees, slider updates, clicks and tilt-slider steps
    (each reruns from the tilt stage), then (3, 2) and the same, one live 3-D
    view and an Apply after tilt (then five more; one band-sum launch
    each). Returns (per-tilt
    measurements, the spectra and the view's traces for the kernel checks,
    the Apply's measurements)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import bandsum as bs
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import rlsep
    from thz_image_explorer_tpu_torch.ops import specred as sr

    p = ex.pipeline
    width, height = ex.image.shape
    per_tilt, spectra = {}, {}

    def sr_count():
        return sr.spectral_reduction_sums.launches

    for k, (tx, ty) in enumerate(((2.0, 2.0), (3.0, 2.0))):
        ex.set_filter_param(TILT, "tilt_x", tx)
        ex.set_filter_param(TILT, "tilt_y", ty)
        on_ms, _ = command_ms(lambda: ex.set_filter_active(TILT, True) if k == 0
                              else ex.update_filter(TILT))
        n_time, n_freq = p.output.n_time, p.output.n_freq
        check_tilted_publish(ex, n_time)
        slider = [command_ms(lambda i=i: ex.set_fft_window_low(1.0 + 0.05 * (i + 1)), sr_count)
                  for i in range(n_slider)]
        clicks = [command_ms(lambda: ex.set_selected_pixel(int(rng.integers(width)),
                                                           int(rng.integers(height))), sr_count)
                  for _ in range(n_clicks)]
        # tilt-slider steps to new lengths (each T seen for the first time:
        # cuFFT plans for it are made in the step), then the same steps
        # again (plans cached), each with its per-stage ms
        steps, step_t, step_stage_ms, revisit = [], [], [], []
        plans_before = torch.backends.cuda.cufft_plan_cache.size
        for j in range(n_steps):
            ex.set_filter_param(TILT, "tilt_x", tx + 0.02 * (j + 1))
            steps.append(command_ms(lambda: ex.update_filter(TILT), sr_count))
            step_t.append(p.output.n_time)
            step_stage_ms.append({k: round(v, 3) for k, v in p.timings_ms.items()})
        new_plans = torch.backends.cuda.cufft_plan_cache.size - plans_before
        for j in reversed(range(n_steps)):
            ex.set_filter_param(TILT, "tilt_x", tx + 0.02 * (j + 1))
            revisit.append(command_ms(lambda: ex.update_filter(TILT), sr_count))
        ex.set_filter_param(TILT, "tilt_x", tx)
        ex.update_filter(TILT)
        assert p.output.n_time == n_time
        assert all(n == 1 for _ms, n in slider + steps), (slider, steps)
        assert all(n == 0 for _ms, n in clicks), clicks
        check_tilted_publish(ex, n_time)
        spec, masks = spectral_inputs(ex)
        spectra[n_freq] = (spec.clone(), masks.clone())
        per_tilt[f"{tx:g}_{ty:g}"] = dict(
            T=n_time, F=n_freq, T_mod_4=n_time % 4, tilt_on_ms=on_ms,
            slider_ms_median=statistics.median(m for m, _ in slider),
            slider_ms=[m for m, _ in slider], specred_launches_per_update=slider[0][1],
            click_ms_median=statistics.median(m for m, _ in clicks),
            click_ms=[m for m, _ in clicks], specred_launches_per_click=clicks[0][1],
            tilt_step_ms_median=statistics.median(m for m, _ in steps),
            tilt_step_ms=[m for m, _ in steps], tilt_step_T=step_t,
            tilt_step_stage_ms=step_stage_ms, tilt_step_new_cufft_plans=new_plans,
            tilt_revisit_ms_median=statistics.median(m for m, _ in revisit),
            tilt_revisit_ms=[m for m, _ in revisit[::-1]],
            stage_ms=p.timings_ms)
    # the live 3-D view of the tilted final slot (T = 1606: the envelope's
    # plain-load route), then an Apply after tilt
    ex.set_opacity_threshold(_VIEW_OPACITY_THRESHOLD)
    env_before = env.envelope.launches
    view_ms, view = live_view(ex)
    assert env.envelope.launches == env_before + 1
    assert 0 < len(view[0]) <= _VIEW_MAX_POINTS and np.isfinite(view[1]).all()
    view_flat = p.output.data.reshape(width * height, -1)
    rl = rlsep.rl_bands_separable

    def rl_count():
        return rl.launches + rl.launches_tiled

    ex.apply_psf(synthetic_psf())
    ex.set_filter_active(DEC, True)
    bandsum_before = bs.weighted_spectrum.launches
    first_ms, first_rl = command_ms(lambda: ex.update_filter(DEC, force=True), rl_count)
    again = [command_ms(lambda: ex.update_filter(DEC, force=True), rl_count) for _ in range(5)]
    geometry = p.filters[DEC]._plan_cache[1]
    expected = len(rlsep.launch_schedule(geometry.n_iter))
    assert first_rl == expected > 0 and all(n == expected for _m, n in again), (first_rl, again)
    bandsum_launches = bs.weighted_spectrum.launches - bandsum_before
    assert bandsum_launches == 1 + len(again), bandsum_launches
    assert np.isfinite(ex.image).all() and ex.plot.filtered_time.shape == (p.output.n_time,)
    apply = dict(T=p.output.n_time, first_apply_ms=first_ms,
                 apply_again_ms=statistics.median(m for m, _ in again),
                 apply_again_ms_runs=[m for m, _ in again], stage_ms=p.timings_ms[DEC],
                 rl_launches_per_apply=first_rl, rl_launches_expected=expected,
                 bandsum_launches_per_apply=bandsum_launches // (1 + len(again)),
                 geometry=geometry_summary(geometry, (width, height)))
    return per_tilt, spectra, (view_ms, view, view_flat), apply


def cufft_plan_ms(n_rows, lengths):
    """Host ms of the chain's rfft and irfft over an (n_rows, T) f32 batch
    at lengths T no call has used yet: the first call of each (cuFFT makes
    its plan) and the second (the plan cached), a synchronize on each side."""
    import torch

    out = {}
    for t_len in lengths:
        x = torch.randn((n_rows, t_len), device="cuda")
        fwd = [command_ms(lambda: torch.fft.rfft(x))[0] for _ in range(2)]
        spec = torch.fft.rfft(x)
        inv = [command_ms(lambda: torch.fft.irfft(spec, n=t_len))[0] for _ in range(2)]
        out[t_len] = dict(rfft_first_ms=fwd[0], rfft_cached_ms=fwd[1],
                          irfft_first_ms=inv[0], irfft_cached_ms=inv[1])
        del x, spec
    return out


def small_tilt_reference(seed):
    """Card vs CPU on a small scan with tilt active: the main path's
    commands, tilt on at (2, 2), a slider step, a click and a tilt step;
    every published series and the image at the main path's tolerance.
    Returns (T, worst difference)."""
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    t, cube = synthetic_scan(24, 20, 128, seed=seed)
    runs = []
    for device in ("cuda", "cpu"):
        ex = Explorer(device=device)
        drive_commands(ex, lambda: ex.open_arrays(t, cube, scan_metadata(1.0)), cube, 1, 1,
                       np.random.default_rng(seed))
        ex.set_filter_param(TILT, "tilt_x", 2.0)
        ex.set_filter_param(TILT, "tilt_y", 2.0)
        ex.set_filter_active(TILT, True)
        ex.set_fft_window_low(1.4)
        ex.set_selected_pixel(17, 3)
        ex.set_filter_param(TILT, "tilt_x", 3.0)
        ex.update_filter(TILT)
        runs.append((ex.plot, ex.image, ex.pipeline.output.n_time))
    (g, gi, gt), (c, ci, ct) = runs
    assert gt == ct > 128, (gt, ct)
    np.testing.assert_array_equal(g.filtered_time, c.filtered_time)
    return gt, compare_plots(g, gi, c, ci, lambda ref: (5e-5, 1e-4))


#: the tilt kernel's angle sweep: -15 to +15 degrees in 0.05 degree steps
#: (the sliders' range, pipeline/filters.py); tilt_y runs over the same
#: values in another order, so that every angle meets many partners
_TILT_SWEEP = np.round(np.arange(-300, 301) * 0.05, 2)
_TILT_SWEEP_Y = _TILT_SWEEP[(np.arange(601) * 7 + 300) % 601]
#: grids of the sweep: the smoke's 200x200, the 512x512 cells', an odd one;
#: and the pipeline_mesh phase's blocks (mesh shape, grid): the 200x200
#: grid on 1x2 and 2x2 ranks, the downscaled 66x66 grid on 2x2 (33-row
#: blocks)
_TILT_GRIDS = ((200, 200), (512, 512), (193, 157))
_TILT_MESH_BLOCKS = (((1, 2), (200, 200)), ((2, 2), (200, 200)), ((2, 2), (66, 66)))


def tilt_kernel_shifts(grid, origin, block, angles, d=0.5):
    """The tilt kernel's own shifts (its ``shifts`` output) for the block
    ``block`` (w, h) at ``origin`` of ``grid`` at each (tilt_x, tilt_y) of
    ``angles``, each against ``pixel_shifts``: returns (cases, pixels
    compared, pixels that differ, the first difference)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import tilt

    n_time = 8
    data = torch.arange(block[0] * block[1] * n_time, dtype=torch.float32,
                        device="cuda").reshape(*block, n_time)
    time_d = torch.arange(n_time, dtype=torch.float32, device="cuda") * np.float32(0.05)
    shifts = torch.empty(block, dtype=torch.int64, device="cuda")
    compared = differ = 0
    first = None
    for tx, ty in angles:
        n = tilt.extension_steps(*grid, d, d, tx, ty)
        tilt.tilt_insert(data, time_d, n, grid, d, d, tx, ty, origin, shifts=shifts)
        got = shifts.cpu().numpy()
        want = tilt.pixel_shifts(*block, grid, d, d, tx, ty, n, origin)
        bad = int((got != want).sum())
        compared += got.size
        differ += bad
        if bad and first is None:
            first = dict(tilt=[float(tx), float(ty)], grid=list(grid), origin=list(origin),
                         pixels=bad)
    return len(angles), compared, differ, first


def phase_tilt_kernel(t, cube, name, smi):
    """The tilt kernel (``csrc/tilt.cu``) against its plain route on the
    card, bit for bit (output and shifts), at the tilted scans of the tilt
    phase (200x200x1024 at (2, 2) and (3, 2) degrees: T' = 1488, 1606) and
    at 512x512x1024 at (1.0, 1.0) and (1.1, 1.0) degrees (T' = 1620, 1648,
    the scan512.tilt cell's), and at an odd T on an axis from 3.7 ps and
    at T = 13000 (the window computed where it is used, not kept in
    shared memory); its shifts against ``pixel_shifts`` for every
    pixel over the sweep of angles on three grids and on the pipeline_mesh
    phase's blocks; its device ms against its bytes bound (the cube read
    once, the extended cube written once) beside the plain route's."""
    import torch

    from thz_image_explorer_tpu_torch.ops import tilt
    from thz_image_explorer_tpu_torch.parallel import mesh as pm

    gen = torch.Generator(device="cuda").manual_seed(7)
    scans = [("200x200", torch.as_tensor(cube, device="cuda"), torch.as_tensor(t, device="cuda"),
              ((2.0, 2.0), (3.0, 2.0)))]
    t512 = torch.arange(1024, device="cuda", dtype=torch.float32) * np.float32(0.05)
    scans.append(("512x512", torch.randn((512, 512, 1024), generator=gen, device="cuda"), t512,
                  ((1.0, 1.0), (1.1, 1.0))))
    # the window at other axes: an odd length starting at 3.7 ps, and one too
    # long for the window to stay in shared memory (computed where used)
    for label, shape, t0_ps, angles in (("odd", (37, 29, 1023), 3.7, ((2.5, -1.5),)),
                                        ("long", (16, 12, 13000), 0.0, ((1.0, 1.0),))):
        axis = (np.arange(shape[2]) * np.float32(0.05) + np.float32(t0_ps)).astype(np.float32)
        scans.append((label, torch.randn(shape, generator=gen, device="cuda"),
                      torch.as_tensor(axis, device="cuda"), angles))
    cases = {}
    for label, data, time_d, angles in scans:
        data = data - data[:, :, :1]  # the DC offset stage before it
        grid = tuple(data.shape[:2])
        for tx, ty in angles:
            n = tilt.extension_steps(*grid, 0.5, 0.5, tx, ty)
            shifts = torch.empty(grid, dtype=torch.int64, device="cuda")
            before = tilt.tilt_insert.launches
            got = tilt.tilt_insert(data, time_d, n, grid, 0.5, 0.5, tx, ty, shifts=shifts)
            assert tilt.tilt_insert.launches == before + 1
            want = tilt.tilt_insert_plain(data, time_d, n, grid, 0.5, 0.5, tx, ty)
            torch.cuda.synchronize()
            t_out = int(got.shape[2])
            assert got.shape == want.shape and torch.equal(got, want), (label, tx, ty)
            assert np.array_equal(shifts.cpu().numpy(),
                                  tilt.pixel_shifts(*grid, grid, 0.5, 0.5, tx, ty, n))
            again = tilt.tilt_insert(data, time_d, n, grid, 0.5, 0.5, tx, ty)
            assert torch.equal(again, got), (label, tx, ty)
            del want, again
            entry = dict(T=int(data.shape[2]), T_out=t_out, bit_for_bit=True, shifts_equal=True,
                         rerun_bit_identical=True)
            if label == "512x512":
                n_pix = grid[0] * grid[1]
                n_bytes = (n_pix * data.shape[2] + n_pix * t_out) * 4
                bound = n_bytes / memory_rate(name) * 1e3
                ms = device_ms(lambda: tilt.tilt_insert(data, time_d, n, grid, 0.5, 0.5, tx, ty))
                plain = time_ms(lambda: tilt.tilt_insert_plain(data, time_d, n, grid, 0.5, 0.5,
                                                               tx, ty), reps=5, inner=2)
                entry.update(kernel_ms=ms, bound_ms=bound, bound_by="bytes",
                             roofline_pct=100.0 * bound / ms, plain_ms=plain)
            cases[f"{label}_{tx:g}_{ty:g}"] = entry
            del got
        del data, time_d
        torch.cuda.empty_cache()
    assert {1488, 1606, 1620, 1648} <= {c["T_out"] for c in cases.values()}, cases
    sweep = list(zip(_TILT_SWEEP.tolist(), _TILT_SWEEP_Y.tolist()))
    grids = {}
    for grid in _TILT_GRIDS:
        n_cases, compared, differ, first = tilt_kernel_shifts(grid, (0, 0), grid, sweep)
        grids[f"{grid[0]}x{grid[1]}"] = dict(angles=n_cases, pixels=compared, differ=differ,
                                             first_difference=first)
    for shape, grid in _TILT_MESH_BLOCKS:
        mesh = pm.Mesh(shape)
        tot = [0, 0]
        first = None
        for r in range(mesh.world):
            x0, x1, y0, y1 = mesh.block(r, grid)
            got = tilt_kernel_shifts(grid, (x0, y0), (x1 - x0, y1 - y0), sweep)
            tot = [a + b for a, b in zip(tot, got[1:3])]
            first = first or got[3]
        grids[f"mesh{shape[0]}x{shape[1]}_{grid[0]}x{grid[1]}"] = dict(
            angles=len(sweep), blocks=mesh.world, pixels=tot[0], differ=tot[1],
            first_difference=first)
    assert all(g["differ"] == 0 for g in grids.values()), grids
    emit(phase="tilt_kernel", card=smi, cases=cases, shifts=grids,
         sweep_degrees=[float(_TILT_SWEEP[0]), float(_TILT_SWEEP[-1]), 0.05],
         replaces="none: thz_image_explorer_tpu/ops/tilt.py's shifts and gather, in XLA",
         timing="kernel: device time behind a spin (device_ms); plain: CUDA events over "
                "back-to-back calls (time_ms)")


def torch_cuda_scan_chunk(rows, f):
    """The bins a chunk of PyTorch's CUDA ``cumsum`` of ``rows`` rows of
    ``f`` bins takes (ATen's ``get_log_num_threads_x_inner_scan``, uint32
    arithmetic, two bins a thread); 0 for a single row (CUB's scan). Where
    it is 32, ``csrc/polar.cu`` sums in PyTorch's order."""
    if rows == 1:
        return 0
    lx = ly = 0
    while (1 << lx) < f:
        lx += 1
    while (1 << ly) < rows:
        ly += 1
    lx = ((9 + ((lx - ly) & 0xFFFFFFFF)) & 0xFFFFFFFF) // 2
    return 2 << min(max(4, lx), 9)


def polar_instructions(so_path, unroll):
    """SASS instructions per bin of ``polar_unwrap_kernel<false>``: its
    innermost loop (``unroll`` chunks of 32 bins, a bin a lane each), a
    static count (the slow paths of the accurate hypotf and atan2f count
    too)."""
    loops = [lp for lp in sass_loops(so_path, "polar_unwrap_kernelILb0E") if lp["SHFL.IDX"]]
    return max(sum(lp.values()) for lp in loops) / unroll if loops else None


def check_polar(spec, label):
    """``csrc/polar.cu`` against its plain route on ``spec`` (..., F): the
    amplitudes and the wrapped steps bit for bit, the phases bit for bit
    where PyTorch's scan takes the kernel's chunks of 32 and within
    2 k 2^-24 sum_{j <= k} |inc_j| of the plain route everywhere, a rerun
    bit-identical. Returns the record of the case."""
    import torch

    from thz_image_explorer_tpu_torch.ops import polar

    def bits(x):
        return x.view(torch.int32)

    f = int(spec.shape[-1])
    rows = spec.numel() // f
    inc = torch.empty(spec.shape, dtype=torch.float32, device=spec.device)
    want_inc = torch.empty_like(inc)
    before = polar.amplitude_phase.launches
    amp, ph = polar.amplitude_phase(spec, increments=inc)
    assert polar.amplitude_phase.launches == before + 1, label
    want_amp, want_ph = polar.amplitude_phase_plain(spec, increments=want_inc)
    torch.cuda.synchronize()
    assert torch.equal(bits(amp), bits(want_amp)), (label, "amplitudes")
    assert torch.equal(bits(inc), bits(want_inc)), (label, "wrapped steps")
    inc2, ph2, want2 = (x.reshape(rows, f) for x in (inc, ph, want_ph))
    k = torch.arange(f, device=spec.device, dtype=torch.float64)
    bound = 2.0 * k * 2.0**-24 * torch.cumsum(inc2.double().abs(), dim=-1)
    gap = (ph2.double() - want2.double()).abs()
    finite = torch.isfinite(bound)
    assert bool((gap[finite] <= bound[finite]).all()), (label, "phases beyond the bound")
    chunk = torch_cuda_scan_chunk(rows, f)
    same = bool(torch.equal(bits(ph), bits(want_ph)))
    assert same or chunk != 32, (label, "phases differ where PyTorch takes the kernel's order")
    again = polar.amplitude_phase(spec)
    assert torch.equal(bits(again[0]), bits(amp)) and torch.equal(bits(again[1]), bits(ph)), \
        (label, "rerun")
    rel = (gap[finite] / bound[finite].clamp_min(1e-30)).max().item() if f > 1 else 0.0
    return dict(rows=rows, F=f, amplitudes_bit_for_bit=True, steps_bit_for_bit=True,
                phases_bit_for_bit=same, torch_scan_chunk=chunk,
                phase_gap_over_bound=rel, rerun_bit_identical=True)


def phase_polar_kernel(name, smi):
    """The FFT stage's kernel (``csrc/polar.cu``) against its plain route on
    the card (:func:`check_polar`) on the spectra of 512x512 scans at
    T = 1024 (F = 513, the drag cell's) and T' = 1620, 1648 (F = 811, 825,
    the tilt cell's), at T = 13000 (F = 6501; 80x80 rows, where PyTorch's
    scan takes chunks of 32, and 16x12 rows, where it takes chunks of 256),
    a single row and a NaN bin; a block's rows (the first and last half of
    the 512x512 cube) against the whole cube's, bit for bit; at each of the
    first four shapes, its device ms beside its bytes bound (the spectrum
    read once, the two planes written once), the plain route's ms and the
    issue floor."""
    import torch

    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import polar

    gen = torch.Generator(device="cuda").manual_seed(11)
    clock = sm_clock_hz()
    per_bin = polar_instructions(kernels.library_path("polar"),
                                 polar.config(kernels.load("polar"))[2])
    cases = {}
    for label, shape, timed in (("512x512_T1024", (512, 512, 1024), True),
                                ("512x512_T1620", (512, 512, 1620), True),
                                ("512x512_T1648", (512, 512, 1648), True),
                                ("80x80_T13000", (80, 80, 13000), True),
                                ("16x12_T13000", (16, 12, 13000), False),
                                ("1x1_T1024", (1, 1, 1024), False)):
        spec = torch.fft.rfft(torch.randn(shape, generator=gen, device="cuda"), dim=-1)
        entry = check_polar(spec, label)
        if label.startswith("512x512"):
            half = shape[0] // 2
            amp, ph = polar.amplitude_phase(spec)
            for x0, x1 in ((0, half), (half, shape[0])):
                b_amp, b_ph = polar.amplitude_phase(spec[x0:x1].contiguous())
                assert torch.equal(b_amp.view(torch.int32), amp[x0:x1].view(torch.int32))
                assert torch.equal(b_ph.view(torch.int32), ph[x0:x1].view(torch.int32))
            entry["block_rows_bit_for_bit"] = True
            del amp, ph, b_amp, b_ph
        if timed:
            rows, f = entry["rows"], entry["F"]
            bound = rows * f * 16 / memory_rate(name) * 1e3
            ms = device_ms(lambda: polar.amplitude_phase(spec))
            entry.update(kernel_ms=ms, bound_ms=bound, bound_by="bytes",
                         roofline_pct=100.0 * bound / ms,
                         issue_floor_ms=(issue_floor_ms(per_bin, rows * -(-f // 32) * 32, clock)
                                         if per_bin else None),
                         plain_ms=time_ms(lambda: polar.amplitude_phase_plain(spec),
                                          reps=5, inner=2))
        cases[label] = entry
        del spec
        torch.cuda.empty_cache()
    nan_spec = torch.fft.rfft(torch.randn((64, 48, 1024), generator=gen, device="cuda"), dim=-1)
    nan_spec[5, 7, 200] = complex(float("nan"), 1.0)
    a_nan, p_nan = polar.amplitude_phase(nan_spec)
    w_nan = polar.amplitude_phase_plain(nan_spec)
    assert torch.equal(torch.isnan(a_nan), torch.isnan(w_nan[0]))
    assert torch.equal(torch.isnan(p_nan), torch.isnan(w_nan[1]))
    assert int(torch.isnan(p_nan).sum()) == 513 - 200
    emit(phase="polar_kernel", card=smi, cases=cases, sass_per_bin=per_bin, sm_clock_hz=clock,
         nan_bin="NaN from the bin on in the phases, at the bin alone in the amplitudes, "
                 "as the plain route",
         replaces="none: the JAX package's amplitude, angle and unwrap in XLA "
                  "(thz_image_explorer_tpu/ops/fourier.py:forward_fft)",
         timing="kernel: device time behind a spin (device_ms); plain: CUDA events over "
                "back-to-back calls (time_ms)")
    return cases


def replan_alloc_ms(shape_f):
    """What the replan's three zeroed cube-sized spectra (c64 + 2 x f32)
    would cost per tilt step: host ms of allocating and zeroing them, a
    synchronize on each side (median of 5), and their bytes."""
    import torch

    w, h, f = shape_f
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = [torch.zeros((w, h, f), dtype=dt, device="cuda")
                for dt in (torch.complex64, torch.float32, torch.float32)]
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        del kept
    return statistics.median(runs), w * h * f * 16


def fir_reference(traces, taps):
    """float64 numpy 'same' correlation of every trace with every band's
    taps ((P, T) x (B, L) -> (B, P, T)), by rows of 16 positions."""
    n_taps = taps.shape[1]
    mid = n_taps // 2
    padded = np.pad(traces, ((0, 0), (mid, n_taps - 1 - mid)))
    out = np.empty((taps.shape[0],) + traces.shape)
    for i in range(0, traces.shape[0], 16):
        win = np.lib.stride_tricks.sliding_window_view(padded[i: i + 16], n_taps, axis=1)
        out[:, i: i + 16] = np.einsum("ptl,bl->bpt", win, taps, optimize=True)
    return out


def drive_psf_tool(mx, my, dev):
    """The PSF tool on the card: ``compute_psf`` on the two axes' knife-edge
    measurements with the default FilterParams. Returns (result, whole ms,
    the device filtering calls' ms)."""
    from thz_image_explorer_tpu_torch.psf_tool import fitting
    from thz_image_explorer_tpu_torch.psf_tool.app import FilterParams, compute_psf

    calls = []
    real = fitting.filter_and_intensity_all_bands

    def timed_filter(traces, taps, device=None):
        ms, out = timed(lambda: real(traces, taps, device))
        calls.append(ms)
        return out

    fitting.filter_and_intensity_all_bands = timed_filter
    try:
        whole_ms, res = timed(lambda: compute_psf(mx, my, FilterParams(), device=dev))
    finally:
        fitting.filter_and_intensity_all_bands = real
    assert res is not None and res.curve_fits is not None
    for ax in (res.x, res.y):
        for side in (ax.beam_fits, ax.beam_fits_left, ax.beam_fits_right):
            assert side.filtered_traces_x.device.type == "cuda"
    return res, whole_ms, calls


def compare_psf_fits(g, c):
    """Card vs CPU port fits: per band (x0, w) of every half and axis and
    the fitted curves on 0.1-10 THz. Returns the largest difference (mm)."""
    worst = 0.0
    for ax in ("x", "y"):
        for side in ("beam_fits", "beam_fits_left", "beam_fits_right"):
            a = getattr(getattr(g, ax), side).popt_xs
            b = getattr(getattr(c, ax), side).popt_xs
            worst = max(worst, float(np.abs(a - b).max()))
    f = np.linspace(0.1, 10.0, 200)
    for name in ("wx_fit", "wy_fit"):
        worst = max(worst, float(np.abs(getattr(g.curve_fits, name).evaluate(f)
                                        - getattr(c.curve_fits, name).evaluate(f)).max()))
    for name in ("x0_fit", "y0_fit"):
        worst = max(worst, float(np.abs(getattr(g.curve_fits, name).evaluate_const_extrap(f)
                                        - getattr(c.curve_fits, name).evaluate_const_extrap(f)).max()))
    assert worst <= _PSF_CPU_ATOL, worst
    return worst


def drive_open_ref(ex, t, cube):
    """A reference pulse loaded through the array seam (the scan's mean
    trace, DC removed, scaled) as the optical reference, ROI 1 and then the
    selected pixel as the sample; then tilt on, where the pulse's bin count
    no longer matches: the selection is skipped with one warning and no
    n/alpha/kappa are published. Returns the published optical series and
    the warnings."""
    import logging

    from thz_image_explorer_tpu_torch.pipeline import explorer as explorer_mod

    pulse = cube.mean(axis=(0, 1)) - cube.mean(axis=(0, 1))[0]
    ex.open_ref_arrays(t, 1.2 * pulse)
    ex.set_reference("Reference File")
    ex.set_sample("ROI 1")
    nf = len(t) // 2 + 1
    p = ex.plot
    assert p.refractive_index.shape == (nf,) and np.isfinite(p.refractive_index[1:]).all()
    optical = {k: getattr(p, k).copy() for k in ("refractive_index", "absorption_coefficient",
                                                  "extinction_coefficient")}
    roi1 = next(u for u, (n, _p) in ex.rois.items() if n == "ROI 1")
    pulse_uuid = next(u for u, (n, _p) in ex.rois.items() if n == "Reference File")
    inputs = dict(samp=(p.roi_signal_fft[roi1][1], p.roi_phase[roi1][1]),
                  ref=(p.roi_signal_fft[pulse_uuid][1], p.roi_phase[pulse_uuid][1]),
                  freq=p.filtered_frequencies.copy(), thickness=ex.sample_thickness)
    ex.set_sample("Selected Pixel")
    ex.set_selected_pixel(40, 60)
    assert np.isfinite(ex.plot.refractive_index[1:]).all()

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(level=logging.WARNING)
    explorer_mod.log.addHandler(handler)
    try:
        ex.set_filter_param(TILT, "tilt_x", 2.0)
        ex.set_filter_param(TILT, "tilt_y", 2.0)
        ex.set_filter_active(TILT, True)
        ex.set_selected_pixel(41, 60)
        ex.set_fft_window_low(1.2)
    finally:
        explorer_mod.log.removeHandler(handler)
    skipped = [r for r in records if "skipped" in r]
    assert len(skipped) == 1 and "Reference File" in skipped[0], records
    assert ex.plot.refractive_index.shape == (0,), "a mismatched pulse was published"
    ex.set_filter_active(TILT, False)
    assert ex.plot.refractive_index.shape == (nf,)
    return optical, inputs, skipped


def check_open_ref_optical(optical, inputs):
    """The published n/alpha/kappa against the optical formula on the CPU
    from the published pulse and ROI spectra: the same function of the same
    inputs. Returns the largest relative difference."""
    import torch

    from thz_image_explorer_tpu_torch.ops.optical import calculate_optical_properties

    want = calculate_optical_properties(
        *(torch.as_tensor(v) for v in inputs["samp"]), *(torch.as_tensor(v) for v in inputs["ref"]),
        torch.as_tensor(inputs["freq"]), float(inputs["thickness"]))
    worst = 0.0
    for (key, got), ref in zip(optical.items(), want):
        ref = ref.numpy()[1:]
        got = got[1:]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max(), err_msg=key)
        worst = max(worst, float((np.abs(got - ref) / (np.abs(ref) + 1e-30)).max()))
    return worst



# ------------------------------------------------------- the web/CLI shell
#: the web Apply's wait for its first fresh state, and every HTTP call's
_SHELL_WAIT_S = 120.0


class ShellClient:
    """HTTP calls to the shell's server on 127.0.0.1, with the loopback
    Host and Origin headers the page sends."""

    def __init__(self, port):
        self.port = port

    def request(self, method, url, body=None):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=_SHELL_WAIT_S)
        headers = {"Host": f"localhost:{self.port}"}
        if body is not None:
            body = json.dumps(body)
            headers.update({"Content-Type": "application/json",
                            "Origin": f"http://localhost:{self.port}"})
        try:
            conn.request(method, url, body=body, headers=headers)
            r = conn.getresponse()
            raw = r.read()
        finally:
            conn.close()
        assert r.status == 200, (method, url, r.status, raw[:300])
        return json.loads(raw)

    def post(self, method, args=(), kwargs=None):
        out = self.request("POST", "/api/command",
                           {"method": method, "args": list(args), "kwargs": kwargs or {}})
        assert out.get("ok") is True, (method, out)

    def state(self):
        return self.request("GET", "/api/state")

    def fresh_state(self, pred=lambda s: True):
        """Poll /api/state until a state built after everything queued
        (neither busy nor the stale fallback) satisfies ``pred``."""
        deadline = time.perf_counter() + _SHELL_WAIT_S
        while time.perf_counter() < deadline:
            s = self.state()
            if not s.get("stale") and not s["busy"] and pred(s):
                return s
        raise AssertionError("no fresh state within the wait")


def counts_since(before):
    """Each kernel's launches since the ``read_counts()`` taken as ``before``."""
    now = read_counts()
    return {k: now[k] - before[k] for k in now}


def shell_commands(client_or_app, width, height):
    """The main path's filters, ROIs and optical selection (``drive_commands``)
    as shell commands: POSTs through a client, or ``WebApp.command``."""
    cmds = [("set_filter_active", [u, True]) for u in
            ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch")]
    cmds += [("add_roi", [f"roi-{i}", f"ROI {i}", [list(p) for p in poly]])
             for i, poly in enumerate(roi_polygons(width, height))]
    cmds += [("set_reference", ["ROI 0"]), ("set_sample", ["Selected Pixel"])]
    for method, args in cmds:
        if isinstance(client_or_app, ShellClient):
            client_or_app.post(method, args)
        else:
            client_or_app.command(method, args, {})


def shell_series_diff(web_state, expected_state):
    """Largest difference between two states' plot series, relative to
    one ``_series`` rounding unit (1e-6 absolute) plus 1e-6 of the value."""
    worst = 0.0
    for key, ref in expected_state["plots"].items():
        got = web_state["plots"][key]
        pairs = []
        if isinstance(ref, dict):
            assert set(got) == set(ref), key
            for u in ref:
                pairs.append((got[u]["y"], ref[u]["y"]))
        else:
            pairs.append((got, ref))
        for g, r in pairs:
            assert len(g) == len(r), key
            for a, b in zip(g, r):
                if a is None or b is None:
                    assert a is None and b is None, key
                    continue
                worst = max(worst, abs(a - b) / (1e-6 + 1e-6 * abs(b)))
    return worst


def shell_card_vs_cpu(t, cube):
    """The shell's command list on a small scan through two WebApps, one on
    the card and one on the CPU: every plot series of the two states within
    the main path's atol 5e-5 / rtol 1e-4. Returns the worst excess over the
    tolerance (<= 0 passes) and the points compared."""
    from thz_image_explorer_tpu_torch.web import WebApp

    states = []
    for device in ("cuda", "cpu"):
        app = WebApp(device=device)
        try:
            # arrays cannot be POSTed: the open goes to the worker itself
            app.worker.send("open_arrays", t, cube, scan_metadata(1.0))
            shell_commands(app, cube.shape[0], cube.shape[1])
            app.command("set_fft_window_low", [1.2], {})
            app.command("set_selected_pixel", [5, 7], {})
            assert app.worker.join_idle(_SHELL_WAIT_S)
            assert not app.worker.failures, list(app.worker.failures)
            states.append(app.state())
        finally:
            app.worker.close()
    worst, n = -np.inf, 0
    for key, ref in states[1]["plots"].items():
        got = states[0]["plots"][key]
        pairs = ([(got[u]["y"], ref[u]["y"]) for u in ref] if isinstance(ref, dict)
                 else [(got, ref)])
        for g, r in pairs:
            if not r or not isinstance(r[0], (int, float, type(None))):
                continue
            g = np.array([np.nan if v is None else v for v in g], np.float64)
            r = np.array([np.nan if v is None else v for v in r], np.float64)
            assert g.shape == r.shape and np.array_equal(np.isnan(g), np.isnan(r)), key
            ok = ~np.isnan(r)
            excess = np.abs(g[ok] - r[ok]) - (5e-5 + 1e-4 * np.abs(r[ok]))
            if excess.size:
                worst = max(worst, float(excess.max()))
                n += int(excess.size)
    assert worst <= 0.0, ("card vs CPU shell states differ", worst)
    return worst, n


def dotthz_file_size(t, cube, work, device="cuda"):
    """The dotTHz file path at one scan size, each step timed in host ms
    with a synchronize on each side: save_file, the host read of the file
    (GB/s) and its cube bit for bit, the two-phase open's preview and final
    from the file and from ``open_arrays`` in turns (arrays, file, file,
    arrays), load_metadata, update_metadata twice (no cube byte changes,
    the file grows by its new header only) and open_pulse. The file is
    deleted at the end."""
    import os

    from thz_image_explorer_tpu_torch.io import dotthz, hdf5
    from thz_image_explorer_tpu_torch.pipeline import Explorer
    from thz_image_explorer_tpu_torch.pipeline.worker import ExplorerWorker
    from thz_image_explorer_tpu_torch.web import WebApp

    width, height, n_time = cube.shape
    md = scan_metadata(0.5)
    path = f"{work}/scan{width}.thzimg"
    pulse_path = f"{work}/pulse{width}.thz"
    rec = dict(shape=[width, height, n_time], cube_bytes=int(cube.nbytes))
    try:
        ex = Explorer(device=device)
        ex.open_arrays(t, cube, md)
        saved = ex.pipeline.input.data.cpu().numpy()  # what save_file writes
        rec["save_ms"] = host_ms(lambda: ex.save_file(path), device)[0]
        rec["file_bytes"] = os.path.getsize(path)
        del ex
        rec["read_ms"] = []
        for _ in range(3):
            ms, host = host_ms(lambda: dotthz.open_scan_host(path), device)
            assert host.data.dtype == np.float32 and np.array_equal(host.data, saved), \
                "the file's cube differs from the saved one"
            rec["read_ms"].append(ms)
            del host
        rec["read_gb_s"] = cube.nbytes / (statistics.median(rec["read_ms"]) * 1e-3) / 1e9

        worker = ExplorerWorker(device=device)
        try:
            app = WebApp(worker, load_settings=False)
            routes = {"arrays": lambda: worker.send("open_arrays", t, cube, md),
                      "file": lambda: app.command("open_file", [path], {})}
            opens = {"arrays": [], "file": []}
            for route in ("arrays", "file", "file", "arrays"):
                opens[route].append(two_phase_open(app, routes[route], width, height, n_time))
            opened = worker.call(lambda e: e.pipeline.input.data.cpu().numpy(),
                                 timeout=_SHELL_WAIT_S)
            assert np.array_equal(opened, saved)
        finally:
            worker.close()
        for route, runs in opens.items():
            rec[f"{route}_preview_ms"] = [p for p, _ in runs]
            rec[f"{route}_final_ms"] = [f for _, f in runs]

        rec["load_metadata_ms"], got = host_ms(lambda: dotthz.load_metadata(path), device)
        assert got.md == md.md, got.md
        got.md["note"] = "updated in place"
        size = os.path.getsize(path)
        # the first update's fsync also flushes the cube save_file left in the
        # page cache; the second finds nothing else to flush
        rec["update_metadata_ms"] = host_ms(lambda: dotthz.update_metadata(path, got), device)[0]
        rec["update_grew_bytes"] = os.path.getsize(path) - size
        assert 0 < rec["update_grew_bytes"] < 64 * 1024, rec["update_grew_bytes"]
        assert dotthz.load_metadata(path).md["note"] == "updated in place"
        got.md["note"] = "updated again"
        rec["update_metadata_again_ms"] = host_ms(lambda: dotthz.update_metadata(path, got),
                                                  device)[0]
        assert dotthz.load_metadata(path).md["note"] == "updated again"
        with hdf5.File(path) as f:
            assert np.array_equal(f["Image"]["ds2"][()], saved), "update_metadata moved the cube"

        trace = cube[width // 2, height // 2]
        with hdf5.File(pulse_path, "w") as f:
            f.create_group("Reference").create_dataset(
                "ds1", data=np.stack([t, trace], 1).astype(np.float32))
        rec["open_pulse_ms"], (pt, ps, _) = host_ms(lambda: dotthz.open_pulse(pulse_path), device)
        assert np.array_equal(pt, t) and np.array_equal(ps, trace)
    finally:
        for p in (path, pulse_path):
            if os.path.exists(p):
                os.remove(p)
    return rec


def phase_shell(t, cube, seed):
    """The shell on the card: the worker with its coalescing FIFO,
    the two-phase open, the HTTP server, a slider drag, state polls, clicks,
    the 3-D view, a web Apply, an abort, the web state against a direct
    Explorer, card vs CPU, and ``psf-diagnostics`` in a subprocess. Every
    launch count is set to 0 at its start; returns the phase's record, its
    ``launches`` read at its end."""
    import os
    import threading
    from http.server import ThreadingHTTPServer

    import torch

    from thz_image_explorer_tpu_torch.io.psf_npz import save_psf
    from thz_image_explorer_tpu_torch.ops import rlsep
    from thz_image_explorer_tpu_torch.pipeline import Explorer
    from thz_image_explorer_tpu_torch.pipeline.worker import ExplorerWorker
    from thz_image_explorer_tpu_torch.utils.dragbench import replay_drag
    from thz_image_explorer_tpu_torch.web import WebApp, make_handler

    width, height = cube.shape[0], cube.shape[1]
    tmp = tempfile.TemporaryDirectory()
    old_xdg = os.environ.get("XDG_CONFIG_HOME")
    os.environ["XDG_CONFIG_HOME"] = f"{tmp.name}/config"
    rec = {}
    worker = ExplorerWorker(device="cuda")
    server = thread = None
    try:
        # 1-2. the worker on the card; the page's open command on the
        # user's file: the open's preview, then its final
        app = WebApp(worker, load_settings=False)
        path = write_scan_file(f"{tmp.name}/scan.thzimg", t, cube, scan_metadata(0.5))
        zero_counts()
        rec["preview_ms"], rec["final_ms"] = two_phase_open(
            app, lambda: app.command("open_file", [path], {}), width, height, len(t))
        rec["opened"] = "the page's open_file command on a dotTHz file (io/hdf5.py)"

        # 3. the server on a free loopback port
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        client = ShellClient(server.server_address[1])

        # 4. filters and ROIs as POSTs
        shell_commands(client, width, height)
        client.fresh_state(lambda s: len(s["rois"]) == 4)

        # 5. a 100-event drag at 8 ms
        before = read_counts()
        drag = replay_drag(client.port, n_events=100, lo=1.0, hi=1.5, interval_s=0.008,
                           settle_timeout_s=_SHELL_WAIT_S, app=app)
        drag_counts = counts_since(before)
        rec["drag"] = {k: v for k, v in drag.items() if k != "drag_note"}
        rec["drag_specred_launches"] = drag_counts["specred"]
        assert drag["drag_unsatisfied_events"] == 0, drag
        assert drag_counts["specred"] == drag["drag_chain_updates"] > 0, (drag_counts, drag)

        # 6. the state poll, PNG cache hit and miss (the midpoint alternates)
        client.fresh_state()
        hit = []
        for _ in range(20):
            t1 = time.perf_counter()
            client.state()
            hit.append((time.perf_counter() - t1) * 1e3)
        miss = []
        for i in range(20):
            client.request("POST", "/api/command",
                           {"method": "set_view", "args": ["midpoint", 40 + 20 * (i % 2)]})
            t1 = time.perf_counter()
            client.state()
            miss.append((time.perf_counter() - t1) * 1e3)
        client.request("POST", "/api/command", {"method": "set_view", "args": ["midpoint", 50]})
        rec.update(state_hit_ms=statistics.median(hit), state_miss_ms=statistics.median(miss),
                   state_hit_ms_runs=hit, state_miss_ms_runs=miss)

        # 7. 20 clicks, each POST followed by the state that shows it
        rng = np.random.default_rng(seed)
        before = read_counts()
        click_ms, last_px = [], None
        for _ in range(20):
            last_px = [int(rng.integers(width)), int(rng.integers(height))]
            t1 = time.perf_counter()
            client.post("set_selected_pixel", last_px)
            client.fresh_state(lambda s, p=last_px: s["pixel"] == p)
            click_ms.append((time.perf_counter() - t1) * 1e3)
        click_counts = counts_since(before)
        assert not any(click_counts.values()), click_counts
        rec.update(click_ms=statistics.median(click_ms), click_ms_runs=click_ms,
                   click_launches=click_counts)

        # 8. the 3-D view endpoint, 11 times
        before = read_counts()
        vox_ms, vox = [], None
        for _ in range(11):
            t1 = time.perf_counter()
            vox = client.request("GET", f"/api/voxels?threshold={_VIEW_OPACITY_THRESHOLD}")
            vox_ms.append((time.perf_counter() - t1) * 1e3)
        vox_counts = counts_since(before)
        assert vox_counts["envelope"] == 11 and 0 < vox["n"] <= _VIEW_MAX_POINTS, \
            (vox_counts, vox.get("n"))
        rec.update(voxels_ms=statistics.median(vox_ms), voxels_ms_runs=vox_ms,
                   voxels_points=vox["n"], voxels_launches=vox_counts)

        # 11 (taken here, before the deconvolution). the web state against a
        # direct Explorer on the card given the same commands
        web_state = client.fresh_state()
        web_image = worker.call(lambda ex: ex.image.copy(), timeout=_SHELL_WAIT_S)
        direct = Explorer(device="cuda")
        direct.open_arrays(t, cube, scan_metadata(0.5))
        for u in ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch"):
            direct.set_filter_active(u, True)
        for i, poly in enumerate(roi_polygons(width, height)):
            direct.add_roi(f"roi-{i}", f"ROI {i}", poly)
        direct.set_reference("ROI 0")
        direct.set_sample("Selected Pixel")
        direct.set_fft_window_low(web_state["config"]["fft_window"][0])
        direct.set_selected_pixel(*last_px)
        expected = app._build_state(direct)
        rec["web_vs_direct_series_units"] = shell_series_diff(web_state, expected)
        rec["web_vs_direct_image_max_abs"] = float(np.abs(web_image - direct.image).max())
        assert rec["web_vs_direct_series_units"] <= 1.0, rec["web_vs_direct_series_units"]
        assert rec["web_vs_direct_image_max_abs"] <= 1e-6 * float(np.abs(direct.image).max())
        del direct

        # 9. the PSF as a file, then Apply by POST
        psf_path = f"{tmp.name}/synthetic_psf.npz"
        save_psf(psf_path, synthetic_psf())
        client.post("open_psf", [psf_path])
        client.post("set_filter_active", ["deconvolution", True])
        client.fresh_state(lambda s: s["filters"]["deconvolution"]["active"])
        applies = []
        for _ in range(2):  # the first plans the bands on the host
            before = read_counts()
            t1 = time.perf_counter()
            client.post("update_filter", ["deconvolution"], {"force": True})
            s = client.fresh_state(lambda s: s["filters"]["deconvolution"]["progress"] is None)
            applies.append(((time.perf_counter() - t1) * 1e3, counts_since(before)))
        geometry = worker.explorer.pipeline.filters["deconvolution"]._plan_cache[1]
        expected_launches = len(rlsep.launch_schedule(geometry.n_iter))
        for _ms, counts in applies:
            assert counts["rlsep_cluster"] == expected_launches == 9 and counts["rlsep"] == 0, \
                counts
            assert counts["bandsum"] == 1, counts
        assert s["filters"]["deconvolution"]["time_ms"] > 0
        rec.update(apply_first_ms=applies[0][0], apply_again_ms=applies[1][0],
                   apply_rl_launches=[c["rlsep_cluster"] for _m, c in applies])

        # 10. a second Apply, aborted by POST after its first checkpoint:
        # the progress the deconvolution reports after a group of
        # iterations triggers the POST (sent from the worker's thread)
        aborted = threading.Event()
        progress = worker.explorer.pipeline.progress

        class AbortAfterFirstCheckpoint(dict):
            def __setitem__(self, key, value):
                super().__setitem__(key, value)
                if key == "deconvolution" and value and 0 < value < 1 and not aborted.is_set():
                    rec["abort_at_progress"] = value
                    client.post("abort")
                    aborted.t = time.perf_counter()
                    aborted.set()

        worker.explorer.pipeline.progress = AbortAfterFirstCheckpoint(progress)
        try:
            before = read_counts()
            client.post("update_filter", ["deconvolution"], {"force": True})
            assert aborted.wait(_SHELL_WAIT_S), "the Apply reached no checkpoint"
            client.fresh_state()
            rec["abort_to_responsive_ms"] = (time.perf_counter() - aborted.t) * 1e3
        finally:
            worker.explorer.pipeline.progress = dict(worker.explorer.pipeline.progress)
        abort_counts = counts_since(before)
        rec["abort_rl_launches"] = abort_counts["rlsep_cluster"]
        assert 0 < abort_counts["rlsep_cluster"] < expected_launches, abort_counts
        assert abort_counts["bandsum"] == 0, abort_counts
        assert not worker.failures, list(worker.failures)

        # 12. card vs CPU on a small scan, through two WebApps
        ts, cs = synthetic_scan(24, 20, 128, seed=seed)
        rec["card_vs_cpu_worst_excess"], rec["card_vs_cpu_points"] = shell_card_vs_cpu(ts, cs)

        # 13. the CLI's psf-diagnostics on the PSF file, in a subprocess
        r = subprocess.run([sys.executable, "-m", "thz_image_explorer_tpu_torch",
                            "psf-diagnostics", psf_path], capture_output=True, text=True,
                           timeout=300, cwd=str(Path(__file__).resolve().parent))
        assert r.returncode == 0 and "PSF Diagnostics" in r.stdout, r.stderr[-2000:]
        rec["psf_diagnostics_exit"] = r.returncode
        torch.cuda.synchronize()
        rec["launches"] = read_counts()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        worker.close()
        if old_xdg is None:
            os.environ.pop("XDG_CONFIG_HOME", None)
        else:
            os.environ["XDG_CONFIG_HOME"] = old_xdg
        tmp.cleanup()
    return rec


# ------------------------------------------------------ the multi_device phase
#: the sharded path's chain: the main path's filters, its 4 ROIs, a pixel
_MD_CFG = dict(td_before_active=True, fd_active=True, notch_active=True)
_MD_PIXEL = (77, 123)
#: slider steps each rank runs (window_low 1.05, 1.10, ...)
_MD_STEPS = 5
#: a spawned world's limit, start-up and the first Apply's planning included
_MD_TIMEOUT_S = 300.0
#: sharded vs one rank: means, ROI and pixel series (the main path's
#: tolerance; phases to its rtol times the running sum of their increments)
_MD_ATOL, _MD_RTOL = 5e-5, 1e-4
#: the Apply's cube, |sharded - one rank| <= this * max|one rank|
_MD_APPLY_TOL = 1e-4
#: per-pixel outputs that are not bit for bit: within this * max
_MD_PIXEL_TOL = 1e-6
_MD_SERIES = ("avg_signal", "roi_trace", "pix_sig", "pix_amp", "pix_ph", "avg_fft", "avg_amp",
              "avg_ph", "roi_amp", "roi_ph")
_MD_PHASES = ("pix_ph", "avg_ph", "roi_ph")


def published(ex):
    """Every published plot series and the image, as host arrays."""
    import dataclasses

    out = {"image": np.array(ex.image)}
    for field in dataclasses.fields(ex.plot):
        value = getattr(ex.plot, field.name)
        if isinstance(value, dict):
            for key, (label, series) in value.items():
                out[f"{field.name}/{key}/{label}"] = np.array(series)
        elif isinstance(value, np.ndarray):
            out[field.name] = np.array(value)
    return out


def same_published(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes()
        for k in a)


#: the filter mask bit of lzf in the smoke's lzf files (shuffle first, then lzf)
_LZF_BIT = 1 << 1


def lzf_decoder_timings(path):
    """The C LZF decoder alone on every compressed chunk of ``path``'s cube
    (host ms, median of 3 passes) and on one chunk (median of 5), against its
    plain version on that chunk (one call); both give the chunk's bytes."""
    from thz_image_explorer_tpu_torch.io import hdf5, lzf

    with hdf5.File(path) as f:
        d = f["Image"]["ds2"]
        size = int(np.prod(d.chunks)) * d.dtype.itemsize
        stored = [d.read_direct_chunk((i, 0, 0)) for i in range(d.shape[0])]
    streams = [raw for mask, raw in stored if not mask & _LZF_BIT]
    assert streams, "no chunk of the lzf file was compressed"
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = [lzf.decompress(s, size) for s in streams]
        passes.append((time.perf_counter() - t0) * 1e3)
    one = []
    for _ in range(5):
        t0 = time.perf_counter()
        lzf.decompress(streams[0], size)
        one.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    plain = lzf.decompress_plain(streams[0], size)
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert plain == out[0] and all(len(o) == size for o in out)
    return dict(chunks=len(stored), chunks_compressed=len(streams),
                chunks_stored_raw=len(stored) - len(streams), chunk_bytes=size,
                stream_bytes=sum(len(s) for s in streams), decode_ms=statistics.median(passes),
                decode_ms_runs=passes,
                decode_gb_s=len(streams) * size / (statistics.median(passes) * 1e-3) / 1e9,
                one_chunk_ms=statistics.median(one), one_chunk_plain_ms=plain_ms)


def dotthz_features_size(t, cube, work, device="cuda"):
    """The scan saved by the port's writer chunked one scan line a chunk,
    (1, H, T), twice: gzip level 4 + shuffle, and lzf + shuffle (without
    the shuffle LZF does not shrink a line of noisy f32 samples, and every
    chunk would be stored raw). Each file: save ms, its bytes against the
    cube's, 3 reads through ``open_scan_host`` (ms, GB/s of cube bytes), the
    cube bit for bit the contiguous file's; the lzf file's chunks through
    the C decoder alone. Returns (record, {kind: path}); the paths are the
    contiguous and lzf files, left for the caller to delete."""
    import os

    from thz_image_explorer_tpu_torch.io import dotthz

    width, height, n_time = cube.shape
    md = scan_metadata(0.5)
    paths = {"contiguous": f"{work}/features{width}.thzimg"}
    write_scan_file(paths["contiguous"], t, cube, md)
    ref = dotthz.open_scan_host(paths["contiguous"]).data
    rec = dict(shape=[width, height, n_time], cube_bytes=int(cube.nbytes),
               chunks=[1, height, n_time], chunk_bytes=height * n_time * 4)
    for kind, kw in (("gzip", dict(compression="gzip", compression_opts=4, shuffle=True)),
                     ("lzf", dict(compression="lzf", shuffle=True))):
        path = paths[kind] = f"{work}/features{width}_{kind}.thzimg"
        r = rec[kind] = dict(filters=kw)
        r["save_ms"] = host_ms(lambda: write_scan_file(path, t, cube, md,
                                                       chunks=(1, height, n_time), **kw),
                               device)[0]
        r["file_bytes"] = os.path.getsize(path)
        r["file_over_cube"] = r["file_bytes"] / cube.nbytes
        r["read_ms"] = []
        for _ in range(3):
            ms, host = host_ms(lambda: dotthz.open_scan_host(path), device)
            assert host.data.dtype == ref.dtype and host.data.tobytes() == ref.tobytes(), \
                f"the {kind} file's cube differs from the contiguous file's"
            r["read_ms"].append(ms)
            del host
        r["read_gb_s"] = cube.nbytes / (statistics.median(r["read_ms"]) * 1e-3) / 1e9
        r["cube_bit_for_bit"] = True
    rec["lzf_decoder"] = lzf_decoder_timings(paths["lzf"])
    os.remove(paths.pop("gzip"))
    return rec, paths


def features_open(path, width, height, n_time, seed, device="cuda"):
    """The page's ``open_file`` of ``path`` (two-phase: preview and final
    ms), then, on the worker's Explorer, the main path's filters, ROIs and
    optical selection, 3 slider steps and 5 clicks: each command's ms, its
    specred launches and what it published."""
    from thz_image_explorer_tpu_torch.ops.specred import spectral_reduction_sums as sr
    from thz_image_explorer_tpu_torch.pipeline.worker import ExplorerWorker
    from thz_image_explorer_tpu_torch.web import WebApp

    worker = ExplorerWorker(device=device)
    try:
        app = WebApp(worker, load_settings=False)
        preview_ms, final_ms = two_phase_open(
            app, lambda: app.command("open_file", [path], {}), width, height, n_time)

        def drive(ex):
            for uuid in ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch"):
                ex.set_filter_active(uuid, True)
            for i, poly in enumerate(roi_polygons(width, height)):
                ex.add_roi(f"roi-{i}", f"ROI {i}", poly)
            ex.set_reference("ROI 0")
            ex.set_sample("Selected Pixel")
            rng = np.random.default_rng(seed)
            cmds = [("slider", lambda i=i: ex.set_fft_window_low(1.0 + 0.05 * (i + 1)))
                    for i in range(3)]
            cmds += [("click", lambda x=int(rng.integers(width)), y=int(rng.integers(height)):
                      ex.set_selected_pixel(x, y)) for _ in range(5)]
            steps = []
            for kind, cmd in cmds:
                ms, launches = command_ms(cmd, lambda: sr.launches)
                steps.append(dict(kind=kind, ms=ms, specred=launches, published=published(ex)))
            return steps

        steps = worker.call(drive, timeout=_SHELL_WAIT_S)
    finally:
        worker.close()
    return preview_ms, final_ms, steps


def phase_dotthz_features(t, cube, t5, cube5, seed, device="cuda"):
    """The ``dotthz_features`` phase: chunked gzip and lzf files at both
    sizes, the 200² lzf file opened through the page and driven against the
    contiguous file's open (its launch counts zeroed just before and read
    just after), and the committed fixtures."""
    import os

    out = {}
    with tempfile.TemporaryDirectory() as work:
        for w, tt, cc in ((cube.shape[0], t, cube), (cube5.shape[0], t5, cube5)):
            rec, paths = dotthz_features_size(tt, cc, work, device)
            out[f"grid{w}"] = rec
            if cc is cube:
                width, height, n_time = cube.shape
                runs = {}
                for kind in ("contiguous", "lzf"):
                    if kind == "lzf":
                        zero_counts()
                    runs[kind] = features_open(paths[kind], width, height, n_time, seed, device)
                launches = read_counts()
                (c_pre, c_fin, c_steps), (z_pre, z_fin, z_steps) = runs["contiguous"], runs["lzf"]
                for a, b in zip(c_steps, z_steps):
                    assert same_published(a["published"], b["published"]), \
                        f"the lzf file's {a['kind']} published other series than the contiguous"
                per = {k: [s["specred"] for s in z_steps if s["kind"] == k]
                       for k in ("slider", "click")}
                assert per["slider"] == [1, 1, 1] and per["click"] == [0] * 5, per
                assert launches["specred"] > 0, launches
                out["main_path_lzf"] = dict(
                    shape=[width, height, n_time], launches=launches,
                    specred_per_slider_step=per["slider"], specred_per_click=per["click"],
                    series_and_image_bit_for_bit=True,
                    series_compared=len(z_steps[0]["published"]),
                    lzf=dict(preview_ms=z_pre, final_ms=z_fin,
                             slider_ms=[s["ms"] for s in z_steps if s["kind"] == "slider"],
                             click_ms=[s["ms"] for s in z_steps if s["kind"] == "click"]),
                    contiguous=dict(preview_ms=c_pre, final_ms=c_fin,
                                    slider_ms=[s["ms"] for s in c_steps if s["kind"] == "slider"],
                                    click_ms=[s["ms"] for s in c_steps if s["kind"] == "click"]))
            for p in paths.values():
                os.remove(p)
    out["fixtures"] = check_fixtures()
    return out


def check_fixtures():
    """The committed fixtures of ``tests/data/torch_hdf5`` (h5py's
    libver="latest" chunk indexes, lzf, SWMR files, bool, enum, compound
    and array metadata, string notes) opened without h5py: every dataset
    equal to its regeneration from the seed with numpy, the scan's cube and
    time through ``open_scan_host``, every metadata field the JAX package's
    string in ``expected.json``."""
    import dataclasses
    import importlib.util

    from thz_image_explorer_tpu_torch.io import dotthz, hdf5

    here = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "make_torch_hdf5_fixtures", here / "scripts" / "make_torch_hdf5_fixtures.py")
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    folder = here / "tests" / "data" / "torch_hdf5"
    expected = json.loads((folder / "expected.json").read_text())
    arrays = fixtures.fixture_arrays(expected["seed"])
    rec = {}
    for name in fixtures.FILES:
        path = str(folder / name)
        want = arrays[name]
        t0 = time.perf_counter()
        host = dotthz.open_scan_host(path)
        open_ms = (time.perf_counter() - t0) * 1e3
        assert host.data.tobytes() == want["ds2"].tobytes(), f"{name}: the cube differs"
        assert host.time.tobytes() == want["ds1"].tobytes(), f"{name}: the time axis differs"
        with hdf5.File(path) as f:
            for key, value in want.items():
                got = f["Image"][key][()]
                same = (got == value) if isinstance(value, bytes) else (
                    got.dtype == value.dtype and got.shape == value.shape
                    and (got.tolist() == value.tolist() if value.dtype == object
                         else got.tobytes() == value.tobytes()))
                assert same, f"{name}: {key} differs from its regeneration"
        md = dataclasses.asdict(dotthz.load_metadata(path))
        assert md == expected["files"][name]["metadata"], f"{name}: metadata {md}"
        rec[name] = dict(open_ms=open_ms, datasets=len(want), metadata_fields=len(md["md"]),
                         equal=True)
    return rec


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, device):
    """Host ms of ``fn()`` with a synchronize on each side, and its result."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3, out


class CollectiveMeter:
    """Counts the ``all_reduce`` calls the port makes, their bytes and
    their host ms (a synchronize on each side) while the context is open."""

    def __init__(self, device):
        self.device, self.calls, self.bytes, self.ms = device, 0, 0, 0.0

    def __enter__(self):
        import torch.distributed as dist

        self._orig = dist.all_reduce

        def metered(tensor, *a, **kw):
            ms, out = host_ms(lambda: self._orig(tensor, *a, **kw), self.device)
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            self.ms += ms
            return out

        dist.all_reduce = metered
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self._orig


def md_masks(width, height, device):
    """The main path's 4 polygon ROIs as an (R, X, Y) f32 stack."""
    import torch

    from thz_image_explorer_tpu_torch.ops.roi import polygon_mask

    return torch.as_tensor(np.stack([polygon_mask(p, (width, height)) for p in
                                     roi_polygons(width, height)]).astype(np.float32),
                           device=device)


def md_view(data, cube, mesh=None):
    """The live view (web.py's settings, the smoke's threshold) of the
    final data: the block's with a mesh."""
    from thz_image_explorer_tpu_torch.ops import voxel

    t = cube.time.cpu().numpy()
    kw = dict(mesh=mesh, origin=cube.origin, grid=cube.grid) if mesh is not None else {}
    return voxel.extract_instances_topk(
        data, float(t[-1] - t[0]), 1, (*cube.grid_wh, cube.n_time), max_points=_VIEW_MAX_POINTS,
        opacity_threshold=_VIEW_OPACITY_THRESHOLD, contrast=2.0, kernel_sigma=3.0,
        kernel_radius=9, **kw)


def md_path(cube, t, mesh, device, n_steps=_MD_STEPS, apply=True):
    """The sharded main path on ``cube`` (a block with a mesh): ``n_steps``
    slider steps of ``lean_update``, one Apply of the deconvolution (default
    parameters, the synthetic PSF) on the last step's data and one live
    view of it. Returns (results, host ms of each step, Apply ms, view ms,
    geometry)."""
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.parallel.step import StepConfig, StepParams, lean_update

    masks = md_masks(*cube.grid_wh, device)
    cfg = StepConfig(**_MD_CFG)
    step_ms = []
    for i in range(n_steps):
        params = StepParams(window_low=1.0 + 0.05 * (i + 1))
        ms, out = host_ms(lambda: lean_update(cube, params, cfg, masks, _MD_PIXEL, mesh), device)
        step_ms.append(ms)
    if not apply:
        return out, step_ms, None, None, None
    geometry = dec.plan_bands(dec.DeconvolutionParams(), synthetic_psf(), t, cube.grid_wh, 0.5, 0.5)
    kw = dict(mesh=mesh, origin=cube.origin, grid=cube.grid) if mesh is not None else {}
    apply_ms, out["apply"] = host_ms(lambda: dec.deconvolve_cube(out["data"], geometry, **kw),
                                     device)
    view_ms, out["view"] = host_ms(lambda: md_view(out["data"], cube, mesh), device)
    return out, step_ms, apply_ms, view_ms, geometry


#: the downscale of the multi-device phase's scaled step (divides neither
#: 200 nor the 1x2 and 2x2 blocks of 200)
_MD_SCALE = 3


def md_scaled_step(cube, mesh, device):
    """One ``lean_update`` at scale :data:`_MD_SCALE` (the main path's
    filters, its ROIs rasterized on the downscaled grid, the pixel divided):
    each rank's output is the mesh's block of the downscaled grid, the
    ``Pipeline(mesh=)``'s layout. Returns (host ms, host numpy results
    prefixed ``s3_``, with the output block's origin)."""
    import torch

    from thz_image_explorer_tpu_torch.ops.roi import polygon_mask
    from thz_image_explorer_tpu_torch.parallel.step import StepConfig, StepParams, lean_update

    s = _MD_SCALE
    grid = (cube.grid_wh[0] // s, cube.grid_wh[1] // s)
    masks = torch.as_tensor(np.stack([polygon_mask(p, grid, s)
                                      for p in roi_polygons(*cube.grid_wh)]).astype(np.float32),
                            device=device)
    pix = (_MD_PIXEL[0] // s, _MD_PIXEL[1] // s)
    cfg, params = StepConfig(**_MD_CFG, scale=s), StepParams(window_low=1.0 + 0.05 * _MD_STEPS)
    ms, out = host_ms(lambda: lean_update(cube, params, cfg, masks, pix, mesh), device)
    host = {f"s3_{k}": (torch.view_as_real(v) if v.is_complex() else v).cpu().numpy()
            for k, v in out.items()}
    host["s3_origin"] = np.asarray(mesh.block(None, grid)[::2] if mesh is not None else (0, 0))
    return ms, host


def md_compare_scaled(got, ref, label):
    """A scaled step's results (``md_scaled_step``'s) against the single
    device's: the block's data and image bit for bit (or within 1e-6 *
    max), the series at the main path's tolerance. Returns (largest
    differences, which per-pixel outputs are bit for bit)."""
    x0, y0 = (int(v) for v in got["s3_origin"])
    diffs, equal = {}, {}
    for key in ("s3_data", "s3_img"):
        g = got[key]
        w = ref[key][x0: x0 + g.shape[0], y0: y0 + g.shape[1]]
        assert g.shape == w.shape and g.size, (label, key, g.shape, w.shape)
        d = float(np.abs(g - w).max())
        equal[key] = bool(np.array_equal(g, w))
        assert equal[key] or d <= _MD_PIXEL_TOL * float(np.abs(w).max()), (label, key, d)
        diffs[key] = d
    for key in _MD_SERIES:
        g, w = got[f"s3_{key}"], ref[f"s3_{key}"]
        if key in _MD_PHASES:
            diffs[key] = md_phase_close(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=_MD_ATOL, rtol=_MD_RTOL, err_msg=f"{label} {key}")
            diffs[key] = float(np.abs(g - w).max())
    return diffs, equal


def md_host(out, open_data, open_img, origin):
    """A path's results as host numpy, for the comparisons."""
    import torch

    host = {k: (torch.view_as_real(v) if v.is_complex() else v).cpu().numpy()
            for k, v in out.items() if k != "view"}
    pos, rgba, *dims, thr = out["view"]
    host.update(open_data=open_data.cpu().numpy(), open_img=open_img.cpu().numpy(),
                origin=np.asarray(origin), view_pos=pos, view_rgba=rgba,
                view_dims=np.asarray(dims), view_thr=np.asarray(thr))
    return host


def multi_device_rank(rank, world, store, npy, t, mode, outdir, device="cuda"):
    """One rank of a spawned multi-device run (gloo, all ranks on one card):
    open its block of the memory-mapped scan, drive the sharded path with
    every launch count at 0 just before and read just after, then time the
    collectives and a repeat Apply, check its kernel calls against their
    plain versions on its block, and write ``rank<r>.npz`` and
    ``rank<r>.json`` (``rank<r>.err`` on a failure). ``mode`` "scale": the
    open and 3 steps only, with the peak device memory."""
    try:
        _multi_device_rank(rank, world, store, npy, t, mode, outdir, device)
    except BaseException:
        import traceback

        Path(outdir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _multi_device_rank(rank, world, store, npy, t, mode, outdir, device):
    import torch
    import torch.distributed as dist

    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import voxel
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_arrays_sharded
    from thz_image_explorer_tpu_torch.parallel.step import (StepConfig, StepParams, _spectrum,
                                                              lean_update)

    entered_at = time.time()
    mesh = pm.init(device, backend="gloo", init_method=f"file://{store}", rank=rank,
                   world_size=world, timeout_s=_MD_TIMEOUT_S)
    res = dict(rank=rank, world=world, mesh=list(mesh.shape), entered_at=entered_at,
               init_s=time.time() - entered_at)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        mm = np.load(npy, mmap_mode="r")
        open_ms, (cube, img, _) = host_ms(lambda: open_arrays_sharded(
            t, mm, mesh, metadata=scan_metadata(0.5), device=device), device)
        res.update(open_ms=open_ms, block=list(mesh.block(None, cube.grid)))
        if mode != "scale":
            res["thz_open_ms"] = open_thz_block(npy, mesh, cube, img, device)
        if mode == "scale":
            out, step_ms, *_ = md_path(cube, t, mesh, device, n_steps=3, apply=False)
            assert bool(torch.isfinite(out["avg_amp"]).all()) and bool(torch.isfinite(out["img"]).all())
            res.update(update_ms=step_ms, peak_bytes=torch.cuda.max_memory_allocated()
                       if torch.device(device).type == "cuda" else None)
            return
        zero_counts()
        out, step_ms, apply_ms, view_ms, geometry = md_path(cube, t, mesh, device)
        res.update(launches=read_counts(), update_ms=step_ms, apply_ms=apply_ms, view_ms=view_ms)
        # the collectives: of an update, of a repeat Apply, of a view
        cfg, params = StepConfig(**_MD_CFG), StepParams(window_low=1.0 + 0.05 * _MD_STEPS)
        masks = md_masks(*cube.grid, device)
        kw = dict(mesh=mesh, origin=cube.origin, grid=cube.grid)
        with CollectiveMeter(device) as m:
            ms = [host_ms(lambda: lean_update(cube, params, cfg, masks, _MD_PIXEL, mesh),
                          device)[0] for _ in range(3)]
        res.update(update_metered_ms=ms, update_collective_ms=m.ms / 3,
                   update_collective_bytes=m.bytes // 3, update_collective_calls=m.calls // 3)
        with CollectiveMeter(device) as m:
            res["apply_again_ms"] = host_ms(lambda: dec.deconvolve_cube(
                out["data"], geometry, **kw), device)[0]
        res.update(apply_collective_ms=m.ms, apply_collective_bytes=m.bytes,
                   apply_collective_calls=m.calls)
        with CollectiveMeter(device) as m:
            res["view_again_ms"] = host_ms(lambda: md_view(out["data"], cube, mesh), device)[0]
        res.update(view_collective_ms=m.ms, view_collective_bytes=m.bytes,
                   view_collective_calls=m.calls)
        res["bands"] = dec.band_split(geometry.n_iter, world)[rank].tolist()
        zero_counts()
        res["scaled_step_ms"], scaled = md_scaled_step(cube, mesh, device)
        res["scaled_step_launches"] = read_counts()
        # this rank's kernel calls against their plain versions, on its block
        if torch.device(device).type == "cuda":
            c, window = _spectrum(cube, params, cfg)
            spec = torch.fft.rfft(c.data * window, dim=-1)
            n = spec.shape[0] * spec.shape[1]
            x0, y0 = cube.origin
            stack = torch.cat([torch.ones((1, n), device=device),
                               masks[:, x0: x0 + cube.width, y0: y0 + cube.height].reshape(-1, n)])
            res["specred_max_abs_err"] = check_specred(spec.reshape(n, -1), stack, True,
                                                       f"rank {rank} block")[0]
            taps = voxel.gaussian_kernel1d(3.0, 9)
            flat = out["data"].reshape(n, -1)
            res["envelope_max_abs_err"] = check_envelope(flat, taps, 2.0, _VIEW_OPACITY_THRESHOLD,
                                                         f"rank {rank} block")[0]
            assert env.envelope.launches > 0
        np.savez(Path(outdir, f"rank{rank}.npz"), **md_host(out, cube.data, img, cube.origin),
                 **scaled)
    finally:
        Path(outdir, f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def open_thz_block(npy, mesh, cube, img, device):
    """This rank's block through ``open_scan_sharded`` from the dotTHz file
    beside ``npy`` (the same scan and metadata): its cube, intensity image
    and place equal to the ``.npy`` route's. Returns the open's host ms."""
    import torch

    from thz_image_explorer_tpu_torch.parallel import open_scan_sharded

    ms, (c, i, _) = host_ms(lambda: open_scan_sharded(str(Path(npy).with_suffix(".thz")),
                                                      mesh, device=device), device)
    assert torch.equal(c.data, cube.data) and torch.equal(i, img), "the .thz block differs"
    assert (c.origin, c.grid, c.valid_wh, c.dx, c.dy) == \
        (cube.origin, cube.grid, cube.valid_wh, cube.dx, cube.dy)
    return ms


def spawn_world(world, npy, t, mode, workdir, device="cuda"):
    """``world`` spawned ranks of :func:`md_pm_rank` (``mode`` its
    ``(seed, odd, scale)``) sharing the card over gloo; joined with a timeout (a
    rank still running is killed, and a rank's ``.err`` anywhere under
    ``workdir`` fails the phase). Returns each rank's multi-device (json,
    npz path) in ``workdir``."""
    import torch

    ctx = torch.multiprocessing.get_context("spawn")
    store = Path(workdir, "store")
    procs = [ctx.Process(target=md_pm_rank, daemon=True,
                         args=(r, world, str(store), npy, t, mode, workdir, device))
             for r in range(world)]
    spawned_at = time.time()
    for p in procs:
        p.start()
    deadline = time.monotonic() + _MD_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    errors = {str(e.relative_to(workdir)): e.read_text()[-3000:]
              for e in sorted(Path(workdir).glob("**/rank*.err"))}
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{world} ranks: hung {hung}, exit codes "
                             f"{[p.exitcode for p in procs]}, errors {errors}")
    ranks = rank_results(workdir, world)
    for res, _ in ranks:
        # seconds from the spawn to the rank's entry: the process start
        res["start_s"] = res["entered_at"] - spawned_at
    return ranks


def rank_results(workdir, world):
    """Each spawned rank's (json, npz path) in ``workdir``."""
    return [(json.loads(Path(workdir, f"rank{r}.json").read_text()),
             Path(workdir, f"rank{r}.npz")) for r in range(world)]


def md_phase_close(got, want):
    """|got - want| of a phase series against atol + rtol * (running sum of
    its |increments|): its error is the running sum of theirs."""
    inc = np.abs(np.diff(want, axis=-1, prepend=0.0))
    tol = _MD_ATOL + _MD_RTOL * np.cumsum(inc, axis=-1)
    err = np.abs(got - want)
    assert (err <= tol).all(), float(err.max())
    return float(err.max())


def md_compare(got, ref, label):
    """One rank's results (``got``, host numpy) against the one-rank run's
    (``ref``, whole grid): the open and the per-pixel outputs bit for bit or
    within 1e-6 * max; the series at the main path's tolerance; the Apply
    within 1e-4 * max; the live view's points apart from ties at the
    threshold. Returns the largest differences."""
    x0, y0 = (int(v) for v in got["origin"])
    diffs, equal = {}, {}
    for key in ("open_data", "open_img", "data", "img", "apply"):
        g = got[key]
        w = ref[key][x0: x0 + g.shape[0], y0: y0 + g.shape[1]]
        d = float(np.nanmax(np.abs(g - w))) if g.size else 0.0
        equal[key] = bool(np.array_equal(g, w, equal_nan=True))
        tol = (_MD_APPLY_TOL if key == "apply" else _MD_PIXEL_TOL) * float(np.nanmax(np.abs(w)))
        assert equal[key] or d <= tol, (label, key, d, tol)
        diffs[key] = d
    for key in _MD_SERIES:
        if key in _MD_PHASES:
            diffs[key] = md_phase_close(got[key], ref[key])
        else:
            np.testing.assert_allclose(got[key], ref[key], atol=_MD_ATOL, rtol=_MD_RTOL,
                                       err_msg=f"{label} {key}")
            diffs[key] = float(np.abs(got[key] - ref[key]).max())
    # the live view: the same points, except ties at the threshold; the
    # same alpha (one 1/63 step where the opacities are not bit for bit)
    step = 1.0 / 63.0
    assert float(got["view_thr"]) == float(ref["view_thr"]) or \
        abs(float(got["view_thr"]) - float(ref["view_thr"])) <= step, label
    np.testing.assert_array_equal(got["view_dims"], ref["view_dims"])
    gk = {tuple(p): a for p, a in zip(np.round(got["view_pos"], 5), got["view_rgba"][:, 3])}
    rk = {tuple(p): a for p, a in zip(np.round(ref["view_pos"], 5), ref["view_rgba"][:, 3])}
    cut = max(np.floor(float(ref["view_thr"]) * 63), 1.0) / 63
    only = [a for x, y in ((gk, rk), (rk, gk)) for k, a in x.items() if k not in y]
    assert all(abs(a - cut) <= step + 1e-6 for a in only), (label, "view", only[:5])
    common = set(gk) & set(rk)
    assert len(common) > 0.99 * len(rk), (label, len(common), len(rk))
    diffs["view_alpha"] = float(max((abs(gk[k] - rk[k]) for k in common), default=0.0))
    assert diffs["view_alpha"] <= step + 1e-6, label
    diffs["view_points_only_one_side"] = len(only)
    return diffs, equal


def phase_multi_device(t, cube, t5, cube5, name, smi, pm_seed, device="cuda"):
    """The ``multi_device`` phase: one rank over NCCL in this process
    against the single-device calls; 2 (1x2) and 4 (2x2) ranks sharing the
    card over gloo against the one-rank results; 4 ranks at 512x512x1024
    (open and 3 steps, peak memory per rank); the kernels' device time at
    the block shapes. The 2- and 4-rank processes then run their
    ``pipeline_mesh`` ranks (seed ``pm_seed``), and the 4-rank ones the
    512x512 run after that (:func:`md_pm_rank`: one process start a rank
    for all three). Returns ``(record, work)``: ``work`` the temporary
    directory that holds the scan's ``scan.npy`` and, under
    ``world<w>/pm``, the pipeline_mesh ranks' results, for
    :func:`phase_pipeline_mesh` to read and clean up."""
    import torch
    import torch.distributed as dist

    from thz_image_explorer_tpu_torch.io.dotthz import finalize_scan, open_scan_arrays
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import specred as sr
    from thz_image_explorer_tpu_torch.ops import voxel
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_arrays_sharded
    from thz_image_explorer_tpu_torch.parallel.step import StepConfig, StepParams, _spectrum

    is_cuda = torch.device(device).type == "cuda"
    tmp = tempfile.TemporaryDirectory()
    npy = str(Path(tmp.name, "scan.npy"))
    np.save(npy, cube)
    write_scan_file(str(Path(npy).with_suffix(".thz")), t, cube, scan_metadata(0.5))
    record = dict(shape=list(cube.shape), card=smi, rois=4, pixel=list(_MD_PIXEL),
                  filters=sorted(_MD_CFG), steps=_MD_STEPS,
                  apply="default DeconvolutionParams (25 bands, 500 iterations), synthetic PSF",
                  timing="host ms with a synchronize on each side; kernels: device time "
                         "behind a spin (device_ms), in this process at the block shapes")

    # 1. the single-device calls, then one rank over NCCL (gloo off the card)
    whole, whole_img = finalize_scan(open_scan_arrays(t, cube, scan_metadata(0.5)), device)
    ref_out, _, ref_apply_ms, ref_view_ms, geometry = md_path(whole, t, None, device)
    ref = md_host(ref_out, whole.data, whole_img, (0, 0))
    ref_scaled_ms, ref_scaled = md_scaled_step(whole, None, device)
    backend = "nccl" if is_cuda else "gloo"
    mesh = pm.init(device, backend=backend, init_method=f"file://{tmp.name}/store1", rank=0,
                   world_size=1)
    try:
        mm = np.load(npy, mmap_mode="r")
        block, img1, _ = open_arrays_sharded(t, mm, mesh, metadata=scan_metadata(0.5),
                                             device=device)
        thz_open1_ms = open_thz_block(npy, mesh, block, img1, device)
        zero_counts()
        out1, ms1, apply1_ms, view1_ms, _ = md_path(block, t, mesh, device)
        counts1 = read_counts()
        with CollectiveMeter(device) as m1:
            md_path(block, t, mesh, device, n_steps=1, apply=False)
        view1_again_ms = host_ms(lambda: md_view(out1["data"], block, mesh), device)[0]
        scaled1_ms, scaled1 = md_scaled_step(block, mesh, device)
    finally:
        dist.destroy_process_group()
    one = md_host(out1, block.data, img1, block.origin)
    diffs1, equal1 = md_compare(one, ref, "1 rank")
    scaled_equal1 = {k: bool(np.array_equal(v, ref_scaled[k])) for k, v in scaled1.items()}
    assert all(scaled_equal1.values()), ("1 rank scale 3 vs the single device", scaled_equal1)
    for k in ("specred", "rlsep_cluster", "envelope"):
        assert counts1[k] > 0, (k, counts1)
    assert counts1["bandsum"] == 1, counts1
    record["world1"] = dict(
        backend=backend, mesh=[1, 1], bit_for_bit=equal1, max_abs_diff=diffs1,
        thz_open_ms=thz_open1_ms,
        update_ms=ms1, update_ms_median=statistics.median(ms1[1:]),
        single_device_apply_ms=ref_apply_ms, apply_ms=apply1_ms, view_ms=view1_ms,
        view_again_ms=view1_again_ms, single_device_view_ms=ref_view_ms,
        launches=counts1, update_collective_ms=m1.ms, update_collective_bytes=m1.bytes,
        scaled_step=dict(scale=_MD_SCALE, ms=scaled1_ms, single_device_ms=ref_scaled_ms,
                         bit_for_bit_with_single_device=True))
    del out1, one, block, img1, ref_out
    if is_cuda:
        torch.cuda.empty_cache()

    # 2. 2 and 4 ranks sharing the card over gloo (the 4-rank processes
    # then run the 512x512 scan of part 3)
    npy5 = str(Path(tmp.name, "scan512.npy"))
    np.save(npy5, cube5)
    # the pipeline_mesh phase's odd-length scan (T = 1023), run by the same
    # rank processes
    t_odd, cube_odd = synthetic_scan(cube.shape[0], cube.shape[1], cube.shape[2] - 1,
                                     seed=pm_seed)
    npy_odd = str(Path(tmp.name, "scan_odd.npy"))
    np.save(npy_odd, cube_odd)
    np.save(Path(tmp.name, "time_odd.npy"), t_odd)
    del cube_odd
    dir5 = Path(tmp.name, "world4", "512")
    raw_spec = None
    for world in (2, 4):
        wdir = Path(tmp.name, f"world{world}")
        Path(wdir, "pm").mkdir(parents=True)
        Path(wdir, "pm_odd").mkdir(parents=True)
        dir5.mkdir(parents=True, exist_ok=True)
        scale = (npy5, t5, str(dir5)) if world == 4 else None
        ranks = spawn_world(world, npy, t, (pm_seed, (npy_odd, t_odd), scale), str(wdir), device)
        per_rank = []
        for res, path in ranks:
            got = dict(np.load(path))
            diffs, equal = md_compare(got, ref, f"{world} ranks, rank {res['rank']}")
            for k in ("specred", "rlsep_cluster", "envelope"):
                assert res["launches"][k] > 0, (world, res["rank"], k, res["launches"])
            assert res["launches"]["bandsum"] == 1, (world, res["rank"], res["launches"])
            s_diffs, s_equal = md_compare_scaled(got, ref_scaled,
                                                 f"{world} ranks, rank {res['rank']}, scale 3")
            assert res["scaled_step_launches"]["specred"] == 1, res["scaled_step_launches"]
            per_rank.append(dict(res, bit_for_bit=equal, max_abs_diff=diffs,
                                 scaled_step=dict(bit_for_bit=s_equal, max_abs_diff=s_diffs,
                                                  origin=got["s3_origin"].tolist())))
            del got
        # the kernels' device time at this world's block shapes (rank 0's)
        x0, x1, y0, y1 = pm.Mesh(pm.grid_shape(world)).block(0, cube.shape[:2])
        if raw_spec is None:
            c, window = _spectrum(whole, StepParams(window_low=1.0 + 0.05 * _MD_STEPS),
                                  StepConfig(**_MD_CFG))
            raw_spec = torch.fft.rfft(c.data * window, dim=-1)
            final = torch.as_tensor(ref["data"], device=device)
            masks = md_masks(*cube.shape[:2], device)
        n = (x1 - x0) * (y1 - y0)
        spec_b = raw_spec[x0:x1, y0:y1].reshape(n, -1).contiguous()
        stack = torch.cat([torch.ones((1, n), device=device),
                           masks[:, x0:x1, y0:y1].reshape(-1, n)])
        flat_b = final[x0:x1, y0:y1].reshape(n, -1).contiguous()
        taps = voxel.gaussian_kernel1d(3.0, 9)
        env_args = (2.0, _VIEW_OPACITY_THRESHOLD)
        kernels_at_block = None
        if is_cuda:
            sr_b, sr_by = specred_bound_ms(n, spec_b.shape[1], int(stack.shape[0]), name)
            env_b, env_by = envelope_bound_ms(n, flat_b.shape[1], 9, name)
            kernels_at_block = dict(
                n=n, specred_ms=device_ms(lambda: sr.spectral_reduction_sums(spec_b, stack, True)),
                specred_bound_ms=sr_b, specred_bound_by=sr_by,
                envelope_ms=device_ms(lambda: env.envelope(flat_b, taps, *env_args)),
                envelope_bound_ms=env_b, envelope_bound_by=env_by)
        record[f"world{world}"] = dict(
            backend="gloo", mesh=list(pm.grid_shape(world)),
            # each rank's open_scan_sharded of the .thz, equal to its .npy block
            thz_open_ms_largest_rank=max(r["thz_open_ms"] for r in per_rank),
            # a rank's first update makes its process's cuFFT plans
            update_ms_first_largest_rank=max(r["update_ms"][0] for r in per_rank),
            update_ms_largest_rank=max(statistics.median(r["update_ms"][1:]) for r in per_rank),
            collective_share=max(r["update_collective_ms"] / statistics.median(
                r["update_metered_ms"]) for r in per_rank),
            apply_ms_largest_rank=max(r["apply_ms"] for r in per_rank),
            apply_again_ms_largest_rank=max(r["apply_again_ms"] for r in per_rank),
            view_ms_largest_rank=max(r["view_ms"] for r in per_rank),
            view_again_ms_largest_rank=max(r["view_again_ms"] for r in per_rank),
            # the scale-3 step, a process's first at that grid (its cuFFT plans)
            scaled_step_ms_largest_rank=max(r["scaled_step_ms"] for r in per_rank),
            scaled_step_bit_for_bit=all(all(r["scaled_step"]["bit_for_bit"].values())
                                        for r in per_rank),
            kernels_at_block=kernels_at_block,
            ranks=per_rank)
        del spec_b, stack, flat_b

    # 3. 512x512x1024 at 4 ranks: the open and 3 steps, peak memory per rank
    # (run by the 4-rank processes above)
    del whole, whole_img, raw_spec, ref
    if is_cuda:
        torch.cuda.empty_cache()
    ranks5 = rank_results(dir5, 4)
    record["world4_512"] = dict(
        shape=list(cube5.shape), mesh=[2, 2],
        update_ms_first_largest_rank=max(r["update_ms"][0] for r, _ in ranks5),
        update_ms_largest_rank=max(statistics.median(r["update_ms"][1:]) for r, _ in ranks5),
        open_ms_largest_rank=max(r["open_ms"] for r, _ in ranks5),
        ranks=[r for r, _ in ranks5])
    return record, tmp


# ---------------------------------------------------- the pipeline_mesh phase
#: the incremental Pipeline on a pixel-sharded cube: its filters (the main
#: path's), the clicks, the downscale (3 divides neither the 1x2 nor the
#: 2x2 blocks of 200), the tilt, the optical selection of every publish
_PM_FILTERS = ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch")
_PM_CLICKS = 10
_PM_SCALE = 3
_PM_TILT = (2.0, 2.0)
#: the pass at a trace length of 2 mod 4 (its commands' names start with
#: ``tilt32``): the tilt to (3°, 2°) gives T = 1606, F = 804 at scale 1
#: (specred's two column chunks, the envelope's plain route); at scale 3 it
#: gives 1600, so there the pass tilts to (3°, 2.1°), T = 1610 on the 66x66
#: grid, whose 33-row blocks hold rows at other 16-byte alignments than the
#: whole grid's
_PM_TILT_2MOD4 = (3.0, 2.0)
_PM_TILT_2MOD4_SCALE3 = (3.0, 2.1)
_PM_LENGTHS_2MOD4 = {"tilt32": 1606, "tilt32_tilt_scale3": 1610}
#: the commands whose collectives are metered where they run (a
#: ``CollectiveMeter`` around each): the 2 mod 4 pass's slider steps and
#: clicks
_PM_METERED = ("tilt32_slider", "tilt32_click")
_PM_OPTICAL = dict(ref_mode="roi", ref_idx=0, samp_mode="pixel", thickness=1e-3)
_PM_SLOT_FIELDS = ("data", "fft", "amplitudes", "phases")
#: published series that are one pixel's rows, axes or the whole image: bit
#: for bit on every world; the means at the multi-device tolerance; n, alpha
#: and kappa recomputed from each rank's own series
_PM_PER_PIXEL = ("signal", "signal_fft", "phase_fft", "filtered_signal", "filtered_signal_fft",
                 "filtered_phase_fft", "image", "time", "frequencies", "filtered_time",
                 "filtered_frequencies")
_PM_PHASES = ("avg_phase_fft", "roi_ph")
_PM_OPTICAL_KEYS = ("refractive_index", "absorption_coefficient", "extinction_coefficient")


class PmClient:
    """One ``Pipeline`` (on a mesh's block or a whole cube) and its
    ``Publisher``, driven by :func:`pm_script`'s commands."""

    def __init__(self, pipeline, cube, device):
        from thz_image_explorer_tpu_torch.pipeline.publish import Publisher

        self.p, self.cube, self.device = pipeline, cube, device
        self.publisher, self.pixel, self._masks = Publisher(), _MD_PIXEL, {}
        pipeline.psf = synthetic_psf()
        for uuid in _PM_FILTERS:
            pipeline.filters[uuid].active = True

    def publish(self):
        """The publish: the main path's 4 polygon ROIs on the final grid
        (keyed on it), n/alpha/kappa of the pixel against ROI 0."""
        import torch

        from thz_image_explorer_tpu_torch.ops.roi import polygon_mask

        final = self.p.output
        key = (final.grid_wh, final.scaling)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(np.stack([
                polygon_mask(poly, final.grid_wh, final.scaling)
                for poly in roi_polygons(*self.cube.grid_wh)]).astype(np.float32),
                device=self.device)
        return self.publisher.publish(self.p, self._masks[key], key, self.pixel, _PM_OPTICAL)

    def dense(self):
        """The dense extraction (the VTU export's; no file written)."""
        from thz_image_explorer_tpu_torch.ops import voxel

        final = self.p.output
        t = self.p._host_time[len(self.p.slots) - 1]
        kw = dict(time_span=float(t[-1] - t[0]), scaling=final.scaling,
                  original_dims=(*self.cube.grid_wh, self.cube.n_time),
                  valid_grid=self.p.valid_for(final), opacity_threshold=_VIEW_OPACITY_THRESHOLD,
                  contrast=2.0, kernel_sigma=3.0, kernel_radius=9)
        if self.p.mesh is not None:
            kw.update(mesh=self.p.mesh, origin=final.origin, grid=final.grid_wh)
        return voxel.extract_instances(final.data, **kw)


def pm_window(v):
    """A slider step: the FFT window's low edge to ``v``, the chain from
    the FFT stage."""
    def run(s):
        s.p.config.fft_window[0] = v
        s.p.run_from(s.p.fft_index)
    return run


def pm_click(xy):
    def run(s):
        s.pixel = xy
    return run


def pm_script(seed, short=False):
    """The commands of the phase, as ``(name, kind, command)``; each command
    but a dense extraction (kind "dense", command None) is followed by a
    publish. Open; 5 slider steps (window low 1.05-1.25); 10 clicks; a
    downscale to 3 and back to 1; tilt to (2°, 2°); the pass at a trace
    length of 2 mod 4 (:func:`pm_script_2mod4`); tilt off; the Apply
    (default parameters, the synthetic PSF) and a repeat Apply; a slider
    step after them; a dense extraction. ``short`` (the odd-length pass):
    open, 3 slider steps, 5 clicks, the downscale to 3 and back, a dense
    extraction."""
    rng = np.random.default_rng(seed)

    def scale(f):
        def run(s):
            s.p.config.scale_factor = f
            s.p.run_from(s.p.scaling_index)
        return run

    def tilt(on, angles=_PM_TILT):
        def run(s):
            stage = s.p.filters[TILT]
            stage.active, (stage.tilt_x, stage.tilt_y) = on, angles
            s.p.update_filter(TILT)
        return run

    def apply(s):
        s.p.filters[DEC].active = True
        s.p.update_filter(DEC, force=True)

    n_slider, n_clicks = (3, 5) if short else (_MD_STEPS, _PM_CLICKS)
    steps = [("open", "open", lambda s: s.p.set_input(s.cube))]
    steps += [(f"slider{i + 1}", "slider", pm_window(1.0 + 0.05 * (i + 1)))
              for i in range(n_slider)]
    steps += [(f"click{i + 1}", "click", pm_click((int(x), int(y))))
              for i, (x, y) in enumerate(rng.integers(0, 200, size=(n_clicks, 2)))]
    steps += [("downscale3", "downscale", scale(_PM_SCALE)), ("downscale1", "downscale", scale(1))]
    if not short:
        steps += [("tilt", "tilt", tilt(True))]
        steps += pm_script_2mod4(rng, tilt, scale)
        steps += [("tilt_off", "tilt", tilt(False)),
                  ("apply", "apply", apply), ("apply_again", "apply", apply),
                  ("slider_after_apply", "slider_after_apply", pm_window(1.30))]
    return steps + [("dense", "dense", None)]


def pm_script_2mod4(rng, tilt, scale):
    """The pass at a trace length of 2 mod 4, after the (2°, 2°) tilt: tilt
    to (3°, 2°) (T = 1606); 3 slider steps (window low 1.10-1.20); 5
    clicks; a dense extraction; a downscale to 3 and there a tilt to (3°,
    2.1°) (T = 1610 on the downscaled blocks); back to scale 1 (T = 1616).
    The names start with ``tilt32``."""
    steps = [("tilt32", "tilt", tilt(True, _PM_TILT_2MOD4))]
    steps += [(f"tilt32_slider{i + 1}", "slider", pm_window(1.10 + 0.05 * i)) for i in range(3)]
    steps += [(f"tilt32_click{i + 1}", "click", pm_click((int(x), int(y))))
              for i, (x, y) in enumerate(rng.integers(0, 200, size=(5, 2)))]
    return steps + [("tilt32_dense", "dense", None),
                    ("tilt32_downscale3", "downscale", scale(_PM_SCALE)),
                    ("tilt32_tilt_scale3", "tilt", tilt(True, _PM_TILT_2MOD4_SCALE3)),
                    ("tilt32_downscale1", "downscale", scale(1))]


def pm_run(client, step):
    """One command and its publish."""
    step[2](client)
    return client.publish()


def bits_checksum(t):
    """Two integer sums of a tensor's 32-bit words, the second weighted by
    position (as a (2,) int64 tensor): tensors with the same bits give the
    same sums. The smoke compares ranks' slots with one process's this
    way, without moving them."""
    import torch

    w = (torch.view_as_real(t) if t.is_complex() else t).contiguous().view(torch.int32).reshape(-1)
    pos = torch.arange(w.numel(), device=w.device, dtype=torch.int32) % 65521 + 1
    return torch.stack([w.sum(dtype=torch.int64), (w * pos).sum(dtype=torch.int64)])


def slot_checksums(pipeline, blocks=None):
    """``{"<slot>/<field>": [sum, weighted sum]}`` of every slot field (an
    expanded zero spectrum, which nothing reads, is skipped); with
    ``blocks`` (a function of the slot's grid giving ``(x0, x1, y0, y1)``),
    of that block of each field."""
    import torch

    keys, sums, seen = [], [], {}
    for i, c in enumerate(pipeline.slots):
        for f in _PM_SLOT_FIELDS:
            t = getattr(c, f)
            if 0 in t.stride():
                continue
            if blocks is not None:
                x0, x1, y0, y1 = blocks(c.grid_wh)
                t = t[x0:x1, y0:y1]
            key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()))
            if key not in seen:
                seen[key] = len(sums)
                sums.append(bits_checksum(t))
            keys.append((f"{i}/{f}", seen[key]))
    if not sums:
        return {}
    host = torch.stack(sums).cpu().tolist()
    return {k: host[j] for k, j in keys}


def same_bits(a, b):
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def dense_digest(result):
    """``(points, threshold, sha256 of the positions' and colours' bytes)``
    of a dense extraction: equal digests, the same points in the same
    order."""
    import hashlib

    pos, rgba, *_, thr = result
    h = hashlib.sha256(np.ascontiguousarray(pos).tobytes())
    h.update(np.ascontiguousarray(rgba).tobytes())
    return len(pos), float(thr), h.hexdigest()


def pm_measure(client, device, label):
    """After the script: the collectives of 3 slider steps and 3 clicks
    (``CollectiveMeter``: ``all_reduce`` with a synchronize on each side),
    and this rank's specred and envelope calls against their plain versions
    on its block."""
    out = {}
    steps = [("s", "slider", pm_window(1.30 + 0.05 * k)) for k in range(1, 4)]
    clicks = [("c", "click", pm_click((40 + k, 150 - k))) for k in range(3)]
    for kind, script in (("slider", steps), ("click", clicks)):
        with CollectiveMeter(device) as m:
            ms = [host_ms(lambda: pm_run(client, step), device)[0] for step in script]
        out[kind] = dict(ms=ms, collective_ms=m.ms / 3, collective_bytes=m.bytes // 3,
                         collective_calls=m.calls // 3,
                         collective_share=m.ms / 3 / statistics.median(ms))
    out.update(pm_kernel_checks(client, device, label))
    return out


def pm_kernel_inputs(client, device):
    """The inputs specred and the envelope take on this rank's block in the
    publish and the dense extraction: the FFT slot's spectrum (N, F), the
    valid mask and the 4 ROI masks (5, N), the final traces (N, T)."""
    import torch

    from thz_image_explorer_tpu_torch.parallel.mesh import block_slice

    p = client.p
    spec = p.slots[p.fft_index].fft
    n = spec.shape[0] * spec.shape[1]
    final = p.output
    whole_masks = client._masks[(final.grid_wh, final.scaling)]
    stack = torch.cat([torch.ones((1, n), device=device),
                       block_slice(whole_masks, final).reshape(-1, n)])
    return spec.reshape(n, -1).contiguous(), stack, final.data.reshape(n, -1).contiguous()


def pm_kernel_checks(client, device, label):
    """This rank's specred and envelope calls against their plain versions
    on its block (on the card; nothing on the CPU)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import voxel

    if torch.device(device).type != "cuda":
        return {}
    spec, stack, flat = pm_kernel_inputs(client, device)
    return dict(
        shape=[*spec.shape, flat.shape[1]],
        specred_max_abs_err=check_specred(spec, stack, False, f"{label} block")[0],
        envelope_max_abs_err=check_envelope(flat, voxel.gaussian_kernel1d(3.0, 9), 2.0,
                                            _VIEW_OPACITY_THRESHOLD, f"{label} block")[0])


def pm_kernels_at_blocks(client, device, name):
    """Device time (behind a spin) of specred and the envelope on the whole
    grid of a one-rank run and on rank 0's block of 2 and 4 ranks, with
    their bounds: the inputs of :func:`pm_kernel_inputs`."""
    import torch

    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import specred as sr
    from thz_image_explorer_tpu_torch.ops import voxel
    from thz_image_explorer_tpu_torch.parallel import mesh as pm

    spec, stack, flat = pm_kernel_inputs(client, device)
    grid = client.p.output.grid_wh
    taps = voxel.gaussian_kernel1d(3.0, 9)
    out = {}
    for world in (1, 2, 4):
        x0, x1, y0, y1 = pm.Mesh(pm.grid_shape(world)).block(0, grid)
        rows = torch.as_tensor((np.arange(x0, x1)[:, None] * grid[1] + np.arange(y0, y1))
                               .reshape(-1), device=device)
        spec_b, stack_b, flat_b = (spec.index_select(0, rows).contiguous(),
                                   stack.index_select(1, rows).contiguous(),
                                   flat.index_select(0, rows).contiguous())
        n, f, t = spec_b.shape[0], spec_b.shape[1], flat_b.shape[1]
        sr_b, sr_by = specred_bound_ms(n, f, int(stack_b.shape[0]), name)
        env_b, env_by = envelope_bound_ms(n, t, 9, name)
        out[f"world{world}"] = dict(
            n=n, f=f, t=t,
            specred_ms=device_ms(lambda: sr.spectral_reduction_sums(spec_b, stack_b, False)),
            specred_bound_ms=sr_b, specred_bound_by=sr_by,
            specred_plan=check_specred_plan(n, f, int(stack_b.shape[0])),
            envelope_ms=device_ms(lambda: env.envelope(flat_b, taps, 2.0,
                                                       _VIEW_OPACITY_THRESHOLD)),
            envelope_bound_ms=env_b, envelope_bound_by=env_by,
            envelope_route=check_envelope_plan(n, t, 9)["route"])
    return out


def pm_check_launches(record, label):
    """Each rank's launches per command: 1 specred launch per chain run and
    none per click; 1-9 cluster RL launches and 1 band-sum launch per Apply,
    none elsewhere; no half-iteration RL launch; 1 envelope launch per dense
    extraction; at most 1 tilt launch per tilt or downscale command (the
    tilt stage re-run while active), none elsewhere; at most 1 polar launch
    per chain run (one from the FFT stage or before), none per click,
    dense extraction or Apply."""
    for name, kind, _ms, counts in record:
        want_sr = 0 if kind == "click" or kind == "dense" else 1
        assert counts["specred"] == want_sr, (label, name, counts)
        if kind == "apply":
            assert 1 <= counts["rlsep_cluster"] <= 9, (label, name, counts)
        else:
            assert counts["rlsep_cluster"] == 0, (label, name, counts)
        assert counts["bandsum"] == (1 if kind == "apply" else 0), (label, name, counts)
        assert counts["envelope"] == (1 if kind == "dense" else 0), (label, name, counts)
        assert counts["tilt"] <= (1 if kind in ("tilt", "downscale") else 0), (label, name,
                                                                               counts)
        assert counts["polar"] <= (0 if kind == "apply" else want_sr), (label, name, counts)
        assert counts["rlsep"] == counts["rlsep_grouped"] == counts["rl2d"] == 0, (label, name)


def pm_drive(client, device, seed, on_step=lambda step, out: None, short=False):
    """:func:`pm_script` on ``client``, each command timed on the host (a
    synchronize on each side) with every launch count set to 0 just before
    it and read just after; the commands of :data:`_PM_METERED` under a
    ``CollectiveMeter``. ``on_step(step, out)`` gets each command's
    publish, or a dense extraction's result. Returns ``(per command (name,
    kind, ms, launches), {dense command: its result}, {metered command:
    (collective calls, bytes, ms)})``."""
    record, dense, collectives = [], {}, {}
    for step in pm_script(seed, short):
        meter = CollectiveMeter(device) if step[0].startswith(_PM_METERED) else None
        run = client.dense if step[1] == "dense" else (lambda: pm_run(client, step))
        zero_counts()
        with meter or contextlib.nullcontext():
            ms, out = host_ms(run, device)
        record.append((step[0], step[1], ms, read_counts()))
        if meter is not None:
            collectives[step[0]] = (meter.calls, meter.bytes, meter.ms)
        if step[1] == "dense":
            dense[step[0]] = out
        on_step(step, out)
    return record, dense, collectives


def pm_launches(record, prefix=""):
    """Launches by kernel over the commands whose names start with
    ``prefix``."""
    return {k: sum(c[k] for name, _, _, c in record if name.startswith(prefix))
            for k in record[0][3]}


def largest(values):
    """The largest of the ranks' values: elementwise for lists."""
    if isinstance(values[0], list):
        return [max(v) for v in zip(*values)]
    return max(values)


def pm_summary(record, collectives):
    """Host ms by kind, the 2 mod 4 pass's kinds apart (prefixed
    ``tilt32_``): the median of the slider steps and of the clicks after
    the first, every other command's own; and the metered commands'
    collectives' share (the median of their ms after the first over the
    median of the commands' ms)."""
    by, shared = {}, {}
    for name, kind, ms, _ in record:
        key = f"tilt32_{kind}" if name.startswith("tilt32") else kind
        by.setdefault(key, []).append(ms)
        if name in collectives:
            shared.setdefault(key, []).append(collectives[name][2])
    out = {k: v if len(v) <= 2 else statistics.median(v[1:]) for k, v in by.items()}
    out["open"] = by["open"][0]
    for key, ms in shared.items():
        out[f"{key}_collective_share"] = statistics.median(ms[1:]) / out[key]
    return out


def pipeline_mesh_rank(rank, world, store, npy, t, seed, outdir, device="cuda", short=False):
    """One spawned rank of the ``pipeline_mesh`` phase (gloo, all ranks on
    one card): its block of the memory-mapped scan into ``Pipeline(mesh=)``,
    the script (:func:`pm_script`, ``short`` for the odd-length pass) and
    the dense extraction, then the collectives and the kernel checks on its
    block. Writes ``rank<r>.json`` (timings, launches, slot checksums per
    command, the dense digest) and ``rank<r>.npz`` (the published series
    per command and its block of the Apply)."""
    try:
        _pipeline_mesh_rank(rank, world, store, npy, t, seed, outdir, device, short)
    except BaseException:
        import traceback

        Path(outdir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def md_pm_rank(rank, world, store, npy, t, mode, outdir, device="cuda"):
    """One spawned rank: :func:`multi_device_rank`'s work on the 200x200
    scan into ``outdir``, then in the same process and a new group
    :func:`pipeline_mesh_rank`'s into ``<outdir>/pm``, then its odd-length
    pass into ``<outdir>/pm_odd``; ``mode`` is ``(seed, odd, scale)``: the
    pipeline_mesh seed, ``(npy, t)`` of the odd-length scan, and None or
    ``(npy, t, outdir)`` of the 512x512 scan, whose open and 3 steps (the
    "scale" mode) follow in a last group. The process starts, imports and
    makes its CUDA context once for all of them."""
    seed, (npy_odd, t_odd), scale = mode
    multi_device_rank(rank, world, store, npy, t, "full", outdir, device)
    pipeline_mesh_rank(rank, world, store + "_pm", npy, t, seed, str(Path(outdir, "pm")),
                       device)
    pipeline_mesh_rank(rank, world, store + "_pm_odd", npy_odd, t_odd, seed,
                       str(Path(outdir, "pm_odd")), device, short=True)
    if scale is not None:
        npy5, t5, outdir5 = scale
        multi_device_rank(rank, world, store + "_512", npy5, t5, "scale", outdir5, device)


def _pipeline_mesh_rank(rank, world, store, npy, t, seed, outdir, device, short):
    import torch
    import torch.distributed as dist

    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_arrays_sharded
    from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline

    # host seconds from the group's start to the end of each part
    t0 = time.perf_counter()
    mesh = pm.init(device, backend="gloo", init_method=f"file://{store}", rank=rank,
                   world_size=world, timeout_s=_MD_TIMEOUT_S)
    res = dict(rank=rank, world=world, mesh=list(mesh.shape), checksums={},
               wall_s=dict(init=time.perf_counter() - t0))
    series = {}

    def mark(part):
        res["wall_s"][part] = time.perf_counter() - t0

    try:
        is_cuda = torch.device(device).type == "cuda"
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        block, _, _ = open_arrays_sharded(t, np.load(npy, mmap_mode="r"), mesh,
                                          metadata=scan_metadata(0.5), device=device)
        client = PmClient(Pipeline(device, mesh=mesh), block, device)
        mark("open")

        def keep(step, out):
            res["checksums"][step[0]] = slot_checksums(client.p)
            if step[0] == "tilt32_dense":
                # the kernels on this rank's block at T = 1606, F = 804
                res["kernels_2mod4"] = pm_kernel_checks(client, device,
                                                        f"{world} ranks, rank {rank}, T 1606")
            if step[1] == "dense":
                return
            series.update({f"{step[0]}/{k}": v for k, v in out.items()})
            if step[0] == "apply_again":
                series["apply/data"] = client.p.output.data.cpu().numpy()
                series["apply/origin"] = np.asarray(client.p.output.origin)

        record, dense, collectives = pm_drive(client, device, seed, keep, short)
        mark("script")
        res.update(record=record, summary=pm_summary(record, collectives),
                   dense={k: dense_digest(v) for k, v in dense.items()}, collectives=collectives,
                   measure=pm_measure(client, device, f"{world} ranks, rank {rank}"),
                   peak_bytes=torch.cuda.max_memory_allocated() if is_cuda else None)
        mark("measure")
        np.savez(Path(outdir, f"rank{rank}.npz"), **series)
        mark("saved")
    finally:
        Path(outdir, f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def pm_compare_series(got, ref, label, device, kinds, apply_scale):
    """One rank's published series (``got``, by ``"<command>/<key>"``)
    against the one-rank run's: per-pixel series and the image bit for bit
    (after an Apply, the deconvolved trace and image within the Apply's
    1e-4 * max), the means at the multi-device tolerance (phases: rtol × the
    running sum of their increments); n/alpha/kappa equal to the formula of
    the rank's own pixel and ROI 0 series. Returns the largest difference
    of a mean."""
    import torch

    from thz_image_explorer_tpu_torch.ops.optical import calculate_optical_properties

    worst = 0.0
    for key, want in ref.items():
        name, series = key.split("/", 1)
        g = got[key]
        if kinds[name] == "apply" and series in ("filtered_signal", "image"):
            # the image squares the traces: twice their relative tolerance
            err = float(np.nanmax(np.abs(g - want)))
            bound = (_MD_APPLY_TOL * apply_scale if series != "image"
                     else 2 * _MD_APPLY_TOL * float(np.nanmax(np.abs(want))))
            assert err <= bound, (label, key, err, bound)
        elif series in _PM_PER_PIXEL:
            assert np.array_equal(g, want, equal_nan=True), (label, key)
        elif series in _PM_PHASES:
            worst = max(worst, md_phase_close(g, want))
        elif series in _PM_OPTICAL_KEYS:
            continue
        else:
            np.testing.assert_allclose(g, want, atol=_MD_ATOL, rtol=_MD_RTOL, err_msg=f"{label} {key}")
            worst = max(worst, float(np.abs(g - want).max()) if g.size else 0.0)
    for name in {k.split("/", 1)[0] for k in ref}:
        def get(k):
            return torch.as_tensor(got[f"{name}/{k}"], device=device)
        optical = calculate_optical_properties(
            get("filtered_signal_fft"), get("filtered_phase_fft"), get("roi_amp")[0],
            get("roi_ph")[0], get("filtered_frequencies"), _PM_OPTICAL["thickness"])
        for key, want in zip(_PM_OPTICAL_KEYS, optical):
            assert np.array_equal(got[f"{name}/{key}"], want.cpu().numpy(), equal_nan=True), \
                (label, name, key)
    return worst


def phase_pipeline_mesh(t, cube, name, smi, seed, work, device="cuda"):
    """The ``pipeline_mesh`` phase: the incremental ``Pipeline`` and its
    ``Publisher`` on one rank's block of the 200x200x1024 scan, its script
    with a pass at trace lengths of 2 mod 4 (:func:`pm_script_2mod4`: T =
    1606, and 1610 on the downscaled blocks), then the odd-length pass on a
    200x200x1023 scan (:func:`pm_script`'s short script). For each: one
    rank over NCCL in this process, in lockstep with the single-device
    ``Pipeline`` (every slot, series, the Apply and the dense extractions
    bit for bit after every command); 2 (1x2) and 4 (2x2)
    spawned ranks over gloo on the one card against the one-rank run (slots
    by checksum over each rank's block, bit for bit; series at the
    multi-device tolerance; the Apply within 1e-4 * max; the dense
    extractions' digests equal). Each rank's launches per command, host ms,
    collectives and peak memory; at T = 1606 each rank's specred and
    envelope calls against their plain versions on its block, and both
    kernels' device time on the whole grid and the blocks. The spawned ranks ran in the multi_device
    phase's processes (:func:`md_pm_rank`); ``work`` is that phase's
    temporary directory, which holds both scans and the ranks' results, and
    which this one reads and removes. Returns the phase's record."""
    tmp = work
    record = dict(shape=list(cube.shape), card=smi, filters=list(_PM_FILTERS), rois=4,
                  pixel=list(_MD_PIXEL), clicks=_PM_CLICKS, scale=_PM_SCALE, tilt=list(_PM_TILT),
                  apply="default DeconvolutionParams (25 bands, 500 iterations), synthetic PSF",
                  dense_opacity_threshold=_VIEW_OPACITY_THRESHOLD,
                  timing="host ms of each command and its publish, a synchronize on each "
                         "side; by kind the largest rank's median of slider steps 2-5 and "
                         "clicks 2-10")
    record.update(pm_pass(t, cube, str(Path(tmp.name, "scan.npy")), tmp, "pm", seed, False, name,
                          device))
    lengths = record["world1"]["trace_lengths"]
    assert {k: lengths[k] for k in _PM_LENGTHS_2MOD4} == _PM_LENGTHS_2MOD4, lengths
    record["tilt_2mod4"] = dict(
        tilts=dict(scale1=list(_PM_TILT_2MOD4), scale3=list(_PM_TILT_2MOD4_SCALE3)),
        commands="tilt to (3°, 2°) (T = 1606), 3 slider steps, 5 clicks (their collectives "
                 "metered), a dense extraction, downscale to 3 (T = 1600), tilt to (3°, 2.1°) "
                 "(T = 1610), downscale to 1 (T = 1616)")
    t_odd = np.load(Path(tmp.name, "time_odd.npy"))
    npy_odd = str(Path(tmp.name, "scan_odd.npy"))
    cube_odd = np.load(npy_odd, mmap_mode="r")
    record["odd"] = dict(
        shape=list(cube_odd.shape),
        commands="open, 3 slider steps, 5 clicks, downscale to 3 and back, a dense extraction",
        **pm_pass(t_odd, cube_odd, npy_odd, tmp, "pm_odd", seed, True, name, device))
    del cube_odd
    tmp.cleanup()
    return record


def pm_pass(t, cube, npy, tmp, sub, seed, short, name, device):
    """One pass of the phase on the scan saved at ``npy``: the one-rank run
    in lockstep with the single device, then the 2- and 4-rank results under
    ``<tmp>/world<w>/<sub>`` against it. Returns ``{"world1": ...,
    "world2": ..., "world4": ...}``."""
    import torch
    import torch.distributed as dist

    from thz_image_explorer_tpu_torch.io.dotthz import finalize_scan, open_scan_arrays
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.parallel import mesh as pm
    from thz_image_explorer_tpu_torch.parallel import open_arrays_sharded
    from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline

    is_cuda = torch.device(device).type == "cuda"
    record = {}
    worlds = {w: [pm.Mesh(pm.grid_shape(w), r) for r in range(w)] for w in (2, 4)}
    script = pm_script(seed, short)
    kinds = {n: k for n, k, _ in script}
    has_apply = "apply" in kinds.values()

    # 1. one rank over NCCL (gloo off the card), in lockstep with the
    # single-device Pipeline
    t_one = time.perf_counter()
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    whole, _ = finalize_scan(open_scan_arrays(t, np.asarray(cube), scan_metadata(0.5)), device)
    backend = "nccl" if is_cuda else "gloo"
    mesh = pm.init(device, backend=backend, init_method=f"file://{tmp.name}/store_{sub}1",
                   rank=0, world_size=1)
    mismatches, ref_ms, series, checksums = [], {}, {}, {}
    try:
        block, _, _ = open_arrays_sharded(t, np.load(npy, mmap_mode="r"), mesh,
                                          metadata=scan_metadata(0.5), device=device)
        ref = PmClient(Pipeline(device), whole, device)
        one = PmClient(Pipeline(device, mesh=mesh), block, device)
        by_name = {s[0]: s for s in script}
        rl_case, lengths, at_2mod4 = {}, {}, {}

        def lockstep(step, out):
            """The single device runs the same command after the mesh's,
            outside its timing and counts; then every slot and series (or
            the dense extraction's points)."""
            if step[1] == "dense":
                ms, want = host_ms(ref.dense, device)
                mismatches.extend(f"{step[0]} {i}" for i, (a, b) in enumerate(zip(want, out))
                                  if not np.array_equal(np.asarray(a), np.asarray(b)))
            else:
                ms, want = host_ms(lambda: pm_run(ref, by_name[step[0]]), device)
                mismatches.extend(f"{step[0]} {k}" for k in want
                                  if not np.array_equal(want[k], out[k], equal_nan=True))
                series.update({f"{step[0]}/{k}": v for k, v in out.items()})
            ref_ms[step[0]] = ms
            lengths[step[0]] = one.p.output.n_time
            for i, (a, b) in enumerate(zip(ref.p.slots, one.p.slots)):
                mismatches.extend(f"{step[0]} slot {i} {f}" for f in _PM_SLOT_FIELDS
                                  if not same_bits(getattr(a, f), getattr(b, f)))
            checksums[step[0]] = {w: [slot_checksums(one.p, lambda g, m=m: m.block(None, g))
                                      for m in meshes] for w, meshes in worlds.items()}
            if step[0] == "tilt32_dense":
                # the kernels at T = 1606, F = 804: on the whole grid against
                # their plain versions, and timed there and at the blocks
                at_2mod4.update(pm_kernel_checks(one, device, f"{sub} 1 rank, T 1606"))
                if is_cuda:
                    at_2mod4["at_blocks"] = pm_kernels_at_blocks(one, device, name)
            if step[0] == "apply":
                rl_case["inputs"] = dec.rl_inputs(one.p.slots[-2].data,
                                                  one.p.filters[DEC]._plan_cache[1])
            if step[0] == "apply_again":
                rl_case["apply"] = one.p.output.data

        record1, dense1, coll1 = pm_drive(one, device, seed, lockstep, short)
        measure1 = pm_measure(one, device, f"{sub} 1 rank")
    finally:
        dist.destroy_process_group()
    assert not mismatches, (f"{sub}: 1 rank vs the single device", mismatches[:20])
    pm_check_launches(record1, f"{sub} 1 rank")
    digest1 = {k: dense_digest(v) for k, v in dense1.items()}
    record["world1"] = dict(
        backend=backend, mesh=[1, 1], bit_for_bit_with_single_device=True,
        wall_s=time.perf_counter() - t_one,
        ms=pm_summary(record1, coll1), single_device_ms=ref_ms,
        launches=pm_launches(record1), launches_2mod4=pm_launches(record1, "tilt32"),
        per_command=[(n, round(ms, 3), c) for n, _, ms, c in record1],
        trace_lengths=lengths,
        dense={k: dict(points=v[0], threshold=v[1]) for k, v in digest1.items()},
        measure=measure1,
        peak_bytes_both_pipelines=torch.cuda.max_memory_allocated() if is_cuda else None)
    if at_2mod4:
        record["world1"]["kernels_2mod4"] = at_2mod4
    if has_apply:
        apply1 = rl_case["apply"].cpu().numpy()
        padded, px, py, n_iter = rl_case["inputs"]
        apply_scale = float(np.nanmax(np.abs(apply1)))
    else:
        apply_scale = None
    del ref, one, whole, block, rl_case, dense1
    if is_cuda:
        torch.cuda.empty_cache()

    # 2. 2 and 4 ranks sharing the card over gloo, against the one-rank run
    applied = f"{len(Pipeline(device).chain) - 1}/data"
    for world, meshes in worlds.items():
        t_cmp = time.perf_counter()
        ranks = rank_results(Path(tmp.name, f"world{world}", sub), world)
        per_rank = []
        for res, path in ranks:
            r, label = res["rank"], f"pipeline_mesh {sub} {world} ranks, rank {res['rank']}"
            pm_check_launches(res["record"], label)
            # the Apply's own output is held to a tolerance below (the
            # ranks' band subsets sum in another order)
            bad = [f"{step}/{k}" for step, sums in res["checksums"].items()
                   for k, v in sums.items() if checksums[step][world][r].get(k) != v
                   and not (kinds[step] == "apply" and k == applied)]
            assert not bad, (label, "slots differ from the one-rank run's block", bad[:20])
            got = dict(np.load(path))
            worst = pm_compare_series(got, series, label, device, kinds, apply_scale)
            assert {k: tuple(v) for k, v in res["dense"].items()} == digest1, \
                (label, res["dense"], digest1)
            rank_record = dict(
                rank=r, block=list(meshes[r].block(None, cube.shape[:2])), ms=res["summary"],
                launches=pm_launches(res["record"]),
                launches_2mod4=pm_launches(res["record"], "tilt32"),
                series_max_abs_diff=worst, measure=res["measure"],
                peak_bytes=res["peak_bytes"], wall_s=res["wall_s"])
            if "kernels_2mod4" in res:
                rank_record["kernels_2mod4"] = res["kernels_2mod4"]
            if has_apply:
                blk = got.pop("apply/data")
                x0, y0 = (int(v) for v in got.pop("apply/origin"))
                apply_err = float(np.nanmax(np.abs(blk - apply1[x0: x0 + blk.shape[0],
                                                                y0: y0 + blk.shape[1]])))
                assert apply_err <= _MD_APPLY_TOL * apply_scale, (label, apply_err, apply_scale)
                # the RL kernel on this rank's bands (the gathered canvases
                # are the same on every rank), in this process
                bands = torch.as_tensor(dec.band_split(n_iter, world)[r], device=device)
                sub_in = [v.index_select(0, bands).contiguous() for v in (padded, px, py)]
                rl_err = check_rl(*sub_in, n_iter[bands.cpu().numpy()], label, "cluster")[0] \
                    if is_cuda else None
                rank_record.update(
                    apply_launches=[c["rlsep_cluster"] for _, kind, _, c in res["record"]
                                    if kind == "apply"],
                    apply_max_abs_diff=apply_err, rlsep_cluster_bands_max_abs_err=rl_err)
                del blk
            per_rank.append(rank_record)
            del got
        ms_kinds = per_rank[0]["ms"].keys()
        record[f"world{world}"] = dict(
            backend="gloo", mesh=list(pm.grid_shape(world)),
            slots_bit_for_bit=True, dense_same_points=True,
            ms_largest_rank={k: largest([p["ms"][k] for p in per_rank]) for k in ms_kinds},
            compare_s=time.perf_counter() - t_cmp,
            collective_share_largest_rank={
                k: max(p["measure"][k]["collective_share"] for p in per_rank)
                for k in ("slider", "click")},
            peak_bytes_largest_rank=max(p["peak_bytes"] or 0 for p in per_rank),
            ranks=per_rank)
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("tilt_kernel", "polar_kernel", "rl_wide"),
                    help="after the device and build phases, run this phase alone")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import bandsum as bs
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import polar
    from thz_image_explorer_tpu_torch.ops import rl2d
    from thz_image_explorer_tpu_torch.ops import rlsep
    from thz_image_explorer_tpu_torch.ops import voxel
    from thz_image_explorer_tpu_torch.ops import specred as sr
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    # full-f32 products in the deconvolution's plain matmuls and the plain
    # versions (the package turns TF32 off at import; cuDNN is not used)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    # 2. build every kernel source, all nvcc processes at once
    t0 = time.perf_counter()
    logs = kernels.build(kernels.SOURCES)
    build_s = time.perf_counter() - t0
    regs = [int(x.split("Used ")[1].split(" registers")[0])
            for log in logs.values() for x in log.splitlines() if "Used " in x]
    spills = [x.strip() for log in logs.values() for x in log.splitlines()
              if "spill" in x and not x.strip().startswith("0 bytes")
              and " 0 bytes spill stores, 0 bytes spill loads" not in x]
    emit(phase="build", seconds=round(build_s, 3), sources=list(kernels.SOURCES),
         max_registers=max(regs) if regs else None, spill_lines=spills[:4])

    # the reference scan of the main path (also the kernel's pulse input)
    width, height, n_time = 200, 200, 1024
    t, cube = synthetic_scan(width, height, n_time, seed=args.seed)
    if args.only:
        if args.only == "tilt_kernel":
            phase_tilt_kernel(t, cube, name, smi)
        elif args.only == "rl_wide":
            phase_rl_wide(t, cube, dev, smi, args.seed)
        else:
            phase_polar_kernel(name, smi)
        print(json.dumps({"ok": True, "only": args.only, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
        return 0
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # 3. kernel vs plain at the main path's shapes and ragged ones
    from thz_image_explorer_tpu_torch.ops.fourier import forward_fft
    from thz_image_explorer_tpu_torch.ops.windows import WindowType
    from thz_image_explorer_tpu_torch.data import load_preprocess, make_cube

    data, _ = load_preprocess(torch.as_tensor(cube, device=dev))
    fcube = forward_fft(make_cube(t, data, device=dev), WindowType.ADAPTED_BLACKMAN, 1.0, 7.0)
    n, f = width * height, n_time // 2 + 1
    pulse_spec = fcube.fft.reshape(n, f).contiguous()
    del data, fcube
    roi_masks = torch.zeros((4, width, height), device=dev)
    roi_masks[0, 20:66, 20:66] = 1
    roi_masks[1, 100:133, 100:133] = 1
    roi_masks[2, 30:70, 130:170] = 1
    roi_masks[3, 120:160, 25:66] = 1
    masks5 = torch.cat([torch.ones((1, n), device=dev), roi_masks.reshape(4, n)])
    max_abs_err, max_rel_err = phase_kernel_checks(pulse_spec, masks5, gen)

    # 4. the main path at 200x200x1024 through the Explorer: the scan
    # opened from arrays, saved with save_file and opened with open_file
    # (the port's own HDF5 writer and reader), the cube bit for bit
    ex = Explorer(device="cuda")
    tmp = tempfile.TemporaryDirectory()

    def open_scan():
        ex.open_arrays(t, cube, scan_metadata(0.5))
        from_arrays = ex.pipeline.input.data.clone()
        path = f"{tmp.name}/scan.thzimg"
        ex.save_file(path)
        ex.open_file(path)
        assert torch.equal(ex.pipeline.input.data, from_arrays), "open_file differs from the arrays"
        assert ex.file_path == path

    hdf5 = "save_file + open_file (io/hdf5.py), the opened cube bit for bit the arrays'"
    sr.spectral_reduction_sums.launches = 0
    polar.amplitude_phase.launches = 0
    slider_ms, click_ms, slider_launch, click_launch = drive_commands(
        ex, open_scan, cube, 10, 20, np.random.default_rng(args.seed)
    )
    tmp.cleanup()
    main_launches = sr.spectral_reduction_sums.launches
    main_polar_launches = polar.amplitude_phase.launches
    check_published(ex, width, height, n_time)
    assert all(k == 1 for k in slider_launch), slider_launch
    assert all(k == 0 for k in click_launch), click_launch
    assert main_launches > 0 and main_polar_launches >= len(slider_ms)
    # the FFT stage's kernel: one launch a slider step from the FFT window
    # (a step forth and the step back to the drive's last value), none a click
    def polar_count():
        return polar.amplitude_phase.launches

    polar_step = [command_ms(lambda v=v: ex.set_fft_window_low(v), polar_count)[1]
                  for v in (1.55, 1.0 + 0.05 * 10)]
    polar_click = command_ms(lambda: ex.set_selected_pixel(*ex.pixel_selected), polar_count)[1]
    assert (polar_step, polar_click) == ([1, 1], 0), (polar_step, polar_click)
    emit(phase="main_path", shape=[width, height, n_time], card=smi, hdf5=hdf5,
         rois=4, slider_updates=len(slider_ms), clicks=len(click_ms),
         slider_ms_median=statistics.median(slider_ms), slider_ms=slider_ms,
         click_ms_median=statistics.median(click_ms),
         specred_launches=main_launches,
         launches_per_slider_update=slider_launch[0], launches_per_click=click_launch[0],
         polar_launches=main_polar_launches, polar_launches_per_slider_update=polar_step[0],
         polar_launches_per_click=polar_click,
         stage_ms=ex.pipeline.timings_ms)
    main_spec = ex.pipeline.slots[ex.pipeline.fft_index].fft.reshape(n, f)
    main_masks = torch.cat([torch.ones((1, n), device=dev),
                            ex._mask_stack.reshape(-1, n)])

    # 4a. the show_data hook on a click (clicks without and with a stage
    # overriding it), then the ROI rasterizer (csrc/roi.c) beside its plain
    # version, add_roi and the downscale that rasterizes again
    emit(phase="show_data", shape=[width, height, n_time], card=smi,
         **drive_show_data(ex, width, height, np.random.default_rng(args.seed + 3)))
    roi_200 = rasterizer_timings(ex, width, height, with_downscale=True)
    check_published(ex, width, height, n_time)

    # 4b. the envelope kernel vs its plain version: the main path's own final
    # cube at the view's settings, then ragged inputs
    ex.set_opacity_threshold(_VIEW_OPACITY_THRESHOLD)
    v3 = ex.view3d
    env_taps = voxel.gaussian_kernel1d(v3["kernel_sigma"], v3["kernel_radius"])
    env_args = (float(v3["contrast"]), float(v3["opacity_threshold"]))
    final = ex.pipeline.output.data
    env_flat = final.reshape(-1, final.shape[-1])
    env_shape = list(env_flat.shape)
    env_err, env_edges = check_envelope(env_flat, env_taps, *env_args, "main cube")
    env_plan = check_envelope_plan(*env_flat.shape, int(v3["kernel_radius"]))
    ragged_env, env_routes = {}, {}
    for label, case in ragged_envelope_cases(dev, gen).items():
        ragged_env[label] = check_envelope(*case, label)
        p = check_envelope_plan(*case[0].shape, len(case[1]) // 2)
        env_routes[label] = [p["route"], p["radius"], p["warps"], p["stages"], p["outs"]]
    assert env_routes["t40000_n3_gauss_r9"][4] == 0 and env_routes["t29055_n2_r0"][4] == 0
    env_ms = device_ms(lambda: env.envelope(env_flat, env_taps, *env_args))
    env_wrapper_ms = time_ms(lambda: env.envelope(env_flat, env_taps, *env_args))
    env_plain_ms = time_ms(lambda: env.envelope_plain(env_flat, env_taps, *env_args),
                           reps=5, inner=1)
    env_bound, env_bound_by = envelope_bound_ms(*env_flat.shape, int(v3["kernel_radius"]),
                                                name)
    emit(phase="envelope_kernel_vs_plain", main_shape=env_shape,
         main_max_abs_err=env_err, main_edge_traces=env_edges,
         ragged_max_abs_err={k: v[0] for k, v in ragged_env.items()},
         ragged_edge_traces={k: v[1] for k, v in ragged_env.items()},
         ragged_routes=env_routes,
         deterministic=True,
         tolerance=f"|kernel-plain| <= {_ENV_TOL} on every trace off the normalization "
                   f"edges (max or range within {_ENV_EDGE} relative of thr or 1e-6)",
         plan=env_plan, kernel_ms=env_ms, timing="device time behind a spin (device_ms)",
         wrapper_ms=env_wrapper_ms, plain_ms=env_plain_ms,
         bound_ms=env_bound, bound_by=env_bound_by)

    # 4c. the 3-D view on the main path's Explorer: the live view as web.py
    # serves it (packed fetch), then one dense extraction (the VTU export's)
    assert final.numel() < voxel._PACK_IDX_LIMIT
    env.envelope.launches = 0
    views = [live_view(ex) for _ in range(11)]
    data3d, kw3d = view_args(ex)
    dense_ms, dense = timed(lambda: voxel.extract_instances(data3d, **kw3d))
    view_launches = env.envelope.launches
    assert view_launches == len(views) + 1, view_launches
    view_ms = [v[0] for v in views]
    pos, rgba, *_, view_thr = views[-1][1]
    assert 0 < len(pos) <= _VIEW_MAX_POINTS and np.isfinite(pos).all() \
        and np.isfinite(rgba).all() and (rgba[:, 3] > 0).all()
    dense_above = int((dense[1][:, 3] > dense[5]).sum())
    assert dense_above <= voxel.MAX_INSTANCES and np.isfinite(dense[0]).all()
    emit(phase="view3d", shape=[width, height, n_time], card=smi, settings=dict(v3),
         max_points=_VIEW_MAX_POINTS, fetch="packed", live_ms_median=statistics.median(view_ms),
         live_ms=view_ms, live_points=len(pos), live_threshold=view_thr,
         dense_ms=dense_ms, dense_points=len(dense[0]), dense_points_above_threshold=dense_above,
         dense_threshold=dense[5], envelope_launches=view_launches,
         envelope_launches_per_view=1)
    del views, dense, data3d

    # 5. the Apply path on the same Explorer: filters and ROIs stay active
    sr.spectral_reduction_sums.launches = 0
    rlsep.rl_bands_separable.launches = 0
    rlsep.rl_bands_separable.launches_wide = 0
    rlsep.rl_bands_separable.launches_tiled = 0
    bs.weighted_spectrum.launches = 0
    n_again = 5
    apply, geometry, deconv_input = drive_apply(ex, 3, 5, n_again,
                                                np.random.default_rng(args.seed))
    # one band-sum launch per Apply, none per slider step or click
    bandsum_apply_launches = bs.weighted_spectrum.launches
    assert bandsum_apply_launches == 1 + n_again, bandsum_apply_launches
    # 1 + n_again Applies, each one cluster launch per non-empty checkpoint
    # group (9 at the default parameters) and no half-iteration launch
    apply_launches = rlsep.rl_bands_separable.launches
    apply_tiled_launches = rlsep.rl_bands_separable.launches_tiled
    assert apply_launches == (1 + n_again) * len(rlsep.launch_schedule(geometry.n_iter)) > 0
    assert apply_tiled_launches == 0
    geo = geometry_summary(geometry, (width, height))
    emit(phase="apply", shape=[width, height, n_time], card=smi, dx_mm=0.5,
         psf="synthetic: wx=0.70/f+0.50 mm, wy=0.85/f+0.55 mm, x0=0.3 mm, y0=-0.2 mm",
         params="default DeconvolutionParams (25 bands, 500 iterations)",
         specred_launches=sr.spectral_reduction_sums.launches,
         bandsum_launches=bandsum_apply_launches, **apply, geometry=geo)

    # 5b. the 3-D view of the deconvolved final slot: no RL launch
    k = ex.pipeline.index_of("deconvolution")
    assert ex.pipeline.slots[k] is not ex.pipeline.slots[k - 1]
    def rl_count():
        return rlsep.rl_bands_separable.launches + rlsep.rl_bands_separable.launches_tiled

    rl_before, env_before = rl_count(), env.envelope.launches
    after_ms, after = live_view(ex)
    after_rl = rl_count() - rl_before
    assert after_rl == 0 and env.envelope.launches == env_before + 1
    assert 0 < len(after[0]) <= _VIEW_MAX_POINTS and np.isfinite(after[1]).all()
    emit(phase="view3d_after_apply", live_ms=after_ms, live_points=len(after[0]),
         live_threshold=after[5], rl_launches=after_rl, envelope_launches=1)

    # 6. the separable RL kernels vs their plain version: the cluster kernel
    # on the Apply's own inputs (at its cluster size and at 8) and on ragged
    # ones, the half-iteration kernel on a canvas over the cluster limit and
    # (routed there by half_iteration_route) on the Apply's inputs
    # 5c. the band-sum kernel vs its plain version on the Apply's own inputs
    layout = kernels.load("bandsum").thz_bandsum_smem
    for n_, m_, b_ in ((40000, 769, 25), (262144, 769, 25), (40000, 1153, 25),
                       (40000, 769, 200), (20000, 1025, 7), (117, 9, 3)):
        p_ = bs.plan(n_, m_, b_)
        assert layout(p_["ci"], p_["bc"]) == p_["smem"] == bs.layout_bytes(p_["ci"], p_["bc"]), p_
    assert bs.library_config()["block_rows"] == bs.BLOCK_ROWS
    bandsum_200 = check_bandsum(deconv_input, geometry, name)
    emit(phase="bandsum_kernel_vs_plain", card=smi, grid=[width, height], **bandsum_200,
         launches_per_apply=bandsum_apply_launches // (1 + n_again),
         timing="kernel_ms, phase_ms: device time behind a spin (device_ms); plain_ms, "
                "phase_plain_ms: CUDA events around back-to-back calls (time_ms)")
    padded, px, py, n_iter = dec.rl_inputs(deconv_input, geometry)
    del deconv_input
    rl_shape = list(padded.shape)
    kr, kc = px.shape[1], py.shape[1]
    s_apply = rlsep.cluster_size_for(*rl_shape[1:], kr, kc)
    assert s_apply is not None and rlsep.cluster_fits(*rl_shape[1:], kr, kc, 8)
    smem = kernels.load("rlsep_cluster").thz_rlsep_cluster_smem
    ragged_inputs = ragged_rl_cases(dev, gen)
    for shape in [rl_shape] + [list(v[0].shape) for v in ragged_inputs.values()]:
        for s in (1, 8, 16):
            if s <= shape[1]:
                args_ = (shape[1], shape[2], kr, kc, s)
                assert smem(*args_) == rlsep.cluster_smem_bytes(*args_), args_
                for g in (1, 2, 5):
                    assert kernels.load("rlsep_cluster").thz_rlsep_grouped_smem(*args_, g) == \
                        rlsep.grouped_smem_bytes(*args_, g), (args_, g)
    rl_plain = rlsep.rl_bands_separable_plain(padded, px, py, n_iter)
    rl_err, rl_rel = check_rl(padded, px, py, n_iter, "apply geometry", "cluster", ref=rl_plain)
    with preferred_cluster(8):
        assert rlsep.cluster_size_for(*rl_shape[1:], kr, kc) == 8
        rl8_err, rl8_rel = check_rl(padded, px, py, n_iter, "apply geometry S=8", "cluster",
                                    ref=rl_plain)
    ragged = {label: check_rl(*inputs, label, "cluster")
              for label, inputs in ragged_inputs.items()}
    over = over_limit_rl_case(dev, gen)
    assert rlsep.cluster_size_for(*over[0].shape[1:], over[1].shape[1], over[2].shape[1]) is None
    tiled_before = rlsep.rl_bands_separable.launches_tiled
    over_err = check_rl(*over, "over the cluster limit 720x720", "tiled")
    over_launches = rlsep.rl_bands_separable.launches_tiled - tiled_before
    tiled_before = rlsep.rl_bands_separable.launches_tiled
    with half_iteration_route():
        tiled = rlsep.rl_bands_separable(padded, px, py, n_iter)
    assert rlsep.rl_bands_separable.launches_tiled - tiled_before == 2 * int(n_iter.max())
    tiled_err, tiled_rel = rl_errors(tiled, rl_plain, "half-iteration kernel, apply geometry")
    cluster_out = rlsep.rl_bands_separable(padded, px, py, n_iter)
    del rl_plain, over, tiled

    def cluster_run(s):
        def run():
            with preferred_cluster(s):
                rlsep.rl_bands_separable(padded, px, py, n_iter)
        return run

    def tiled_run():
        with half_iteration_route():
            rlsep.rl_bands_separable(padded, px, py, n_iter)

    # in turns, in one call: cluster, half-iteration, half-iteration, cluster
    rl_ms = [time_ms(cluster_run(s_apply), reps=5, inner=1, warm=1)]
    tiled_ms = [time_ms(tiled_run, reps=5, inner=1, warm=1) for _ in range(2)]
    rl_ms.append(time_ms(cluster_run(s_apply), reps=5, inner=1, warm=1))
    rl8_ms = time_ms(cluster_run(8), reps=5, inner=1, warm=1)
    rl_plain_ms = time_ms(lambda: rlsep.rl_bands_separable_plain(padded, px, py, n_iter),
                          reps=3, inner=1, warm=1)
    rl_bound, rl_bound_by, rl_ops = rl_bound_ms(geometry, (width, height), name)
    critical_ms, critical_ops = rl_critical_path_ms(geometry, (width, height), s_apply)
    critical8_ms, _ = rl_critical_path_ms(geometry, (width, height), 8)
    emit(phase="rl_kernel_vs_plain", main_shape=rl_shape, cluster_size=s_apply,
         main_max_abs_err=rl_err, main_max_rel_err=rl_rel,
         s8_max_abs_err=rl8_err, s8_max_rel_err=rl8_rel,
         ragged_max_abs_err={k: v[0] for k, v in ragged.items()},
         ragged_max_rel_err={k: v[1] for k, v in ragged.items()},
         over_limit_shape=[1, 720, 720], over_limit_route="half-iteration",
         over_limit_max_abs_err=over_err[0], over_limit_max_rel_err=over_err[1],
         over_limit_launches=over_launches,
         tiled_apply_max_abs_err=tiled_err, tiled_apply_max_rel_err=tiled_rel,
         deterministic=True,
         tolerance=f"per band |kernel-plain| <= {_RL_REL_TOL} * max|plain|",
         cluster_ms=rl_ms, cluster_ms_s8=rl8_ms, tiled_ms=tiled_ms, plain_ms=rl_plain_ms,
         bound_ms=rl_bound, critical_path_ms=critical_ms, critical_path_ms_s8=critical8_ms,
         launches_per_apply=apply["rl_launches"],
         wide_launches_per_apply=apply["rl_wide_launches"], card=smi)
    phase_rl_wide(t, cube, dev, smi, args.seed)

    # 6b. the general 2-D RL kernel: (a) the Apply's band-0 canvas with an
    # asymmetric 9x9 PSF at the band's n_iter, on the cluster route, against
    # the plain version, and timed against the tiled route (the previous
    # design) in turns; (b) two bands' separable PSFs px (x) py as 2-D PSFs,
    # on their route, against the separable kernel's output for those bands
    # (the same function); (c) ragged images on their routes
    canvas, n0 = padded[0], int(n_iter[0])
    rl2d_shape = list(canvas.shape)
    assert n0 > 0
    psf9 = torch.as_tensor(gauss2d(9, 9, 1.3, -0.8, 1.5, 2.2), device=dev)
    rl2d_route, rl2d_s = rl2d.route_for(*rl2d_shape, 9, 9)
    assert rl2d_route == "cluster", rl2d_route
    lib2 = kernels.load("rl2d_cluster")
    ragged2d_inputs = ragged_rl2d_cases(dev, gen)
    for shape in [(*rl2d_shape, 9, 9), (*rl2d_shape, kr, kc)] + [
            (*v[0].shape, *v[1].shape) for v in ragged2d_inputs.values()]:
        for s in (1, 8, 16):
            if s <= shape[0]:
                lay = rl2d.cluster_layout(*shape, s)
                assert lib2.thz_rl2d_cluster_smem(*shape, s) == lay["bytes"], (shape, s)
                assert lib2.thz_rl2d_cluster_tile(shape[3]) == lay["tile"], shape
    rl2d.richardson_lucy_direct.launches = 0
    rl2d.richardson_lucy_direct.launches_tiled = 0
    u2 = rl2d.richardson_lucy_direct(canvas, psf9, n0)
    rl2d_launches = rl2d.richardson_lucy_direct.launches
    assert rl2d_launches == len(rlsep.launch_schedule([n0])) and \
        rl2d.richardson_lucy_direct.launches_tiled == 0, rl2d_launches
    # the plain version's one run, timed on the host (816 x 81 slice ops)
    rl2d_plain_ms, ref2 = timed(lambda: rl2d.richardson_lucy_direct_plain(canvas, psf9, n0))
    rl2d_err, rl2d_rel, _ = check_rl2d(canvas, psf9, n0, "band0 9x9", "cluster", ref=ref2)
    with tiled_rl2d():
        rl2d_tiled_err, _, tiled_counts = check_rl2d(canvas, psf9, n0, "band0 9x9 tiled",
                                                     "tiled", ref=ref2)
    assert tiled_counts == (0, 4 * n0), tiled_counts
    use_fft = geometry.use_fft_conv
    picks = [int(np.flatnonzero(use_fft & (n_iter > 0))[0]),
             int(np.flatnonzero(~use_fft & (n_iter > 0))[0])]
    outer = {}
    for b in picks:
        psf_b = torch.outer(px[b], py[b]).contiguous()
        route_b = rl2d.route_for(*rl2d_shape, *psf_b.shape)[0]
        _, rel, _ = check_rl2d(padded[b].contiguous(), psf_b, int(n_iter[b]),
                               f"outer product band {b}", route_b, ref=cluster_out[b])
        outer[f"band{b}_{'fft' if use_fft[b] else 'direct'}_{tuple(psf_b.shape)}"
              f"_n{int(n_iter[b])}"] = dict(route=route_b, rel_err_vs_rlsep=rel)
    ragged2d = {}
    for label, (img, psf, n_img) in ragged2d_inputs.items():
        route, s = rl2d.route_for(*img.shape, *psf.shape)
        _, rel, _ = check_rl2d(img, psf, n_img, label, route)
        ragged2d[label] = dict(route=route, cluster_size=s, max_rel_err=rel,
                               tile=rl2d.cluster_layout(*img.shape, *psf.shape, s or 1)["tile"])
    assert all(v["route"] == "cluster" for v in ragged2d.values()), ragged2d
    assert {v["tile"] for v in ragged2d.values()} == {8, 9}

    def rl2d_cluster_run():
        rl2d.richardson_lucy_direct(canvas, psf9, n0)

    def rl2d_tiled_run():
        with tiled_rl2d():
            rl2d.richardson_lucy_direct(canvas, psf9, n0)

    # in turns, in one call: cluster, tiled, tiled, cluster (device time
    # behind a spin; the tiled route's 816 launches also by the wrapper's
    # back-to-back time, its earlier method)
    rl2d_ms = [device_ms(rl2d_cluster_run, reps=5, inner=1, warm=1)]
    rl2d_tiled_ms = [device_ms(rl2d_tiled_run, reps=5, inner=1, warm=1)]
    rl2d_tiled_wrapper_ms = time_ms(rl2d_tiled_run, reps=5, inner=1, warm=1)
    rl2d_ms.append(device_ms(rl2d_cluster_run, reps=5, inner=1, warm=1))
    rl2d_bound, rl2d_bound_by = rl2d_bound_ms(*canvas.shape, 9, 9, n0, name)
    rl2d_floor = rl2d_floor_ms(*canvas.shape, 9, 9, n0, rl2d_s)
    emit(phase="rl2d_kernel_vs_plain", shape=rl2d_shape, psf=[9, 9], n_iter=n0,
         route=rl2d_route, cluster_size=rl2d_s, cluster_max_taps=rl2d.CLUSTER_MAX_TAPS,
         max_abs_err=rl2d_err, max_rel_err=rl2d_rel, tiled_max_abs_err=rl2d_tiled_err,
         deterministic=True, outer_products=outer, ragged=ragged2d,
         tolerance=f"|kernel-plain| <= {_RL_REL_TOL} * max|plain|; outer products vs the "
                   f"rlsep_cluster kernel's band, the same",
         kernel_ms=rl2d_ms, tiled_ms=rl2d_tiled_ms, tiled_wrapper_ms=rl2d_tiled_wrapper_ms,
         timing="device time behind a spin (device_ms), in turns",
         plain_ms=rl2d_plain_ms, bound_ms=rl2d_bound, bound_by=rl2d_bound_by,
         critical_path_ms=rl2d_floor, launches=rl2d_launches, tiled_launches=2 * n0, card=smi)
    del u2, ref2, ragged2d_inputs

    # 6c. the grouped cluster kernel: bit for bit the cluster route, on the
    # Apply's RL inputs (group 5) and on the ragged cases (group 2 and B
    # where they fit); a group that does not fit refused; groups 1, 2 and 5
    # timed in turns on the Apply's first 20 bands (20 is a multiple of each)
    assert padded.shape[0] % 5 == 0
    s_group5 = rlsep.cluster_size_for(*rl_shape[1:], kr, kc, 5)
    assert s_group5 == s_apply, s_group5
    rlsep.rl_bands_separable_grouped.launches = 0
    check_grouped(padded, px, py, n_iter, 5, cluster_out, "apply geometry")
    grouped_launches = rlsep.rl_bands_separable_grouped.launches
    ragged_groups = {}
    for label, inputs in ragged_inputs.items():
        b = inputs[0].shape[0]
        ref_g = rlsep.rl_bands_separable(*inputs)
        shape = (*inputs[0].shape[1:], inputs[1].shape[1], inputs[2].shape[1])
        ragged_groups[label] = [g for g in sorted({2, b}) if b % g == 0 and
                                rlsep.cluster_size_for(*shape, g) is not None]
        for g in ragged_groups[label]:
            check_grouped(*inputs, g, ref_g, label)
    assert any(len(v) > 0 and max(v) > 1 for v in ragged_groups.values()), ragged_groups
    six = [x[:6].contiguous() for x in (padded, px, py)]
    assert rlsep.cluster_size_for(*rl_shape[1:], kr, kc, 6) is None
    try:
        rlsep.rl_bands_separable_grouped(*six, n_iter[:6], group=6)
        raise AssertionError("group 6 at the Apply's canvas was not refused")
    except ValueError as e:
        assert "do not fit" in str(e), e
    twenty = [x[:20].contiguous() for x in (padded, px, py)]
    n20 = n_iter[:20]

    def grouped_run(g, inputs=twenty, n=n20):
        return lambda: rlsep.rl_bands_separable_grouped(*inputs, n, group=g)

    grouped20_ms = {1: [], 2: [], 5: []}
    for g in (1, 2, 5, 5, 2, 1):
        grouped20_ms[g].append(device_ms(grouped_run(g), reps=3, inner=1, warm=1))
    grouped_ms = device_ms(grouped_run(5, (padded, px, py), n_iter), reps=5, inner=1, warm=1)
    # per band-iteration of the first cluster, the one holding the longest
    # chains, whose work sets the time
    first = np.sort(n20)[::-1]
    us_per_band_iteration = {g: statistics.median(v) * 1e3 / int(first[:g].sum())
                             for g, v in grouped20_ms.items()}
    grouped_floor, grouped_floor_ops = rl_critical_path_ms(geometry, (width, height), s_apply, 5)
    emit(phase="rl_grouped_vs_group1", shape=rl_shape, group=5, cluster_size=s_group5,
         bit_identical="group 5 == rl_bands_separable's cluster route", ragged_groups=ragged_groups,
         group6="ValueError (does not fit 16 CTAs)", launches=grouped_launches,
         kernel_ms_group5=grouped_ms, first20_ms=grouped20_ms,
         first20_n_iter_sum=int(n20.sum()), us_per_band_iteration=us_per_band_iteration,
         critical_path_ms=grouped_floor, timing="device time behind a spin (device_ms), in turns",
         card=smi)
    del padded, px, py, cluster_out, twenty, six

    # 7. card vs CPU on a small scan: main path, Apply, downscale
    small_tmp = tempfile.TemporaryDirectory()
    small_view, worst_apply, worst = small_reference_check(args.seed, small_tmp.name)
    small_tmp.cleanup()
    emit(phase="small_reference", shape=[24, 20, 128],
         compared="cuda vs cpu port, every data-derived PlotData series + image, "
                  "after the Apply and at the end; the 3-D view before the Apply",
         view3d=small_view,
         tolerance_view3d="live view: same points, alpha within 1/63; dense: same points, "
                          "opacity atol 1e-3, rgb 4e-3; .vtu points == dense points",
         tolerance_apply="atol = 1e-3 * max|series|", tolerance="atol=5e-5, rtol=1e-4",
         max_abs_diff_apply=worst_apply, max_abs_diff=worst)

    # 8 (measured here, on the main path's own inputs). kernel vs plain time:
    # the kernel's device time (behind a spin, twice), the wrapper's back to
    # back, and the issue floors
    kernel_ms = device_ms(lambda: sr.spectral_reduction_sums(main_spec, main_masks, False))
    wrapper_ms = time_ms(lambda: sr.spectral_reduction_sums(main_spec, main_masks, False))
    plain_ms = time_ms(lambda: sr.spectral_reduction_sums_plain(main_spec, main_masks, False))
    kernel_again_ms = device_ms(lambda: sr.spectral_reduction_sums(main_spec, main_masks, False))
    m = int(main_masks.shape[0])
    bound, bound_by = specred_bound_ms(n, f, m, name)
    clock = sm_clock_hz()
    sr_per_element = specred_instructions(kernels.library_path("specred"), m)
    env_per_sample = envelope_instructions(kernels.library_path("envelope"),
                                           int(v3["kernel_radius"]))
    sr_floor = issue_floor_ms(sr_per_element, n * f, clock)
    env_floor = issue_floor_ms(env_per_sample, env_flat.numel(), clock)
    emit(phase="specred_timing", card=smi, shape=[n, f, m], kernel_ms=[kernel_ms, kernel_again_ms],
         wrapper_ms=wrapper_ms,
         plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, sm_clock_hz=clock,
         sass_per_element=sr_per_element, issue_floor_ms=sr_floor,
         envelope_sass_per_sample=env_per_sample, envelope_issue_floor_ms=env_floor)
    del ex, main_spec, main_masks, pulse_spec, masks5, roi_masks, final, env_flat, canvas, psf9
    torch.cuda.empty_cache()

    # 8b. tilt compensation on the main path's scan, filters and ROIs: the
    # tilt path's launches counted from 0 (the kernel checks come after)
    tilt_ex = Explorer(device="cuda")
    drive_commands(tilt_ex, lambda: tilt_ex.open_arrays(t, cube, scan_metadata(0.5)), cube, 0, 0,
                   np.random.default_rng(args.seed))
    zero_counts()
    per_tilt, tilt_spectra, (tilt_view_ms, tilt_view, tilt_flat), tilt_apply = drive_tilt(
        tilt_ex, np.random.default_rng(args.seed + 2), 6, 6, 4)
    tilt_launches = read_counts()
    for kernel in ("specred", "envelope", "rlsep_cluster", "tilt", "polar"):
        assert tilt_launches[kernel] > 0, (kernel, tilt_launches)
    k_tilt = tilt_ex.pipeline.index_of(DEC)
    tilt_bandsum = check_bandsum(tilt_ex.pipeline.slots[k_tilt - 1].data,
                                 tilt_ex.pipeline.filters[DEC]._plan_cache[1], name)
    # the kernels on the tilt path's own inputs: specred at both F, the
    # envelope on the T = 1606 live view's traces (its plain-load route)
    tilt_specred = {}
    for nf, (spec_t, masks_t) in sorted(tilt_spectra.items()):
        errs = [check_specred(spec_t, masks_t, wc, f"tilt F={nf} wc={wc}")[0] for wc in (False, True)]
        m_t = int(masks_t.shape[0])
        bound_t, bound_by_t = specred_bound_ms(n, nf, m_t, name)
        tilt_specred[f"F{nf}"] = dict(
            shape=[n, nf, m_t], max_abs_err=max(errs),
            ms=device_ms(lambda: sr.spectral_reduction_sums(spec_t, masks_t, False)),
            plain_ms=time_ms(lambda: sr.spectral_reduction_sums_plain(spec_t, masks_t, False),
                             reps=5, inner=2),
            bound_ms=bound_t, bound_by=bound_by_t, plan=check_specred_plan(n, nf, m_t))
    t_view = tilt_flat.shape[1]
    tilt_env_plan = check_envelope_plan(n, t_view, int(v3["kernel_radius"]))
    tilt_env_err, tilt_env_edges = check_envelope(tilt_flat, env_taps, *env_args,
                                                  f"tilted view T={t_view}")
    tilt_env_bound, tilt_env_bound_by = envelope_bound_ms(n, t_view, int(v3["kernel_radius"]),
                                                          name)
    tilt_envelope = dict(
        shape=[n, t_view], route=tilt_env_plan["route"], max_abs_err=tilt_env_err,
        edge_traces=tilt_env_edges,
        ms=device_ms(lambda: env.envelope(tilt_flat, env_taps, *env_args)),
        plain_ms=time_ms(lambda: env.envelope_plain(tilt_flat, env_taps, *env_args),
                         reps=5, inner=1),
        bound_ms=tilt_env_bound, bound_by=tilt_env_bound_by)
    assert t_view % 4 != 0 and tilt_env_plan["route"] == "plain", tilt_env_plan
    f_tilted = max(tilt_spectra)
    alloc_ms, alloc_bytes = replan_alloc_ms((width, height, f_tilted))
    # cuFFT's plans for a new T, at lengths no call has used: 1680 = 2^4 3 5 7,
    # 1826 = 2 11 83, 1874 = 2 937
    plan_ms = cufft_plan_ms(n, (1680, 1826, 1874))
    small_t, small_worst = small_tilt_reference(args.seed)
    emit(phase="tilt", shape=[width, height, n_time], card=smi, dx_mm=0.5,
         tilts=per_tilt, launches=tilt_launches,
         view_T=t_view, view_ms=tilt_view_ms, view_points=len(tilt_view[0]),
         envelope_launches_per_view=1, envelope=tilt_envelope,
         specred=tilt_specred, apply=tilt_apply, bandsum=tilt_bandsum,
         replan="zero spectra expanded from a scalar (no allocation)",
         replan_alloc_ms_avoided=alloc_ms, replan_alloc_bytes_avoided=alloc_bytes,
         cufft_plan_ms=plan_ms,
         small_reference=dict(shape=[24, 20, 128], T=small_t, max_abs_diff=small_worst,
                              tolerance="atol=5e-5, rtol=1e-4, cuda vs cpu port"),
         timing="host ms with a synchronize on each side; kernels: device time behind a "
                "spin (device_ms)")
    del tilt_spectra, tilt_flat, tilt_view
    torch.cuda.empty_cache()
    phase_tilt_kernel(t, cube, name, smi)
    polar_cases = phase_polar_kernel(name, smi)

    # 8c. the PSF tool end to end: knife-edge traces of the reference
    # fixture's shape -> compute_psf on the card -> export -> load -> Apply
    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
    from thz_image_explorer_tpu_torch.ops import firapply
    from thz_image_explorer_tpu_torch.psf_tool.app import PsfToolApp, compute_psf
    from thz_image_explorer_tpu_torch.psf_tool.app import FilterParams as PsfFilterParams
    from thz_image_explorer_tpu_torch.psf_tool.data_loader import KnifeEdgeMeasurement
    from thz_image_explorer_tpu_torch.psf_tool.data_loader import split_and_flip

    # the traces written as the tool's .thz files (the port's writer), read
    # back by the tool's loader: equal to the arrays before compute_psf
    knife, knife_files = {}, {}
    with tempfile.TemporaryDirectory() as knife_tmp:
        for ax, seed_, scale_ in (("x", args.seed, 1.0), ("y", args.seed + 1, 1.2)):
            arrays = knife_edge_traces(seed=seed_, width_scale=scale_)
            path = write_knife_edge_file(f"{knife_tmp}/knife_{ax}.thz", *arrays)
            load_ms, knife[ax] = timed(lambda: KnifeEdgeMeasurement.from_thz_file(path))
            got = (knife[ax].positions, knife[ax].time_traces, knife[ax].times)
            assert all(np.array_equal(a, b) for a, b in zip(got, arrays)), ax
            knife_files[ax] = dict(load_ms=load_ms, bytes=Path(path).stat().st_size,
                                   groups=len(arrays[0]))
    knife_x, knife_y = knife["x"], knife["y"]
    tilt_ex.set_filter_active(TILT, False)  # the scan's own axis again
    zero_counts()
    psf_res, psf_ms, psf_filter_ms = drive_psf_tool(knife_x, knife_y, dev)
    tool = PsfToolApp(device=dev)
    tool.result = psf_res  # the computed result (the app's thread would compute it again)
    psf_tmp = tempfile.TemporaryDirectory()
    psf_path = f"{psf_tmp.name}/psf_tool.npz"
    assert tool.export_npz(psf_path)
    tool_psf = load_psf(psf_path)
    psf_tmp.cleanup()
    assert tool_psf.fingerprint() == tool.runtime_psf().fingerprint()
    tilt_ex.apply_psf(tool_psf)
    rl_fn = rlsep.rl_bands_separable
    tool_apply_ms, tool_rl = command_ms(lambda: tilt_ex.update_filter(DEC, force=True),
                                        lambda: rl_fn.launches + rl_fn.launches_tiled)
    tool_again_ms, tool_rl_again = command_ms(lambda: tilt_ex.update_filter(DEC, force=True),
                                              lambda: rl_fn.launches + rl_fn.launches_tiled)
    psf_launches = read_counts()
    tool_geometry = tilt_ex.pipeline.filters[DEC]._plan_cache[1]
    assert tool_rl == tool_rl_again == len(rlsep.launch_schedule(tool_geometry.n_iter)) > 0
    assert psf_launches["rlsep_cluster"] > 0 and psf_launches["rlsep"] == 0, psf_launches
    assert np.isfinite(tilt_ex.image).all() and tilt_ex.image.shape == (width, height)
    # the filtering against a float64 numpy correlation of the same traces
    # (the x axis's right half), then the card's fits against the CPU port's
    half = split_and_flip(knife_x)[1]
    filt, inten = firapply.fir_correlate_bands_device(half.time_traces, psf_res.filters, dev)
    ref_filt = fir_reference(half.time_traces, psf_res.filters)
    filt_err = float(np.abs(filt.cpu().numpy() - ref_filt).max())
    assert filt_err <= 1e-6 * np.abs(ref_filt).max(), filt_err
    ref_inten = np.stack([(b ** 2).sum(-1) for b in ref_filt])
    lo, hi = ref_inten.min(1, keepdims=True), ref_inten.max(1, keepdims=True)
    ref_inten = (ref_inten - lo) / (hi - lo)
    inten_err = float(np.abs(inten - ref_inten).max())
    assert inten_err <= 1e-9, inten_err
    del filt
    cpu_ms, cpu_res = timed(lambda: compute_psf(knife_x, knife_y, PsfFilterParams(),
                                                device="cpu"))
    psf_cpu_worst = compare_psf_fits(psf_res, cpu_res)
    # rlsep_cluster on the tool PSF's own RL inputs
    k_dec = tilt_ex.pipeline.index_of(DEC)
    tool_rl_inputs = dec.rl_inputs(tilt_ex.pipeline.slots[k_dec - 1].data, tool_geometry)
    tool_shape = list(tool_rl_inputs[0].shape)
    tool_route = "cluster" if rlsep.cluster_size_for(
        *tool_shape[1:], tool_rl_inputs[1].shape[1], tool_rl_inputs[2].shape[1]) else "tiled"
    tool_rl_plain_ms, tool_rl_ref = timed(lambda: rlsep.rl_bands_separable_plain(*tool_rl_inputs))
    tool_rl_err, tool_rl_rel = check_rl(*tool_rl_inputs, "tool PSF", tool_route, ref=tool_rl_ref)
    tool_rl_ms = device_ms(lambda: rlsep.rl_bands_separable(*tool_rl_inputs), reps=5, inner=1,
                           warm=1)
    tool_rl_bound, tool_rl_bound_by, _ = rl_bound_ms(tool_geometry, (width, height), name)
    del tool_rl_inputs, tool_rl_ref
    widths = {ax: np.round(getattr(psf_res, ax).beam_fits.popt_xs[:, 1], 4).tolist()
              for ax in ("x", "y")}
    emit(phase="psf_tool", card=smi, knife_edge=[300, 1001], knife_edge_files=knife_files,
         bands=int(psf_res.filters.shape[0]),
         taps=int(psf_res.filters.shape[1]), params="default FilterParams (20 bands, log)",
         compute_psf_ms=psf_ms, device_filter_ms=psf_filter_ms,
         device_filter_calls=len(psf_filter_ms), cpu_compute_psf_ms=cpu_ms,
         center_frequencies_thz=np.round(psf_res.center_frequencies, 4).tolist(),
         fitted_widths_mm=widths, filtered_max_abs_err=filt_err,
         intensities_max_abs_err=inten_err,
         filter_tolerance="cube |card - f64 numpy| <= 1e-6 * max; intensities <= 1e-9",
         card_vs_cpu_fits_max_abs_mm=psf_cpu_worst, card_vs_cpu_tolerance_mm=_PSF_CPU_ATOL,
         apply=dict(shape=[width, height, n_time], first_apply_ms=tool_apply_ms,
                    apply_again_ms=tool_again_ms, rl_launches_per_apply=tool_rl,
                    geometry=geometry_summary(tool_geometry, (width, height))),
         launches=psf_launches,
         rl_kernel=dict(shape=tool_shape, route=tool_route, max_abs_err=tool_rl_err,
                        max_rel_err=tool_rl_rel, ms=tool_rl_ms, plain_ms=tool_rl_plain_ms,
                        bound_ms=tool_rl_bound, bound_by=tool_rl_bound_by))

    # 8d. open_ref: a pulse through the array seam as the optical reference
    zero_counts()
    ref_optical, ref_inputs, ref_skipped = drive_open_ref(tilt_ex, t, cube)
    ref_launches = read_counts()
    assert ref_launches["specred"] > 0, ref_launches
    ref_rel = check_open_ref_optical(ref_optical, ref_inputs)
    emit(phase="open_ref", card=smi, pulse="the scan's mean trace x 1.2, open_ref_arrays",
         optical_bins=len(ref_optical["refractive_index"]),
         n_median=float(np.median(ref_optical["refractive_index"][1:])),
         optical_vs_formula_max_rel=ref_rel, after_tilt="skipped: " + ref_skipped[0],
         launches=ref_launches)
    del tilt_ex
    torch.cuda.empty_cache()


    # 8e. the shell: the worker, the two-phase open, the HTTP server
    shell = phase_shell(t, cube, args.seed)
    shell_launches = shell["launches"]
    emit(phase="shell", shape=[width, height, n_time], card=smi,
         compared=dict(web_vs_direct="plot series of /api/state vs the same Explorer commands "
                                     "on the card, in _series rounding units (<= 1)",
                       card_vs_cpu="24x20x128, two WebApps, atol 5e-5, rtol 1e-4"),
         **shell)
    torch.cuda.empty_cache()

    # 9. scale: the README's larger scan, 512x512x1024 (a 1 GiB cube)
    t5, cube5 = synthetic_scan(512, 512, 1024, seed=args.seed + 1)
    torch.cuda.reset_peak_memory_stats()
    ex5 = Explorer(device="cuda")
    t0 = time.perf_counter()
    ex5.open_arrays(t5, cube5)
    torch.cuda.synchronize()
    open_ms = (time.perf_counter() - t0) * 1e3
    for uuid in ("time_band_pass_before_fft", "frequency_band_pass", "water_vapor_notch"):
        ex5.set_filter_active(uuid, True)
    for i, poly in enumerate(roi_polygons(512, 512)):
        ex5.add_roi(f"roi-{i}", f"ROI {i}", poly)
    scale_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex5.set_fft_window_low(1.0 + 0.05 * (i + 1))
        torch.cuda.synchronize()
        scale_ms.append((time.perf_counter() - t0) * 1e3)
    assert np.isfinite(ex5.plot.avg_signal_fft).all() and ex5.image.shape == (512, 512)
    scale_peak = torch.cuda.max_memory_allocated()
    assert ex5.pipeline.output.data.numel() >= voxel._PACK_IDX_LIMIT
    ex5.set_opacity_threshold(_VIEW_OPACITY_THRESHOLD)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    env_before = env.envelope.launches
    scale_view_ms, scale_view = live_view(ex5)
    assert env.envelope.launches == env_before + 1
    assert 0 < len(scale_view[0]) <= _VIEW_MAX_POINTS and np.isfinite(scale_view[1]).all()
    emit(phase="scale", shape=[512, 512, 1024], card=smi, open_ms=open_ms,
         slider_ms_median=statistics.median(scale_ms), slider_ms=scale_ms,
         max_memory_allocated=scale_peak, view_fetch="unpacked (f16 + i32)",
         view_ms=scale_view_ms, view_points=len(scale_view[0]),
         view_threshold=scale_view[5],
         view_memory_allocated_before=resident,
         view_max_memory_allocated=torch.cuda.max_memory_allocated())
    roi_512 = rasterizer_timings(ex5, 512, 512, with_downscale=False)
    emit(phase="roi_rasterizer", card=smi, source="thz_image_explorer_tpu_torch/csrc/roi.c",
         replaces="thz_image_explorer_tpu/native/thznative.c:86 (thz_polygon_mask), host C",
         grid200=roi_200, grid512=roi_512,
         timing="host ms; C: median of 5 calls of ops.roi.polygon_mask, plain: one call of "
                "polygon_mask_plain; add_roi: the command with its publish, a synchronize on "
                "each side")
    # both redesigned kernels on this scan's own inputs
    n5 = 512 * 512
    spec5 = ex5.pipeline.slots[ex5.pipeline.fft_index].fft.reshape(n5, f)
    masks5_512 = torch.cat([torch.ones((1, n5), device=dev), ex5._mask_stack.reshape(-1, n5)])
    flat5 = ex5.pipeline.output.data.reshape(n5, -1)
    v35 = ex5.view3d
    taps5 = voxel.gaussian_kernel1d(v35["kernel_sigma"], v35["kernel_radius"])
    args5 = (float(v35["contrast"]), float(v35["opacity_threshold"]))
    sr_ms_512 = device_ms(lambda: sr.spectral_reduction_sums(spec5, masks5_512, False), inner=5)
    env_ms_512 = device_ms(lambda: env.envelope(flat5, taps5, *args5), inner=5)
    sr_bound_512, _ = specred_bound_ms(n5, f, int(masks5_512.shape[0]), name)
    env_bound_512, _ = envelope_bound_ms(*flat5.shape, int(v35["kernel_radius"]), name)
    del spec5, masks5_512, flat5
    # the band sum on the Apply's inputs for this scan (the synthetic PSF at
    # the default parameters, pitch 0.5 mm: the benchmark's 512x512 Apply)
    geometry5 = dec.plan_bands(dec.DeconvolutionParams(), synthetic_psf(), t5, (512, 512),
                               0.5, 0.5)
    bandsum_512 = check_bandsum(ex5.pipeline.output.data, geometry5, name)
    emit(phase="scale_kernels", shape=[512, 512, 1024], card=smi,
         specred_ms=sr_ms_512, specred_bound_ms=sr_bound_512, envelope_ms=env_ms_512,
         envelope_bound_ms=env_bound_512, bandsum=bandsum_512,
         timing="device time behind a spin (device_ms); the band sum's plain ms: CUDA "
                "events around back-to-back calls")
    del ex5, geometry5
    torch.cuda.empty_cache()

    # 9a. dotTHz files: save, read, the two-phase open from the file against
    # open_arrays, metadata load and update, a pulse, at 200x200 and 512x512
    with tempfile.TemporaryDirectory() as file_tmp:
        files = {f"grid{w}": dotthz_file_size(tt, cc, file_tmp)
                 for w, tt, cc in ((width, t, cube), (512, t5, cube5))}
    emit(phase="dotthz_file", card=smi, writer="io/hdf5.py (superblock v0, contiguous)",
         **files, timing="host ms with a synchronize on each side; each file is read right "
                         "after it was written (the page cache)")
    torch.cuda.empty_cache()

    # 9a'. chunked dotTHz files: gzip + shuffle and lzf + shuffle, one scan
    # line a chunk, at 200x200 and 512x512; the 200x200 lzf file opened
    # through the page and driven against the contiguous file's open; the
    # committed fixtures of h5py's other formats
    features = phase_dotthz_features(t, cube, t5, cube5, args.seed)
    emit(phase="dotthz_features", card=smi,
         writer="io/hdf5.py create_dataset(chunks=(1, H, T), compression=..., shuffle=True): "
                "superblock v0, v1 B-tree, filter pipeline v1",
         lzf_source="thz_image_explorer_tpu_torch/csrc/lzf.c",
         lzf_replaces="h5py's lzf filter (lzf_filter.c with liblzf), host C",
         **features, timing="host ms with a synchronize on each side; each file is read right "
                            "after it was written (the page cache); the lzf decoder's ms are "
                            "host time of ctypes calls, its plain version one Python call")
    torch.cuda.empty_cache()

    # 9b. multiple devices: one rank over NCCL, 2 and 4 ranks sharing the
    # card over gloo (each rank's launch counts zeroed just before its path
    # and read just after), 4 ranks at 512x512x1024
    multi, md_work = phase_multi_device(t, cube, t5, cube5, name, smi, args.seed)
    emit(phase="multi_device", **multi)
    del cube5
    md_launches = {kernel: {"world1": multi["world1"]["launches"][kernel],
                            **{f"world{w}": [r["launches"][kernel] for r in multi[f"world{w}"]["ranks"]]
                               for w in (2, 4)}}
                   for kernel in ("specred", "rlsep_cluster", "rlsep_wide", "envelope", "bandsum")}
    md_block = {f"world{w}": multi[f"world{w}"]["kernels_at_block"] for w in (2, 4)}

    # 9c. the incremental Pipeline and its publish on a pixel-sharded cube:
    # one rank over NCCL in lockstep with the single device, 2 and 4 ranks
    # sharing the card over gloo, run in 9b's rank processes after their
    # multi_device work (each command's launch counts zeroed just before it
    # and read just after, in each rank's own process)
    pipe = phase_pipeline_mesh(t, cube, name, smi, args.seed, md_work)
    emit(phase="pipeline_mesh", **pipe)
    pm_launches, pm_odd_launches = ({kernel: {
        "world1": rec["world1"]["launches"][kernel],
        **{f"world{w}": [r["launches"][kernel] for r in rec[f"world{w}"]["ranks"]]
           for w in (2, 4)}} for kernel in ("specred", "rlsep_cluster", "envelope", "bandsum")}
        for rec in (pipe, pipe["odd"]))
    pm_2mod4_launches = {kernel: {
        "world1": pipe["world1"]["launches_2mod4"][kernel],
        **{f"world{w}": [r["launches_2mod4"][kernel] for r in pipe[f"world{w}"]["ranks"]]
           for w in (2, 4)}} for kernel in ("specred", "envelope")}
    pm_2mod4_blocks = pipe["world1"]["kernels_2mod4"]["at_blocks"]

    # 10. the kernels line
    print(json.dumps({"kernels": [{
        "name": "specred",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/specred.cu",
        "replaces": _SPECRED_REPLACES,
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "max_rel_err": max_rel_err,
        # the kernel's device time behind a spin; the wrapper's back to back
        "ms": kernel_ms,
        "ms_runs": [kernel_ms, kernel_again_ms],
        "wrapper_ms": wrapper_ms,
        "ms_previous_design": None,
        "previous_design_missing": _PREVIOUS_DESIGN,
        "ms_512": sr_ms_512,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "bound_ms_512": sr_bound_512,
        "issue_floor_ms": sr_floor,
        "sass_per_element": sr_per_element,
        "kernels_per_call": 1,
        "library_ms": None,
        "shape": [n, f, m],
        # the tilt path (F = 745 and 804), the PSF tool's and open_ref's
        "launches_tilt": tilt_launches["specred"],
        "tilt": tilt_specred,
        "launches_psf_tool": psf_launches["specred"],
        "launches_open_ref": ref_launches["specred"],
        "launches_shell": shell_launches["specred"],
        # per rank of the multi_device phase, and the block shapes' times
        "launches_multi_device": md_launches["specred"],
        "launches_pipeline_mesh": pm_launches["specred"],
        "launches_pipeline_mesh_odd": pm_odd_launches["specred"],
        "launches_pipeline_mesh_2mod4": pm_2mod4_launches["specred"],
        "pipeline_mesh_2mod4_blocks": {w: dict(n=v["n"], f=v["f"], ms=v["specred_ms"],
                                               bound_ms=v["specred_bound_ms"])
                                       for w, v in pm_2mod4_blocks.items()},
        "multi_device_block": {w: dict(n=v["n"], ms=v["specred_ms"], bound_ms=v["specred_bound_ms"])
                               for w, v in md_block.items()},
    }, {
        "name": "rlsep_cluster",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/rlsep_cluster.cu",
        "replaces": _RLSEP_REPLACES,
        # the Apply path's run: six Applies, one launch per checkpoint group
        "launches": apply_launches,
        "launches_per_apply": apply["rl_launches"],
        "wide_launches_per_apply": apply["rl_wide_launches"],
        "max_abs_err": rl_err,
        "max_rel_err": rl_rel,
        "ms": statistics.median(rl_ms),
        "ms_runs": rl_ms,
        "ms_s8": rl8_ms,
        "plain_ms": rl_plain_ms,
        "bound_ms": rl_bound,
        "bound_by": rl_bound_by,
        "bound_operations": rl_ops,
        "critical_path_ms": critical_ms,
        "critical_path_operations": critical_ops,
        "cluster_size": s_apply,
        # no single PyTorch call runs the Richardson-Lucy recurrence
        "library_ms": None,
        "shape": rl_shape,
        "n_iter_sum": geo["n_iter_sum"],
        # an Apply after tilt, and the Apply on the PSF tool's PSF
        "launches_tilt": tilt_launches["rlsep_cluster"],
        "launches_psf_tool": psf_launches["rlsep_cluster"],
        "launches_shell": shell_launches["rlsep_cluster"],
        "launches_multi_device": md_launches["rlsep_cluster"],
        "wide_launches_tilt": tilt_launches["rlsep_wide"],
        "wide_launches_psf_tool": psf_launches["rlsep_wide"],
        "wide_launches_multi_device": md_launches["rlsep_wide"],
        "launches_pipeline_mesh": pm_launches["rlsep_cluster"],
        "tool_psf": dict(shape=tool_shape, route=tool_route, max_abs_err=tool_rl_err,
                         ms=tool_rl_ms, plain_ms=tool_rl_plain_ms, bound_ms=tool_rl_bound,
                         bound_by=tool_rl_bound_by),
    }, {
        "name": "bandsum",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/bandsum.cu",
        "replaces": _BANDSUM_REPLACES,
        "launches": bandsum_apply_launches,
        "launches_per_apply": bandsum_apply_launches // (1 + n_again),
        "max_abs_err": bandsum_200["max_abs_err"],
        "ms": bandsum_200["kernel_ms"],
        "plain_ms": bandsum_200["plain_ms"],
        "bound_ms": bandsum_200["bound_ms"],
        "bound_by": "bytes",
        "ms_512": bandsum_512["kernel_ms"],
        "plain_ms_512": bandsum_512["plain_ms"],
        "bound_ms_512": bandsum_512["bound_ms"],
        "phase_ms_512": bandsum_512["phase_ms"],
        "phase_plain_ms_512": bandsum_512["phase_plain_ms"],
        # no single PyTorch call computes the gains, the weight and the product
        "library_ms": None,
        "shape": bandsum_200["shape"],
        "tilt": tilt_bandsum,
        "launches_tilt": tilt_launches["bandsum"],
        "launches_psf_tool": psf_launches["bandsum"],
        "launches_shell": shell_launches["bandsum"],
        "launches_multi_device": md_launches["bandsum"],
        "launches_pipeline_mesh": pm_launches["bandsum"],
        "launches_pipeline_mesh_odd": pm_odd_launches["bandsum"],
    }, {
        "name": "rlsep",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/rlsep.cu",
        "replaces": _RLSEP_REPLACES,
        # the half-iteration route takes only canvases over the cluster
        # limit: 0 launches on the Apply path; its launches in the smoke's
        # over-limit run (two runs of 2 per iteration)
        "launches": over_launches,
        "apply_launches": apply_tiled_launches,
        "max_abs_err": tiled_err,
        "max_rel_err": tiled_rel,
        "over_limit_max_abs_err": over_err[0],
        "launches_shell": shell_launches["rlsep"],
        "ms": statistics.median(tiled_ms),
        "ms_runs": tiled_ms,
        "plain_ms": rl_plain_ms,
        "bound_ms": rl_bound,
        "bound_by": rl_bound_by,
        "library_ms": None,
        "shape": rl_shape,
    }, {
        "name": "envelope",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/envelope.cu",
        "replaces": _ENVELOPE_REPLACES,
        "launches": view_launches,
        "max_abs_err": env_err,
        "ms": env_ms,
        "wrapper_ms": env_wrapper_ms,
        "ms_previous_design": None,
        "previous_design_missing": _PREVIOUS_DESIGN,
        "ms_512": env_ms_512,
        "plain_ms": env_plain_ms,
        "bound_ms": env_bound,
        "bound_by": env_bound_by,
        "bound_ms_512": env_bound_512,
        "issue_floor_ms": env_floor,
        "sass_per_sample": env_per_sample,
        # no single PyTorch call computes the power, correlation and
        # per-trace normalization
        "library_ms": None,
        "shape": env_shape,
        # the live view after tilt (T = 1606, the plain-load route)
        "launches_tilt": tilt_launches["envelope"],
        "launches_shell": shell_launches["envelope"],
        "launches_multi_device": md_launches["envelope"],
        "launches_pipeline_mesh": pm_launches["envelope"],
        "launches_pipeline_mesh_odd": pm_odd_launches["envelope"],
        "launches_pipeline_mesh_2mod4": pm_2mod4_launches["envelope"],
        "pipeline_mesh_2mod4_blocks": {w: dict(n=v["n"], t=v["t"], ms=v["envelope_ms"],
                                               bound_ms=v["envelope_bound_ms"],
                                               route=v["envelope_route"])
                                       for w, v in pm_2mod4_blocks.items()},
        "multi_device_block": {w: dict(n=v["n"], ms=v["envelope_ms"],
                                       bound_ms=v["envelope_bound_ms"])
                               for w, v in md_block.items()},
        "tilt": tilt_envelope,
    }, {
        "name": "rl2d",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/rl2d_cluster.cu",
        "replaces": _RL2D_REPLACES,
        # no production path: one run through richardson_lucy_direct, on the
        # cluster route (one launch per checkpoint group)
        "launches": rl2d_launches,
        "kernel_route": rl2d_route,
        "cluster_size": rl2d_s,
        "max_abs_err": rl2d_err,
        "max_rel_err": rl2d_rel,
        "ms": statistics.median(rl2d_ms),
        "ms_runs": rl2d_ms,
        # the tiled route (csrc/rl2d.cu, two launches an iteration), in turns
        "ms_previous_design": statistics.median(rl2d_tiled_ms),
        "previous_design": "thz_image_explorer_tpu_torch/csrc/rl2d.cu (the tiled route)",
        "plain_ms": rl2d_plain_ms,
        "bound_ms": rl2d_bound,
        "bound_by": rl2d_bound_by,
        "critical_path_ms": rl2d_floor,
        "cluster_max_taps": rl2d.CLUSTER_MAX_TAPS,
        "launches_shell": shell_launches["rl2d"],
        # no single PyTorch call runs the Richardson-Lucy recurrence
        "library_ms": None,
        "shape": rl2d_shape + [9, 9],
        "n_iter": n0,
    }, {
        "name": "polar",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/polar.cu",
        "replaces": "none: the JAX package's amplitude, angle and unwrap in XLA",
        "launches": main_polar_launches,
        "ms": polar_cases["512x512_T1024"]["kernel_ms"],
        "plain_ms": polar_cases["512x512_T1024"]["plain_ms"],
        "bound_ms": polar_cases["512x512_T1024"]["bound_ms"],
        "bound_by": "bytes",
        "issue_floor_ms": polar_cases["512x512_T1024"]["issue_floor_ms"],
        "kernels_per_call": 1,
        "library_ms": None,
        "shape": [512 * 512, 513],
        "tilt": {k: polar_cases[k]["kernel_ms"] for k in ("512x512_T1620", "512x512_T1648")},
        "launches_tilt": tilt_launches["polar"],
        "launches_shell": shell_launches["polar"],
    }, {
        "name": "rlsep_grouped",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/rlsep_cluster.cu",
        "replaces": _RLSEP_GROUPED_REPLACES,
        # no production path: one run through rl_bands_separable_grouped at
        # group 5 (one launch per checkpoint group)
        "launches": grouped_launches,
        "kernel_route": "grouped cluster",
        "cluster_size": s_group5,
        "max_abs_err": 0.0,
        "ms": grouped_ms,
        "ms_previous_design": None,
        "previous_design_missing": _GROUPED_PREVIOUS_DESIGN,
        "us_per_band_iteration": us_per_band_iteration,
        "plain_ms": rl_plain_ms,
        "bound_ms": rl_bound,
        "bound_by": rl_bound_by,
        "critical_path_ms": grouped_floor,
        "critical_path_operations": grouped_floor_ops,
        "library_ms": None,
        "shape": rl_shape,
        "group": 5,
        "launches_shell": shell_launches["rlsep_grouped"],
    }]}), flush=True)
    print(smi, flush=True)
    # 11. the last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
