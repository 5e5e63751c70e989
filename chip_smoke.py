#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds every hand-written kernel of the port from ``thz_image_explorer_tpu_
torch/csrc`` with nvcc, holds each against its plain PyTorch version on the
card, then drives the main path through the ``Explorer`` facade at the
README's reference scan size (200x200x1024): open, filter chain, ROI set,
slider updates and pixel clicks; then the 3-D voxel view of that scan as
the web view serves it (the live top-k view and one dense extraction); then
the deconvolution Apply path on the same scan with a synthetic asymmetric
PSF (25 bands, 500 iterations: one cluster-kernel launch per progress
checkpoint), followed by slider steps and clicks that must not rerun it and
a 3-D view of the deconvolved scan; both separable Richardson-Lucy routes
(the cluster kernel and the half-iteration kernel), both routes of the
general 2-D kernel (the cluster kernel and the tiled one) and the grouped
cluster kernel on the Apply's own inputs and ragged ones; then the
same commands, the 3-D view and SaveVTU on a small scan on the card and on
the CPU; then tilt compensation on the reference scan (tilts of 2 and 3
degrees: T = 1488 and 1606, slider steps, clicks and tilt steps, a live
view on the envelope's plain-load route, an Apply after tilt, the kernels
at the new F and T, card vs CPU on a small tilted scan); the PSF tool on
knife-edge traces of the reference fixture's shape (300 x 1001, 20 bands),
its PSF exported, loaded and applied; a reference pulse loaded as the
optical reference, and skipped once a tilt changes the bin count; the
web/CLI shell on the reference scan (``shell``: the worker with its
coalescing FIFO, the two-phase open's preview, an HTTP server on loopback
answering a 100-event slider drag, state polls, clicks, 3-D views, a web
Apply and an aborted one, the web state against a direct Explorer, a small
scan card vs CPU through two WebApps, and ``psf-diagnostics`` in a
subprocess); and finally a 512x512x1024 scan with one live 3-D view. Each
of the tilt, PSF tool, open_ref and shell paths is driven with every
kernel's launch count set to 0 just before it and read just after. Each
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
    from thz_image_explorer_tpu_torch.ops import specred as sr

    lib = sr._library()
    assert sr.library_config(lib) == dict(rows=sr.ROWS, stages=sr.STAGES,
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
    and the half-iteration kernel never (the canvas fits a cluster).
    Returns (measurements, band geometry, the deconvolution's input at the
    first Apply)."""
    import torch

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
    geometry = p.filters["deconvolution"]._plan_cache[1]
    expected = len(launch_schedule(geometry.n_iter))
    out = dict(apply_ms=apply_ms, stage_ms=p.timings_ms["deconvolution"],
               rl_launches=apply_launches, rl_launches_expected=expected,
               rl_tiled_launches=tiled_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    assert apply_launches == expected > 0, (apply_launches, expected)
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
    tiled_before = rl.launches_tiled
    again, again_stage = [], []
    for _ in range(n_again):
        again.append(run(lambda: ex.update_filter("deconvolution", force=True)))
        again_stage.append(p.timings_ms["deconvolution"])
    assert all(n == apply_launches for _ms, n in again) and rl.launches_tiled == tiled_before, \
        (again, apply_launches)
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


@contextlib.contextmanager
def _patched(module, name, value):
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


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
    from thz_image_explorer_tpu_torch.ops import envelope as env

    lib = env._library()
    assert env.library_config(lib) == dict(warps=env.WARPS, stages=env.STAGES, run=env.RUN,
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
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import rl2d, rlsep
    from thz_image_explorer_tpu_torch.ops import specred as sr

    sr.spectral_reduction_sums.launches = 0
    env.envelope.launches = 0
    rlsep.rl_bands_separable.launches = 0
    rlsep.rl_bands_separable.launches_tiled = 0
    rlsep.rl_bands_separable_grouped.launches = 0
    rl2d.richardson_lucy_direct.launches = 0
    rl2d.richardson_lucy_direct.launches_tiled = 0


def read_counts():
    from thz_image_explorer_tpu_torch.ops import envelope as env
    from thz_image_explorer_tpu_torch.ops import rl2d, rlsep
    from thz_image_explorer_tpu_torch.ops import specred as sr

    return dict(specred=sr.spectral_reduction_sums.launches,
                envelope=env.envelope.launches,
                rlsep_cluster=rlsep.rl_bands_separable.launches,
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
    view and an Apply after tilt (then one more). Returns (per-tilt
    measurements, the spectra and the view's traces for the kernel checks,
    the Apply's measurements)."""
    import torch

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
    first_ms, first_rl = command_ms(lambda: ex.update_filter(DEC, force=True), rl_count)
    again = [command_ms(lambda: ex.update_filter(DEC, force=True), rl_count) for _ in range(5)]
    geometry = p.filters[DEC]._plan_cache[1]
    expected = len(rlsep.launch_schedule(geometry.n_iter))
    assert first_rl == expected > 0 and all(n == expected for _m, n in again), (first_rl, again)
    assert np.isfinite(ex.image).all() and ex.plot.filtered_time.shape == (p.output.n_time,)
    apply = dict(T=p.output.n_time, first_apply_ms=first_ms,
                 apply_again_ms=statistics.median(m for m, _ in again),
                 apply_again_ms_runs=[m for m, _ in again], stage_ms=p.timings_ms[DEC],
                 rl_launches_per_apply=first_rl, rl_launches_expected=expected,
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
        # 1-2. the worker on the card; the open's preview, then its final
        app = WebApp(worker, load_settings=False)
        zero_counts()
        t0 = time.perf_counter()
        worker.send("open_arrays", t, cube, scan_metadata(0.5))
        # the poll's closure queues behind the open and ahead of the device
        # phase the open defers at the end of its host phase
        preview = app.state()
        rec["preview_ms"] = (time.perf_counter() - t0) * 1e3
        assert preview["preview"] and preview["image"], "the first state carried no preview"
        assert preview["image_shape"] == [width, height] and len(preview["plots"]["signal"])
        assert not preview["plots"]["filtered_signal_fft"], "the preview has device results"
        while time.perf_counter() - t0 < _SHELL_WAIT_S:
            s = app.state()
            if not s["preview"] and not s.get("stale"):
                rec["final_ms"] = (time.perf_counter() - t0) * 1e3
                break
        assert "final_ms" in rec and len(s["plots"]["filtered_signal_fft"]) == len(t) // 2 + 1

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import deconvolution as dec
    from thz_image_explorer_tpu_torch.ops import envelope as env
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

    # 4. the main path at 200x200x1024 through the Explorer
    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    ex = Explorer(device="cuda")
    tmp = tempfile.TemporaryDirectory()

    def open_scan():
        ex.open_arrays(t, cube, scan_metadata(0.5))
        if have_h5py:
            path = f"{tmp.name}/scan.thzimg"
            ex.save_file(path)
            ex.open_file(path)

    hdf5 = ("round trip through save_file + open_file" if have_h5py
            else "not run: h5py is not installed; opened with open_arrays")
    sr.spectral_reduction_sums.launches = 0
    slider_ms, click_ms, slider_launch, click_launch = drive_commands(
        ex, open_scan, cube, 10, 20, np.random.default_rng(args.seed)
    )
    tmp.cleanup()
    main_launches = sr.spectral_reduction_sums.launches
    check_published(ex, width, height, n_time)
    assert all(k == 1 for k in slider_launch), slider_launch
    assert all(k == 0 for k in click_launch), click_launch
    assert main_launches > 0
    emit(phase="main_path", shape=[width, height, n_time], card=smi, hdf5=hdf5,
         rois=4, slider_updates=len(slider_ms), clicks=len(click_ms),
         slider_ms_median=statistics.median(slider_ms), slider_ms=slider_ms,
         click_ms_median=statistics.median(click_ms),
         specred_launches=main_launches,
         launches_per_slider_update=slider_launch[0], launches_per_click=click_launch[0],
         stage_ms=ex.pipeline.timings_ms)
    main_spec = ex.pipeline.slots[ex.pipeline.fft_index].fft.reshape(n, f)
    main_masks = torch.cat([torch.ones((1, n), device=dev),
                            ex._mask_stack.reshape(-1, n)])

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
    rlsep.rl_bands_separable.launches_tiled = 0
    n_again = 5
    apply, geometry, deconv_input = drive_apply(ex, 3, 5, n_again,
                                                np.random.default_rng(args.seed))
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
         specred_launches=sr.spectral_reduction_sums.launches, **apply, geometry=geo)

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
    padded, px, py, n_iter = dec.rl_inputs(deconv_input, geometry)
    del deconv_input
    rl_shape = list(padded.shape)
    kr, kc = px.shape[1], py.shape[1]
    s_apply = rlsep.cluster_size_for(*rl_shape[1:], kr, kc)
    assert s_apply is not None and rlsep.cluster_fits(*rl_shape[1:], kr, kc, 8)
    smem = rlsep._cluster_library().thz_rlsep_cluster_smem
    ragged_inputs = ragged_rl_cases(dev, gen)
    for shape in [rl_shape] + [list(v[0].shape) for v in ragged_inputs.values()]:
        for s in (1, 8, 16):
            if s <= shape[1]:
                args_ = (shape[1], shape[2], kr, kc, s)
                assert smem(*args_) == rlsep.cluster_smem_bytes(*args_), args_
                for g in (1, 2, 5):
                    assert rlsep._cluster_library().thz_rlsep_grouped_smem(*args_, g) == \
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
         launches_per_apply=apply["rl_launches"], card=smi)

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
    lib2 = rl2d._cluster_library()
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
    for kernel in ("specred", "envelope", "rlsep_cluster"):
        assert tilt_launches[kernel] > 0, (kernel, tilt_launches)
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
         specred=tilt_specred, apply=tilt_apply,
         replan="zero spectra expanded from a scalar (no allocation)",
         replan_alloc_ms_avoided=alloc_ms, replan_alloc_bytes_avoided=alloc_bytes,
         cufft_plan_ms=plan_ms,
         small_reference=dict(shape=[24, 20, 128], T=small_t, max_abs_diff=small_worst,
                              tolerance="atol=5e-5, rtol=1e-4, cuda vs cpu port"),
         timing="host ms with a synchronize on each side; kernels: device time behind a "
                "spin (device_ms)")
    del tilt_spectra, tilt_flat, tilt_view
    torch.cuda.empty_cache()

    # 8c. the PSF tool end to end: knife-edge traces of the reference
    # fixture's shape -> compute_psf on the card -> export -> load -> Apply
    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
    from thz_image_explorer_tpu_torch.ops import firapply
    from thz_image_explorer_tpu_torch.psf_tool.app import PsfToolApp, compute_psf
    from thz_image_explorer_tpu_torch.psf_tool.app import FilterParams as PsfFilterParams
    from thz_image_explorer_tpu_torch.psf_tool.data_loader import KnifeEdgeMeasurement
    from thz_image_explorer_tpu_torch.psf_tool.data_loader import split_and_flip

    knife_x = KnifeEdgeMeasurement(*knife_edge_traces(seed=args.seed))
    knife_y = KnifeEdgeMeasurement(*knife_edge_traces(seed=args.seed + 1, width_scale=1.2))
    tilt_ex.set_filter_active(TILT, False)  # the scan's own axis again
    zero_counts()
    psf_res, psf_ms, psf_filter_ms = drive_psf_tool(knife_x, knife_y, dev)
    tool = PsfToolApp(device=dev)
    tool.result = psf_res  # the computed result (the app's thread reads h5py files)
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
    emit(phase="psf_tool", card=smi, knife_edge=[300, 1001], bands=int(psf_res.filters.shape[0]),
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
    emit(phase="scale_kernels", shape=[512, 512, 1024], card=smi,
         specred_ms=sr_ms_512, specred_bound_ms=sr_bound_512, envelope_ms=env_ms_512,
         envelope_bound_ms=env_bound_512,
         timing="device time behind a spin (device_ms)")
    del ex5, cube5, spec5, masks5_512, flat5
    torch.cuda.empty_cache()

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
    }, {
        "name": "rlsep_cluster",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/rlsep_cluster.cu",
        "replaces": _RLSEP_REPLACES,
        # the Apply path's run: six Applies, one launch per checkpoint group
        "launches": apply_launches,
        "launches_per_apply": apply["rl_launches"],
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
        "tool_psf": dict(shape=tool_shape, route=tool_route, max_abs_err=tool_rl_err,
                         ms=tool_rl_ms, plain_ms=tool_rl_plain_ms, bound_ms=tool_rl_bound,
                         bound_by=tool_rl_bound_by),
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
