#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds every hand-written kernel of the port from ``thz_image_explorer_tpu_
torch/csrc`` with nvcc, holds each against its plain PyTorch version on the
card, then drives the main path through the ``Explorer`` facade at the
README's reference scan size (200x200x1024): open, filter chain, ROI set,
slider updates and pixel clicks, and finally a 512x512x1024 scan. Each
phase prints one JSON line; the script exits non-zero as soon as a phase
fails, and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

It needs a CUDA device and the package beside it; it imports nothing of
JAX. Numbers it prints are taken on the card it runs on, whose name and
power limit it prints first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

#: device-memory bandwidth (bytes/s) by card, for the kernels' bounds
#: (NVIDIA data sheets: H100 SXM HBM3, H100 PCIe HBM2e, H200 SXM HBM3e)
_MEMORY_RATE = (("H200", 4.8e12), ("HBM3", 3.35e12), ("PCIe", 2.0e12), ("H100", 3.35e12))
#: f32 peak outside the tensor cores (H100 SXM data sheet)
_F32_PEAK = 67e12
#: the TPU kernel this port's kernel replaces (function ``_kernel``)
_SPECRED_REPLACES = "thz_image_explorer_tpu/ops/pallas_specred.py:124"


def emit(**obj):
    print(json.dumps(obj), flush=True)


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


def memory_rate(name: str) -> float:
    for key, rate in _MEMORY_RATE:
        if key in name:
            return rate
    raise SystemExit(f"no memory bandwidth known for {name!r}")


def time_ms(fn, reps=21, inner=10):
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
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


def phase_kernel_checks(pulse_spec, masks5, gen):
    import torch

    dev = pulse_spec.device
    n, f = pulse_spec.shape
    rand_spec = torch.randn((n, f), dtype=torch.complex64, device=dev, generator=gen)
    main = {}
    for spec_name, spec in (("pulse", pulse_spec), ("random", rand_spec)):
        for wc in (False, True):
            main[(spec_name, wc)] = check_specred(spec, masks5, wc, f"{spec_name} wc={wc}")
    ragged = []
    # ragged F; N not a multiple of any chunk; M = 1, 16, and 21 masks
    # (two launches: 16 + 5)
    for nn, ff, mm in ((1009, 33, 1), (4099, 129, 16), (2053, 1025, 3), (3001, 513, 21)):
        spec = torch.randn((nn, ff), dtype=torch.complex64, device=dev, generator=gen)
        m = (torch.rand((mm, nn), device=dev, generator=gen) > 0.5).float()
        for wc in (False, True):
            check_specred(spec, m, wc, f"n={nn} f={ff} m={mm} wc={wc}")
        ragged.append([nn, ff, mm])
    emit(
        phase="kernel_vs_plain",
        main_shape=[n, f, int(masks5.shape[0])],
        max_abs_err={f"{k[0]}/wc={k[1]}": v[0] for k, v in main.items()},
        max_rel_err={f"{k[0]}/wc={k[1]}": v[1] for k, v in main.items()},
        ragged_shapes=ragged,
        deterministic=True,
        tolerance="per column |kernel-plain| <= 1e-5*sum|terms| + 1e-6",
    )
    return main[("pulse", False)]


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


def small_reference_check(seed):
    """The same command sequence on a small scan on the card and on the
    CPU (cuFFT + the kernel vs the CPU FFT + the plain reduction); every
    published series and the image must agree."""
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    t, cube = synthetic_scan(24, 20, 128, seed=seed)
    plots = []
    for device in ("cuda", "cpu"):
        ex = Explorer(device=device)
        drive_commands(ex, lambda: ex.open_arrays(t, cube), cube, 2, 2,
                       np.random.default_rng(seed))
        ex.set_avg_in_fourier_space(True)
        ex.set_downscaling(2)
        plots.append((ex.plot, ex.image))
    (g, gi), (c, ci) = plots
    worst = 0.0
    for key in ("signal", "signal_fft", "phase_fft", "filtered_signal",
                "filtered_signal_fft", "filtered_phase_fft", "avg_signal",
                "avg_signal_fft", "avg_phase_fft"):
        np.testing.assert_allclose(getattr(g, key), getattr(c, key),
                                   atol=5e-5, rtol=1e-4, err_msg=key)
        worst = max(worst, float(np.abs(getattr(g, key) - getattr(c, key)).max()))
    for key in ("roi_signal", "roi_signal_fft", "roi_phase"):
        for uuid in getattr(c, key):
            np.testing.assert_allclose(getattr(g, key)[uuid][1], getattr(c, key)[uuid][1],
                                       atol=5e-5, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(gi, ci, atol=5e-5, rtol=1e-4, err_msg="image")
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from thz_image_explorer_tpu_torch import kernels
    from thz_image_explorer_tpu_torch.ops import specred as sr
    from thz_image_explorer_tpu_torch.pipeline import Explorer

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
        ex.open_arrays(t, cube)
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
    worst = small_reference_check(args.seed)
    emit(phase="small_reference", shape=[24, 20, 128],
         compared="cuda vs cpu port, every PlotData series + image",
         tolerance="atol=5e-5, rtol=1e-4", max_abs_diff=worst)

    # 6 (measured here, on the main path's own inputs). kernel vs plain time
    kernel_ms = time_ms(lambda: sr.spectral_reduction_sums(main_spec, main_masks, False))
    plain_ms = time_ms(lambda: sr.spectral_reduction_sums_plain(main_spec, main_masks, False))
    m = int(main_masks.shape[0])
    n_bytes = n * f * 8 + m * n * 4 + 2 * m * f * 4
    # amp: 2 mul + add + sqrt; angle: atan2 + wrapped diff; 2 outputs x m
    # masks x one FMA (2 operations)
    n_ops = n * f * (4 + 2 + 2 * 2 * m)
    bytes_ms = n_bytes / memory_rate(name) * 1e3
    ops_ms = n_ops / _F32_PEAK * 1e3
    del ex, main_spec, main_masks, pulse_spec, masks5, roi_masks
    torch.cuda.empty_cache()

    # 5. scale: the README's larger scan, 512x512x1024 (a 1 GiB cube)
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
    emit(phase="scale", shape=[512, 512, 1024], card=smi, open_ms=open_ms,
         slider_ms_median=statistics.median(scale_ms), slider_ms=scale_ms,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del ex5, cube5
    torch.cuda.empty_cache()

    # 6. the kernels line
    print(json.dumps({"kernels": [{
        "name": "specred",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/specred.cu",
        "replaces": _SPECRED_REPLACES,
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "max_rel_err": max_rel_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [n, f, m],
    }]}), flush=True)
    print(smi, flush=True)
    # 7. the last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
