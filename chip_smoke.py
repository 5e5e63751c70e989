#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds every hand-written kernel of the port from ``thz_image_explorer_tpu_
torch/csrc`` with nvcc, holds each against its plain PyTorch version on the
card, then drives the main path through the ``Explorer`` facade at the
README's reference scan size (200x200x1024): open, filter chain, ROI set,
slider updates and pixel clicks; then the deconvolution Apply path on the
same scan with a synthetic asymmetric PSF (25 bands, 500 iterations),
followed by slider steps and clicks that must not rerun it; then the same
commands on a small scan on the card and on the CPU; and finally a
512x512x1024 scan. Each phase prints one JSON line; the script exits
non-zero as soon as a phase fails, and prints as its last line
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
#: the TPU kernels the port's kernels replace (the Pallas kernel bodies)
_SPECRED_REPLACES = "thz_image_explorer_tpu/ops/pallas_specred.py:124"
_RLSEP_REPLACES = "thz_image_explorer_tpu/ops/pallas_rl.py:140"
#: kernel vs plain Richardson-Lucy, per band: |kernel - plain| <= this *
#: max|plain| (summation order, compounded over up to 500 multiplicative
#: iterations)
_RL_REL_TOL = 1e-3


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


def small_reference_check(seed):
    """The same command sequence on a small scan on the card and on the
    CPU (cuFFT + the kernels vs the CPU FFT + the plain versions): the
    main path, an Apply of the deconvolution (few iterations, before the 2x
    downscale so the scan is still >= 16x16), then the downscale. Every
    published series and the image must agree after the Apply and at the
    end. Returns (worst difference after the Apply, at the end)."""
    from thz_image_explorer_tpu_torch.ops.rlsep import rl_bands_separable as rl
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    t, cube = synthetic_scan(24, 20, 128, seed=seed)
    applied, final = [], []
    for device in ("cuda", "cpu"):
        ex = Explorer(device=device)
        drive_commands(ex, lambda: ex.open_arrays(t, cube, scan_metadata(1.0)), cube, 2, 2,
                       np.random.default_rng(seed))
        ex.set_avg_in_fourier_space(True)
        ex.apply_psf(synthetic_psf())
        for key, value in (("n_filters", 6.0), ("n_iterations", 20.0),
                           ("start_freq", 0.25), ("end_freq", 4.0)):
            ex.set_filter_param("deconvolution", key, value)
        ex.set_filter_active("deconvolution", True)
        before = rl.launches
        ex.update_filter("deconvolution", force=True)
        assert device == "cpu" or rl.launches > before, "the small Apply launched no RL kernel"
        applied.append((ex.plot, ex.image))
        ex.set_downscaling(2)
        final.append((ex.plot, ex.image))
    (g, gi), (c, ci) = applied
    assert not np.allclose(gi, final[0][1]), "the Apply left the image unchanged"
    worst_apply = compare_plots(
        g, gi, c, ci, lambda ref: (1e-3 * float(np.abs(ref).max()), 0.0))
    (g, gi), (c, ci) = final
    worst = compare_plots(g, gi, c, ci, lambda ref: (5e-5, 1e-4))
    return worst_apply, worst


# ---------------------------------------------------------------- Apply
def drive_apply(ex, n_slider, n_clicks, rng):
    """The Apply path as a user drives it, on an open scan: the PSF, the
    deconvolution switched on (no rerun), Apply (the first one plans the
    bands on the host), then slider steps and clicks (the deconvolution is
    suppressed: no RL launch), then Apply again (the plan is cached).
    Returns (measurements, band geometry, the deconvolution's input at the
    first Apply)."""
    import torch

    from thz_image_explorer_tpu_torch.ops.rlsep import rl_bands_separable as rl

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
    apply_launches = rl.launches
    out = dict(apply_ms=apply_ms, stage_ms=p.timings_ms["deconvolution"],
               rl_launches=apply_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    assert apply_launches > 0, "the Apply launched no RL kernel"
    width, height = ex.image.shape
    assert np.isfinite(ex.image).all(), "deconvolved image not finite"
    for key in ("filtered_signal", "avg_signal", "signal_fft", "avg_signal_fft"):
        assert np.isfinite(getattr(ex.plot, key)).all(), f"{key} not finite"
    assert np.abs(ex.image - image_before).max() > 1e-3 * np.abs(image_before).max(), \
        "the Apply left the image unchanged"
    k = p.index_of("deconvolution")
    deconv_input = p.slots[k - 1].data
    geometry = p.filters["deconvolution"]._plan_cache[1]

    def run(cmd):
        before = rl.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cmd()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, rl.launches - before

    slider = [run(lambda i=i: ex.set_fft_window_low(1.3 + 0.05 * i)) for i in range(n_slider)]
    clicks = [run(lambda: ex.set_selected_pixel(int(rng.integers(width)),
                                                int(rng.integers(height))))
              for _ in range(n_clicks)]
    assert all(n == 0 for _ms, n in slider + clicks), (slider, clicks)
    assert p.slots[k] is p.slots[k - 1], "a slider step kept the deconvolved result"
    out.update(slider_ms=[m for m, _ in slider], slider_rl_launches=[n for _, n in slider],
               click_ms=[m for m, _ in clicks], click_rl_launches=[n for _, n in clicks])
    again_ms, again_launches = run(lambda: ex.update_filter("deconvolution", force=True))
    assert again_launches == apply_launches, (again_launches, apply_launches)
    assert np.isfinite(ex.image).all()
    out.update(apply_again_ms=again_ms, apply_again_stage_ms=p.timings_ms["deconvolution"],
               apply_again_rl_launches=again_launches)
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


def check_rl(padded, px, py, n_iter, label):
    """Kernel vs plain on the card: per band |kernel - plain| <=
    _RL_REL_TOL * max|plain|, and two kernel runs bit-identical. Returns
    (max abs error, max per-band relative error)."""
    import torch

    from thz_image_explorer_tpu_torch.ops import rlsep

    got = rlsep.rl_bands_separable(padded, px, py, n_iter)
    again = rlsep.rl_bands_separable(padded, px, py, n_iter)
    ref = rlsep.rl_bands_separable_plain(padded, px, py, n_iter)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two kernel runs differ")
    err = (got - ref).abs().amax(dim=(1, 2))
    scale = ref.abs().amax(dim=(1, 2))
    rel = err / torch.clamp(scale, min=1e-30)
    if bool((err > _RL_REL_TOL * scale).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: per-band err {err.tolist()} vs max {scale.tolist()}")
    return float(err.max()), float(rel.max())


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
    from thz_image_explorer_tpu_torch.ops import rlsep
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

    # 5. the Apply path on the same Explorer: filters and ROIs stay active
    sr.spectral_reduction_sums.launches = 0
    rlsep.rl_bands_separable.launches = 0
    apply, geometry, deconv_input = drive_apply(ex, 3, 5, np.random.default_rng(args.seed))
    apply_launches = rlsep.rl_bands_separable.launches
    assert apply_launches == 2 * apply["rl_launches"] > 0
    geo = geometry_summary(geometry, (width, height))
    emit(phase="apply", shape=[width, height, n_time], card=smi, dx_mm=0.5,
         psf="synthetic: wx=0.70/f+0.50 mm, wy=0.85/f+0.55 mm, x0=0.3 mm, y0=-0.2 mm",
         params="default DeconvolutionParams (25 bands, 500 iterations)",
         specred_launches=sr.spectral_reduction_sums.launches, **apply, geometry=geo)

    # 6. the RL kernel vs its plain version: the Apply's own inputs, then
    # ragged ones
    padded, px, py, n_iter = dec.rl_inputs(deconv_input, geometry)
    del deconv_input
    rl_err, rl_rel = check_rl(padded, px, py, n_iter, "apply geometry")
    ragged = {}
    for label, inputs in ragged_rl_cases(dev, gen).items():
        ragged[label] = check_rl(*inputs, label)
    emit(phase="rl_kernel_vs_plain", main_shape=list(padded.shape),
         main_max_abs_err=rl_err, main_max_rel_err=rl_rel,
         ragged_max_abs_err={k: v[0] for k, v in ragged.items()},
         ragged_max_rel_err={k: v[1] for k, v in ragged.items()},
         deterministic=True,
         tolerance=f"per band |kernel-plain| <= {_RL_REL_TOL} * max|plain|")
    rl_ms = time_ms(lambda: rlsep.rl_bands_separable(padded, px, py, n_iter),
                    reps=5, inner=1, warm=1)
    rl_plain_ms = time_ms(lambda: rlsep.rl_bands_separable_plain(padded, px, py, n_iter),
                          reps=3, inner=1, warm=1)
    rl_bound, rl_bound_by, rl_ops = rl_bound_ms(geometry, (width, height), name)
    rl_shape = list(padded.shape)
    del padded, px, py

    # 7. card vs CPU on a small scan: main path, Apply, downscale
    worst_apply, worst = small_reference_check(args.seed)
    emit(phase="small_reference", shape=[24, 20, 128],
         compared="cuda vs cpu port, every data-derived PlotData series + image, "
                  "after the Apply and at the end",
         tolerance_apply="atol = 1e-3 * max|series|", tolerance="atol=5e-5, rtol=1e-4",
         max_abs_diff_apply=worst_apply, max_abs_diff=worst)

    # 8 (measured here, on the main path's own inputs). kernel vs plain time
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
    emit(phase="scale", shape=[512, 512, 1024], card=smi, open_ms=open_ms,
         slider_ms_median=statistics.median(scale_ms), slider_ms=scale_ms,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del ex5, cube5
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
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [n, f, m],
    }, {
        "name": "rlsep",
        "route": "cuda",
        "source": "thz_image_explorer_tpu_torch/csrc/rlsep.cu",
        "replaces": _RLSEP_REPLACES,
        "launches": apply_launches,
        "max_abs_err": rl_err,
        "max_rel_err": rl_rel,
        "ms": rl_ms,
        "plain_ms": rl_plain_ms,
        "bound_ms": rl_bound,
        "bound_by": rl_bound_by,
        "bound_operations": rl_ops,
        # no single PyTorch call runs the Richardson-Lucy recurrence
        "library_ms": None,
        "shape": rl_shape,
        "n_iter_sum": geo["n_iter_sum"],
    }]}), flush=True)
    print(smi, flush=True)
    # 11. the last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
