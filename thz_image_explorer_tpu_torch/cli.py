"""Command-line application shell.

Port of ``thz_image_explorer_tpu/cli.py``, the headless replacement for
the reference's app shell (``main.rs``): runs the filter chain on scans,
drives the PSF tool and exports results (PNG plots through matplotlib
when it is installed). Every subcommand that computes takes ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain PyTorch versions).

Usage::

    python -m thz_image_explorer_tpu_torch info scan.thzimg
    python -m thz_image_explorer_tpu_torch process scan.thzimg --downscale 2 \\
        --fd-bandpass 0.2 5.0 --water-notch --png out/ --save out.thz
    python -m thz_image_explorer_tpu_torch deconvolve scan.thzimg --psf psf.npz
    python -m thz_image_explorer_tpu_torch psf-fit --x x.thz --y y.thz --out psf.npz
    python -m thz_image_explorer_tpu_torch psf-diagnostics psf.npz
    python -m thz_image_explorer_tpu_torch serve [--device cpu] [scan.thzimg]

Scan files need h5py; ``psf-diagnostics`` and ``serve`` without a scan do
not.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _cmd_info(args):
    from thz_image_explorer_tpu_torch.data import resolve_device
    from thz_image_explorer_tpu_torch.io import dotthz

    host = dotthz.open_scan_host(args.scan)
    cube, img = dotthz.finalize_scan(host, resolve_device(args.device))
    img = img.cpu().numpy()
    md = host.metadata
    print(f"file:      {args.scan}")
    print(f"scan:      {img.shape[0]} x {img.shape[1]} pixels x {cube.n_time} samples")
    print(f"dx/dy:     {cube.dx} / {cube.dy} mm")
    t = host.time
    dt = f" (dt {t[1] - t[0]:.4f})" if len(t) > 1 else ""
    print(f"time:      {t[0]:.2f} .. {t[-1]:.2f} ps{dt}")
    f = cube.freq.cpu().numpy()
    df = f", df {f[1]:.4f}" if len(f) > 1 else ""
    print(f"freq:      0 .. {f[-1]:.2f} THz ({len(f)} bins{df})")
    print(f"intensity: max {img.max():.4g}")
    if md.md:
        print("metadata:")
        for k, v in md.md.items():
            print(f"  {k}: {v}")
    rois = md.get_rois()
    if rois:
        print(f"ROIs: {[name for name, _ in rois]}")
    return 0


def _make_explorer(args):
    from thz_image_explorer_tpu_torch.ops.windows import WindowType
    from thz_image_explorer_tpu_torch.pipeline import Explorer

    ex = Explorer(device=args.device)
    cfg = ex.pipeline.config
    cfg.fft_window = [args.window_low, args.window_high]
    cfg.fft_window_type = WindowType(args.window)
    cfg.scale_factor = args.downscale
    cfg.avg_in_fourier_space = args.avg_in_fourier
    if args.td_bandpass:
        f = ex.pipeline.filters["time_band_pass_before_fft"]
        f.active = True
        f.low, f.high = args.td_bandpass
    if args.fd_bandpass:
        f = ex.pipeline.filters["frequency_band_pass"]
        f.active = True
        f.low, f.high = args.fd_bandpass
    if args.water_notch:
        ex.pipeline.filters["water_vapor_notch"].active = True
    return ex


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default: cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")


def _add_pipeline_args(p):
    p.add_argument("--window", default="adapted_blackman",
                   choices=["adapted_blackman", "blackman", "hanning", "hamming", "flat_top"])
    p.add_argument("--window-low", type=float, default=1.0)
    p.add_argument("--window-high", type=float, default=7.0)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--avg-in-fourier", action="store_true")
    p.add_argument("--td-bandpass", nargs=2, type=float, metavar=("LO", "HI"))
    p.add_argument("--fd-bandpass", nargs=2, type=float, metavar=("LO", "HI"))
    p.add_argument("--water-notch", action="store_true")
    _add_device_arg(p)


def _cmd_process(args):
    from thz_image_explorer_tpu_torch.io.dotthz import save_scan

    ex = _make_explorer(args)
    ex.open_file(args.scan)
    print("stage timings (ms):")
    for name, t in ex.pipeline.timings_ms.items():
        print(f"  {name:30s} {t:8.2f}")
    if args.save:
        # the processed cube; a downscaled one declares the dims and pitch
        # of the data written, which readers index it by (io.rs:496-631)
        md = ex.metadata
        md.ds_description = ["time", "dataset"]
        out = ex.pipeline.output
        md.md["width"] = str(int(out.valid_wh[0]))
        md.md["height"] = str(int(out.valid_wh[1]))
        if out.dx is not None:
            md.md["dx [mm]"] = str(out.dx)
        if out.dy is not None:
            md.md["dy [mm]"] = str(out.dy)
        save_scan(args.save, out, md)
        print(f"saved processed scan -> {args.save}")
    if args.vtu:
        ex.save_vtu(args.vtu)
        print(f"exported voxels -> {args.vtu}")
    if args.png:
        _export_pngs(ex, args.png)
    return 0


def _cmd_deconvolve(args):
    from thz_image_explorer_tpu_torch.io.dotthz import save_scan

    ex = _make_explorer(args)
    ex.open_file(args.scan)
    ex.open_psf(args.psf)
    dec = ex.pipeline.filters["deconvolution"]
    dec.active = True
    dec.params.n_filters = args.n_filters
    dec.params.n_iterations = args.iterations
    dec.params.start_freq = args.start_freq
    dec.params.end_freq = args.end_freq
    ex.update_filter("deconvolution", force=True)
    t_dec = ex.pipeline.timings_ms.get("deconvolution")
    if t_dec is None:
        # the stage passes the cube through (and logs why) when dx/dy, a
        # loadable PSF or a 16x16 image is missing
        print("deconvolution did not run — check dx/dy metadata, the PSF "
              "file and the image size (>=16x16); see the log above")
        return 1
    print(f"deconvolution: {t_dec:.1f} ms")
    if args.save:
        md = ex.metadata
        md.ds_description = ["time", "dataset"]
        save_scan(args.save, ex.pipeline.output, md)
        print(f"saved deconvolved cube -> {args.save}")
    if args.png:
        _export_pngs(ex, args.png)
    return 0


def _export_pngs(ex, directory):
    os.makedirs(directory, exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; writing raw .npy instead")
        np.save(os.path.join(directory, "intensity.npy"), ex.image)
        return

    from thz_image_explorer_tpu_torch.viz import fft_plot_series, intensity_image_rgba

    plt.figure(figsize=(6, 5))
    plt.imshow(intensity_image_rgba(ex.image))
    plt.title("Intensity")
    plt.savefig(os.path.join(directory, "intensity.png"), dpi=120)
    plt.close()

    plot = ex.plot
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6))
    ax1.plot(plot.time, plot.signal, label="signal")
    ax1.plot(plot.filtered_time, plot.filtered_signal, label="filtered")
    ax1.set_xlabel("time [ps]")
    ax1.legend()
    ax2.plot(plot.frequencies, fft_plot_series(plot.signal_fft), label="raw")
    ax2.plot(plot.filtered_frequencies,
             fft_plot_series(plot.filtered_signal_fft, plot.signal_fft), label="filtered")
    ax2.set_xlabel("frequency [THz]")
    ax2.set_ylabel("dB")
    ax2.legend()
    fig.savefig(os.path.join(directory, "pulse.png"), dpi=120)
    plt.close(fig)
    print(f"wrote plots -> {directory}/")


def _cmd_psf_fit(args):
    from thz_image_explorer_tpu_torch.io.psf_npz import save_psf
    from thz_image_explorer_tpu_torch.psf_tool import (
        BeamFitParams,
        FilterParams,
        KnifeEdgeMeasurement,
    )
    from thz_image_explorer_tpu_torch.psf_tool.app import compute_psf

    if not args.x and not args.y:
        print("error: at least one of --x / --y is required", file=sys.stderr)
        return 2
    x = KnifeEdgeMeasurement.from_thz_file(args.x) if args.x else None
    y = KnifeEdgeMeasurement.from_thz_file(args.y) if args.y else None
    params = FilterParams(n_filters=args.n_filters, start_freq=args.start_freq,
                          end_freq=args.end_freq, win_width=args.win_width,
                          low_cut=args.low_cut, high_cut=args.high_cut)

    def progress(axis, cur, total):
        print(f"\r  fitting {axis}: {cur}/{total}", end="", flush=True)
        return True

    res = compute_psf(x, y, params, BeamFitParams(w_max=args.w_max), progress, args.device)
    print()
    if res is None or res.curve_fits is None:
        print("PSF fit failed")
        return 1
    for i, fc in enumerate(res.center_frequencies):
        wx = abs(res.x.beam_fits.popt_xs[i, 1]) if res.x else float("nan")
        wy = abs(res.y.beam_fits.popt_ys[i, 1]) if res.y else float("nan")
        print(f"  {fc:6.3f} THz: wx = {wx:6.3f} mm, wy = {wy:6.3f} mm")
    for w in res.warnings:
        print(f"WARNING: {w}")
    save_psf(args.out, res.curve_fits.to_runtime_psf())
    print(f"exported PSF -> {args.out}")
    return 0


def _cmd_serve(args):
    from thz_image_explorer_tpu_torch.web import serve

    serve(port=args.port, scan=args.scan, precompile=args.precompile, device=args.device)
    return 0


def _cmd_psf_diagnostics(args):
    from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
    from thz_image_explorer_tpu_torch.psf_tool import DiagnosticResults

    psf = load_psf(args.psf)
    freqs = 0.1 + np.arange(200) / 199.0 * 9.9
    w0x = psf.wx_fit.eval(freqs.astype(np.float32)).astype(np.float64)
    w0y = psf.wy_fit.eval(freqs.astype(np.float32)).astype(np.float64)
    # the diagnostics view's monotone-decreasing clip
    np.minimum.accumulate(w0x, out=w0x)
    np.minimum.accumulate(w0y, out=w0y)
    print(DiagnosticResults.compute(freqs, w0x, w0y).summary())
    return 0


def _cmd_update(args):
    """Self-update (``update.rs``): version check, optional install."""
    from thz_image_explorer_tpu_torch import __version__
    from thz_image_explorer_tpu_torch.utils.update import (
        fetch_release_tarball_url,
        install_update,
        is_newer,
        latest_release,
    )

    latest = latest_release()
    if latest is None:
        print(f"current v{__version__}; latest release: unknown "
              "(release server unreachable)")
        return 0
    try:
        newer = is_newer(latest, __version__)
    except ValueError:
        print(f"current v{__version__}; latest release {latest!r} is not a version")
        return 0
    if not newer:
        print(f"up to date (v{__version__}; latest release {latest})")
        return 0
    print(f"update available: {latest} (current v{__version__})")
    if not args.install:
        print("re-run with --install to apply it")
        return 0
    rel = fetch_release_tarball_url()
    if rel is None:
        print("could not fetch the release tarball URL")
        return 1
    if rel[0] != latest:
        # the latest release changed between the check and the fetch:
        # never install a version that was not compared
        print(f"release changed on the server (expected {latest}, now {rel[0]}); "
              "re-run the update check")
        return 1
    path = install_update(rel[1])
    print(f"installed {rel[0]} into {path}; previous version kept as .bak")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="thz_image_explorer_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="inspect a dotTHz scan")
    p.add_argument("scan")
    _add_device_arg(p)
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser("process", help="run the filter pipeline on a scan")
    p.add_argument("scan")
    _add_pipeline_args(p)
    p.add_argument("--save", help="write processed scan (.thz)")
    p.add_argument("--vtu", help="export 3-D voxels (.vtu)")
    p.add_argument("--png", help="write plot PNGs to a directory")
    p.set_defaults(fn=_cmd_process)

    p = sub.add_parser("deconvolve", help="run PSF deconvolution on a scan")
    p.add_argument("scan")
    p.add_argument("--psf", required=True, help="PSF .npz")
    _add_pipeline_args(p)
    p.add_argument("--n-filters", type=int, default=25)
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--start-freq", type=float, default=0.1)
    p.add_argument("--end-freq", type=float, default=10.0)
    p.add_argument("--save")
    p.add_argument("--png")
    p.set_defaults(fn=_cmd_deconvolve)

    p = sub.add_parser("psf-fit", help="fit a PSF from knife-edge scans")
    p.add_argument("--x", help="knife-edge measurement along x (.thz)")
    p.add_argument("--y", help="knife-edge measurement along y (.thz)")
    p.add_argument("--out", required=True, help="output .npz")
    p.add_argument("--n-filters", type=int, default=20)
    p.add_argument("--start-freq", type=float, default=0.15)
    p.add_argument("--end-freq", type=float, default=5.0)
    p.add_argument("--win-width", type=float, default=0.5)
    p.add_argument("--low-cut", type=float, default=0.1)
    p.add_argument("--high-cut", type=float, default=10.0)
    p.add_argument("--w-max", type=float, default=30.0)
    _add_device_arg(p)
    p.set_defaults(fn=_cmd_psf_fit)

    p = sub.add_parser("psf-diagnostics", help="Gaussian-beam diagnostics")
    p.add_argument("psf", help="PSF .npz")
    p.set_defaults(fn=_cmd_psf_diagnostics)

    p = sub.add_parser("serve", help="interactive web frontend")
    p.add_argument("scan", nargs="?", default=None)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--precompile", action=argparse.BooleanOptionalAction, default=True,
                   help="build the CUDA kernels from csrc/ before the first command "
                        "(default on; the state shows the 'building' phase meanwhile; "
                        "nothing to build with --device cpu)")
    _add_device_arg(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("update", help="check for (and install) a newer release")
    p.add_argument("--install", action="store_true",
                   help="download and install the newer release in place "
                        "(keeps a .bak of the current package)")
    p.set_defaults(fn=_cmd_update)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
