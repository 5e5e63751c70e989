"""Interactive web frontend.

Port of ``thz_image_explorer_tpu/web.py``, the GUI replacement for the
reference's desktop shell (``gui/``): a dependency-free HTTP server driving
an :class:`~thz_image_explorer_tpu_torch.pipeline.worker.ExplorerWorker`.
The page shows the intensity image (click = pixel select, shift-click = ROI
polygon vertices with the reference's close-within-5% rule,
``matrix_plot.rs:569-637``), pulse and FFT plots with water-line overlays
and DR/ptp readouts (``center_panel.rs``), filter toggles and parameter
sliders, the optical-property plots, the 3-D view and the PSF tool's page.
Every command goes through the worker's coalescing queue; every read runs
on the worker thread.

Run: ``python -m thz_image_explorer_tpu_torch serve [--port 8080]
[--device cuda|cpu] [scan.thzimg]``
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import math
import os
import struct
import tempfile
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from thz_image_explorer_tpu_torch.assets.water_lines import WATER_LINES_THZ
from thz_image_explorer_tpu_torch.ops.windows import WindowType, window_array
from thz_image_explorer_tpu_torch.pipeline.worker import ExplorerWorker
from thz_image_explorer_tpu_torch.utils.logbuffer import install_log_buffer
from thz_image_explorer_tpu_torch.viz import (
    dynamic_range_db,
    fft_plot_series,
    intensity_image_rgba,
    peak_to_peak,
)
from thz_image_explorer_tpu_torch.viz.colormap import colorbar_rgba

log = logging.getLogger(__name__)


def encode_png(rgba: np.ndarray) -> bytes:
    """Minimal PNG encoder (RGBA8): no imaging dependency needed."""
    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[i].astype(np.uint8).tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _series(arr, limit=2048):
    a = np.asarray(arr, np.float64)
    if len(a) > limit:
        step = int(np.ceil(len(a) / limit))
        a = a[::step]
    return [None if not np.isfinite(v) else round(float(v), 6) for v in a]


def _finite(v, ndigits=None, default=None):
    """A NaN/Inf scalar becomes ``default``: a bare ``NaN`` token is invalid
    JSON and one of them freezes the polling page (``JSON.parse`` rejects
    the whole response). Non-numbers pass through."""
    if isinstance(v, bool):
        return v
    try:
        f = float(v)
    except (TypeError, ValueError):
        return v
    if not math.isfinite(f):
        return default
    return round(f, ndigits) if ndigits is not None else v


def _nan2null(obj):
    """``obj`` with non-finite floats nulled: the slow-path backstop behind
    the handler's ``allow_nan=False`` fast path."""
    if isinstance(obj, dict):
        return {k: _nan2null(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_nan2null(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


class WebApp:
    """The page's state and commands over one worker.

    ``WebApp(worker=None, *, device=None, load_settings=False)`` builds a
    worker (and its Explorer) on ``device``, None meaning the card, unless
    one is given; ``load_settings`` applies the persisted preferences."""

    def __init__(self, worker: Optional[ExplorerWorker] = None, *, device=None,
                 load_settings: bool = False):
        self.worker = worker if worker is not None else ExplorerWorker(device=device)
        self.device = self.worker.explorer.device
        self._lock = threading.Lock()
        # colorbar / display state (matrix_plot.rs:68-314): clipping
        # percentages, draggable midpoint, BW toggle
        self.view = {"cut_low": 0.0, "cut_high": 100.0, "midpoint": 50.0, "bw": False}
        self.logbuf = install_log_buffer()
        self._png_cache = None
        self._cbar_cache = None
        self._window_shape_cache = None
        self._drop_dir = None
        # a real empty-state build, so a poll during a long first open
        # falls back to a complete skeleton
        try:
            self._snapshot = self.worker.call(self._build_state, timeout=5)
        except Exception:  # noqa: BLE001 - the worker is already busy
            self._snapshot = None
        # right after an open's host phase a fresh snapshot is taken on the
        # worker thread, so polls that time out behind the device phase are
        # served the preview (data_thread.rs:1242-1316)
        self.worker.on_update(self._capture_preview_snapshot)
        if load_settings:
            # the reference restores its settings, the serialized PSF
            # included, before the first frame (main.rs:144-161)
            from thz_image_explorer_tpu_torch.utils.settings import Settings

            self.worker.send("apply_settings", Settings.load())

    def _capture_preview_snapshot(self, ex):
        if ex.preview_pending:
            snap = self._build_state(ex)
            with self._lock:
                self._snapshot = snap

    def save_settings(self):
        """Exit autosave (``main.rs:116-126``)."""
        try:
            self.worker.call(lambda ex: ex.collect_settings(), timeout=10).save()
        except Exception:  # noqa: BLE001 - never block shutdown on this
            log.warning("settings not saved", exc_info=True)

    # ------------------------------------------------------------- state
    def state(self) -> dict:
        """State for the page's poll, built on the worker thread (request
        threads never read the Explorer: ``config.rs:219-304``). When the
        worker is busy for longer than the poll's wait (an Apply), the last
        snapshot is served with ``busy`` and ``stale`` set, as the
        reference GUI's ``try_read`` skips a frame (``center_panel.rs:32``)."""
        try:
            snap = self.worker.call(self._build_state, timeout=2.0)
            with self._lock:
                self._snapshot = snap
            return snap
        except Exception as e:  # noqa: BLE001 - any failure serves the snapshot
            if not isinstance(e, TimeoutError):
                log.warning("state build failed, serving last snapshot: %s", e)
            with self._lock:
                snap = dict(self._snapshot) if self._snapshot else {
                    # every key the page reads unguarded
                    "file": None, "image": None, "image_shape": [0, 0],
                    "colorbar": None, "filters": {}, "rois": {}, "plots": {},
                    "log": [], "phase": None, "preview": False,
                    "siblings": [], "sibling_paths": [],
                    "metadata": {"fields": {}, "md": {}}, "view": dict(self.view),
                }
            snap["busy"] = True
            snap["stale"] = True
            # readable while the worker is blocked: single attribute reads
            snap["phase"] = self.worker.explorer.pipeline.phase
            snap["preview"] = bool(self.worker.explorer.preview_pending)
            return snap

    def _image_png(self, image) -> str:
        """The colormapped image as base64 PNG, cached on (image identity,
        view): the poll mostly re-requests an unchanged image, and the
        Explorer replaces ``image`` on every update."""
        vkey = (self.view["cut_low"], self.view["cut_high"],
                self.view["midpoint"], self.view["bw"])
        cached = self._png_cache
        if cached is not None and cached[0] is image and cached[1] == vkey:
            return cached[2]
        rgba = intensity_image_rgba(image, cut_off=(vkey[0], vkey[1]),
                                    midpoint=vkey[2], bw=vkey[3])
        b64 = base64.b64encode(encode_png(rgba)).decode()
        self._png_cache = (image, vkey, b64)
        return b64

    def _colorbar_png(self) -> str:
        """The colorbar gradient (``matrix_plot.rs:149-179``), rendered on
        the server so bar and image colormap cannot drift; cached."""
        ckey = (self.view["midpoint"], self.view["bw"])
        if self._cbar_cache is None or self._cbar_cache[0] != ckey:
            png = encode_png(colorbar_rgba(100, ckey[0], ckey[1]))
            self._cbar_cache = (ckey, base64.b64encode(png).decode())
        return self._cbar_cache[1]

    def _build_state(self, ex) -> dict:
        plot = ex.plot
        pipeline = ex.pipeline
        log_plot = pipeline.config.fft_log_plot
        image_b64, img_shape = None, (0, 0)
        if ex.image is not None and ex.image.size:
            image_b64 = self._image_png(ex.image)
            img_shape = ex.image.shape
        timings = pipeline.timings_ms

        filters = {}
        for uuid, f in pipeline.filters.items():
            cfg = f.config()
            params = {k: v for k, v in vars(f).items()
                      if isinstance(v, (int, float, bool)) and not k.startswith("_")}
            if hasattr(f, "params"):  # the deconvolution's dataclass
                params.update(dataclasses.asdict(f.params))
            filters[uuid] = {
                "name": cfg.name,
                "description": cfg.description,
                "domain": int(cfg.domain),
                "hyperlink": cfg.hyperlink,
                "active": f.active,
                "params": params,
                "time_ms": round(timings.get(uuid, 0.0), 2),
                # every stage is timed exactly by its own events: never stale
                "time_stale": False,
                "progress": pipeline.progress.get(uuid),
            }

        return {
            "file": ex.file_path,
            "image": image_b64,
            "image_shape": list(img_shape),
            "colorbar": self._colorbar_png(),
            "pixel": ex.pixel_selected,
            # built on the worker thread: "busy" = commands queued behind
            # this snapshot (a long command in flight is state()'s fallback)
            "busy": not self.worker.queue.empty(),
            "phase": pipeline.phase,
            # the served image and trace are the host preview until the
            # open's device phase has published
            "preview": bool(ex.preview_pending),
            "config": {
                "fft_window": pipeline.config.fft_window,
                "fft_window_type": pipeline.config.fft_window_type.value,
                "scale_factor": pipeline.config.scale_factor,
                "fft_log_plot": log_plot,
                "avg_in_fourier_space": pipeline.config.avg_in_fourier_space,
            },
            "timings_ms": {k: round(v, 2) for k, v in timings.items()},
            "housekeeping": {k: _finite(v) for k, v in vars(ex.housekeeping).items()},
            "view": dict(self.view),
            "metadata": {
                "fields": {
                    k: getattr(ex.metadata, k)
                    for k in ("user", "email", "orcid", "institution", "description",
                              "version", "mode", "instrument", "time", "date")
                },
                "md": dict(ex.metadata.md),
            },
            # one listing for both keys, so names and paths cannot shift
            "sibling_paths": (sib := list(ex.sibling_files())),
            "siblings": [os.path.basename(s) for s in sib],
            "log": self.logbuf.tail(40),
            "last_warning": self.logbuf.last_warning,
            "filters": filters,
            "rois": {u: {"name": n, "polygon": p} for u, (n, p) in ex.rois.items()},
            "readouts": {
                # DR against the displayed series' maximum (center_panel.rs:335)
                "dr_db": _finite(dynamic_range_db(plot.signal_fft, log_plot), 1, 0.0),
                "ptp": _finite(peak_to_peak(plot.signal), 2, 0.0),
            },
            "selection": {
                "reference": ex.reference_selection,
                "sample": ex.sample_selection,
                "thickness": ex.sample_thickness,
                "available_references": plot.available_references,
                "available_samples": plot.available_samples,
            },
            "plots": {
                "window_shape": self._window_shape(ex),
                "time": _series(plot.time),
                "signal": _series(plot.signal),
                "filtered_time": _series(plot.filtered_time),
                "filtered_signal": _series(plot.filtered_signal),
                "avg_signal": _series(plot.avg_signal),
                "frequencies": _series(plot.frequencies),
                "signal_fft": _series(fft_plot_series(plot.signal_fft, log_plot=log_plot)),
                "filtered_signal_fft": _series(
                    fft_plot_series(plot.filtered_signal_fft, plot.signal_fft, log_plot)),
                "phase_fft": _series(plot.phase_fft),
                "filtered_phase_fft": _series(plot.filtered_phase_fft),
                "avg_signal_fft": _series(
                    fft_plot_series(plot.avg_signal_fft, plot.signal_fft, log_plot)),
                "refractive_index": _series(plot.refractive_index),
                "absorption": _series(plot.absorption_coefficient),
                "extinction": _series(plot.extinction_coefficient),
                "roi_signals": {u: {"name": n, "y": _series(y)}
                                for u, (n, y) in plot.roi_signal.items()},
                "roi_ffts": {
                    u: {"name": n, "y": _series(fft_plot_series(y, plot.signal_fft, log_plot))}
                    for u, (n, y) in plot.roi_signal_fft.items()
                },
                "water_lines": list(WATER_LINES_THZ),
            },
        }

    def _window_shape(self, ex):
        """The FFT window's shape for the settings plot
        (``right_panel.rs:214-299``), from the host time axis; cached per
        (time axis, window parameters)."""
        t0 = ex.pipeline._host_time.get(0)
        if ex.pipeline.input is None or t0 is None or not len(t0):
            return []
        cfg = ex.pipeline.config
        key = ((len(t0), float(t0[0]), float(t0[-1])), cfg.fft_window_type,
               float(cfg.fft_window[0]), float(cfg.fft_window[1]))
        if self._window_shape_cache is None or self._window_shape_cache[0] != key:
            w = window_array(torch.as_tensor(t0), cfg.fft_window_type,
                             cfg.fft_window[0], cfg.fft_window[1])
            self._window_shape_cache = (key, _series(w.numpy(), limit=512))
        return self._window_shape_cache[1]

    # ---------------------------------------------------------- commands
    ALLOWED = {
        "open_file", "open_ref", "open_psf", "save_file", "save_rois", "save_vtu",
        "set_fft_window_low", "set_fft_window_high", "set_fft_window_type",
        "set_fft_log_plot", "set_avg_in_fourier_space", "set_downscaling",
        "set_selected_pixel", "update_filter", "update_filters",
        "set_filter_active", "add_roi", "update_roi", "delete_roi",
        "set_reference", "set_sample", "set_material_thickness",
        "update_material_calculation", "open_sibling", "update_metadata",
        "set_fft_resolution", "set_3d_contrast", "set_kernel_sigma",
        "set_kernel_radius", "set_opacity_threshold", "revert_metadata",
        "set_filter_param", "set_metadata_field", "set_metadata_attr",
        "delete_metadata_attr",
    }

    def logs(self, level: str = "info", limit: int = 400) -> dict:
        """Level-filtered log view (``settings_window.rs:268-483``)."""
        lvl = getattr(logging, str(level).upper(), logging.INFO)
        return {"lines": self.logbuf.tail(int(limit), min_level=lvl),
                "level": str(level).lower()}

    def browse(self, path: str = "") -> dict:
        """Directory listing for the open dialog (``left_panel.rs:326-352``):
        subdirectories and openable files (.thz/.thzimg/.npz) with sizes."""
        path = os.path.abspath(os.path.expanduser(path or os.getcwd()))
        if not os.path.isdir(path):
            path = os.path.dirname(path) or "/"
        dirs, files = [], []
        try:
            for name in sorted(os.listdir(path)):
                if name.startswith("."):
                    continue
                full = os.path.join(path, name)
                if os.path.isdir(full):
                    dirs.append(name)
                elif name.lower().endswith((".thz", ".thzimg", ".npz")):
                    try:
                        size = os.path.getsize(full)
                    except OSError:
                        size = 0
                    files.append({"name": name, "size": size})
        except PermissionError:
            return {"path": path, "error": "permission denied", "dirs": [], "files": []}
        return {"path": path, "parent": os.path.dirname(path) if path != "/" else None,
                "dirs": dirs, "files": files}

    def preview(self, path: str) -> dict:
        """A file's metadata without opening its scan: the open dialog's
        information panel (``application.rs:861-900``). Needs h5py."""
        from thz_image_explorer_tpu_torch.io import dotthz

        md = dotthz.load_metadata(path)
        out = {"description": md.description, "mode": md.mode, "version": md.version,
               "instrument": md.instrument, "date": md.date, "user": md.user,
               "md": dict(md.md)}
        try:
            import h5py

            with h5py.File(path, "r") as f:
                out["groups"] = list(f.keys())
        except Exception:  # noqa: BLE001
            out["groups"] = []
        return out

    def drop(self, name: str, data: bytes) -> dict:
        """Drag-and-drop open (``left_panel.rs:281-322``): the browser gives
        bytes, not a path, so the payload lands in a scratch directory and
        is routed by extension: ``.npz`` loads a PSF, anything else opens as
        a scan."""
        if self._drop_dir is None:
            self._drop_dir = tempfile.mkdtemp(prefix="thz_drop_")
        safe = os.path.basename(name) or "dropped.thzimg"
        path = os.path.join(self._drop_dir, safe)
        with open(path, "wb") as f:
            f.write(data)
        self.worker.send("open_psf" if safe.lower().endswith(".npz") else "open_file", path)
        return {"saved": path}

    def command(self, method: str, args: list, kwargs: dict):
        """One POSTed command. Every Explorer mutation rides the worker's
        queue; request threads own only the display state (``view``)."""
        if method == "set_view":
            key, value = args
            with self._lock:
                if key in self.view:
                    if key == "bw":
                        value = bool(value)
                    else:
                        value = float(value)
                        # the page's clamps, again here: the colormap divides
                        # by mid and (100 - mid), so 0 and 100 must not reach it
                        if key == "midpoint":
                            value = min(99.0, max(1.0, value))
                        else:
                            value = min(100.0, max(0.0, value))
                    self.view[key] = value
            return
        if method == "set_fft_window_type":
            args = [WindowType(args[0])]
        if method == "abort":
            self.worker.abort()
            return
        if method not in self.ALLOWED:
            raise ValueError(f"unknown command {method}")
        self.worker.send(method, *args, **kwargs)

    # ---------------------------------------------------------- PSF tool
    @property
    def psf_tool(self):
        """The PSF tool on this app's device; its parameters persist in the
        settings directory (``psf_tool_state.json``, ``app.rs:33-69``)."""
        if not hasattr(self, "_psf_tool"):
            from thz_image_explorer_tpu_torch.psf_tool.app import PsfToolApp
            from thz_image_explorer_tpu_torch.utils.settings import config_dir

            self._psf_tool = PsfToolApp(persist_dir=config_dir(), device=self.device)
        return self._psf_tool

    def psf_state(self) -> dict:
        tool = self.psf_tool
        # the reference re-checks the parameter hash every frame and
        # recomputes on a change (app.rs:1045-1049); the poll is the frame
        tool.maybe_recompute()
        running = tool._thread is not None and tool._thread.is_alive()
        out = {
            "x_path": tool.x_path,
            "y_path": tool.y_path,
            "filter_params": dataclasses.asdict(tool.filter_params),
            "fit_params": dataclasses.asdict(tool.fit_params),
            "running": running,
            # items copied first: the compute thread inserts keys meanwhile
            "progress": {k: list(v) for k, v in list(tool.progress.items())},
            "error": tool.error,
            "warnings": [],
            "result": None,
            "diagnostics": None,
        }
        r = tool.result
        if r is not None:
            out["warnings"] = list(r.warnings)
            centers = np.asarray(r.center_frequencies, np.float64)
            res = {"centers": _series(centers)}
            for axis_name, axis in (("x", r.x), ("y", r.y)):
                if axis is None:
                    continue
                popt = (axis.beam_fits.popt_xs if axis_name == "x"
                        else axis.beam_fits.popt_ys)
                res[f"w{axis_name}"] = _series(np.abs(popt[:, 1]))
                res[f"{axis_name}0"] = _series(popt[:, 0])
            if r.curve_fits is not None:
                grid = np.linspace(max(float(centers.min()) * 0.8, 1e-3),
                                   float(centers.max()) * 1.1, 120)
                res["fit_freq"] = _series(grid)
                res["fit_wx"] = _series(r.curve_fits.wx_fit.evaluate(grid))
                res["fit_wy"] = _series(r.curve_fits.wy_fit.evaluate(grid))
                res["fit_x0"] = _series(r.curve_fits.x0_fit.evaluate_const_extrap(grid))
                res["fit_y0"] = _series(r.curve_fits.y0_fit.evaluate_const_extrap(grid))
            out["result"] = res
        if tool.diagnostics is not None:
            d = tool.diagnostics
            out["diagnostics"] = d.summary()
            # the diagnostic plots' series (diagnostic_window.rs:1-726)
            out["diag_series"] = {
                "f": _series(d.frequencies_thz),
                "lam": _series(d.wavelengths_um),
                "w0x": _series(d.w0x_mm),
                "w0y": _series(d.w0y_mm),
                "w0_fit_x": _series(d.w0_fit_x_mm),
                "w0_fit_y": _series(d.w0_fit_y_mm),
                "w0_th_x": _series(d.w0_theory_x_mm),
                "w0_th_y": _series(d.w0_theory_y_mm),
                "ratio_x": _series(d.ratio_x),
                "ratio_y": _series(d.ratio_y),
                "ratio_x_mean": d.ratio_x_mean,
                "ratio_y_mean": d.ratio_y_mean,
                "ratio_x_mean_f": d.ratio_x_mean_filtered,
                "ratio_y_mean_f": d.ratio_y_mean_filtered,
                "d_eff_x": _series(d.d_eff_x_mm),
                "d_eff_y": _series(d.d_eff_y_mm),
                "d_eff_x_mean": d.d_eff_x_mean_mm,
                "d_eff_y_mean": d.d_eff_y_mean_mm,
                "d_eff_x_mean_f": d.d_eff_x_mean_filtered_mm,
                "d_eff_y_mean_f": d.d_eff_y_mean_filtered_mm,
                "d_eff_x_th": d.d_eff_x_theory_mm,
                "d_eff_y_th": d.d_eff_y_theory_mm,
                "a_x": d.a_x,
                "a_y": d.a_y,
                "z_r_x": _series(d.z_r_x_mm),
                "z_r_y": _series(d.z_r_y_mm),
                "z_r_fit_x": _series(d.z_r_fit_x_mm),
                "z_r_fit_y": _series(d.z_r_fit_y_mm),
                "z_r_th_x": _series(d.z_r_theory_x_mm),
                "z_r_th_y": _series(d.z_r_theory_y_mm),
            }
        return out

    def psf_command(self, method: str, args: list):
        tool = self.psf_tool
        if method == "set_path":
            axis, path = args
            setattr(tool, f"{axis}_path", path or None)
            tool.save_state()
        elif method == "set_filter_param":
            key, value = args
            cur = getattr(tool.filter_params, key)
            setattr(tool.filter_params, key,
                    type(cur)(value) if not isinstance(cur, str) else str(value))
            # band start/end constrained by the cuts (app.rs:1217-1226)
            tool.clamp_filter_params()
            tool.save_state()
        elif method == "set_fit_param":
            key, value = args
            cur = getattr(tool.fit_params, key)
            setattr(tool.fit_params, key, type(cur)(value))
            tool.save_state()
        elif method == "run":
            tool.start_computation()
        elif method == "cancel":
            tool.cancel()
        elif method == "reset_params":
            tool.reset_parameters()
        elif method == "export":
            if not tool.export_npz(args[0]):
                raise ValueError("no curve fits to export")
        elif method == "apply":
            psf = tool.runtime_psf()
            if psf is None:
                raise ValueError("no PSF computed")
            self.worker.send("apply_psf", psf)
        else:
            raise ValueError(f"unknown psf command {method}")

    def psf_image_png(self, frequency: float) -> dict:
        """The beam profile at one frequency (``psf_visualizer.rs:43-101``)."""
        from thz_image_explorer_tpu_torch.ops.voxel import jet_colormap
        from thz_image_explorer_tpu_torch.psf_tool.visualize import psf_image

        tool = self.psf_tool
        if tool.result is None or tool.result.curve_fits is None:
            return {"image": None}
        intensity, extent = psf_image(tool.result.curve_fits, frequency)
        rgb = jet_colormap(intensity)
        rgba = np.concatenate([rgb, np.ones(rgb.shape[:-1] + (1,))], axis=-1)
        png = encode_png((rgba * 255).astype(np.uint8))
        return {"image": base64.b64encode(png).decode(),
                "extent": [round(float(e), 3) for e in extent]}

    def psf_band(self, axis: str, band: int) -> dict:
        """One band's knife-edge intensities and fitted erf curve
        (``individual_fits_window.rs``). The filtered cube stays on its
        device; only the requested band is copied back."""
        from thz_image_explorer_tpu_torch.ops.firapply import take_band
        from thz_image_explorer_tpu_torch.psf_tool.fitting import compute_intensity, erf_model

        r = self.psf_tool.result
        ax = getattr(r, axis, None) if r is not None else None
        if ax is None:
            return {"n_bands": 0}
        fits = ax.beam_fits
        band = int(np.clip(band, 0, fits.popt_xs.shape[0] - 1))
        tx = fits.filtered_traces_x
        if isinstance(tx, torch.Tensor):
            traces = take_band(tx, band).cpu().numpy().astype(np.float64)
        else:
            traces = np.asarray(tx[band], np.float64)
        positions = np.asarray(fits.x_positions, np.float64)
        intensity = compute_intensity(traces)
        rng = intensity.max() - intensity.min()
        norm = (intensity - intensity.min()) / (rng if rng else 1.0)
        popt = fits.popt_xs[band] if axis == "x" else fits.popt_ys[band]
        grid = np.linspace(positions.min(), positions.max(), 200)
        curve = erf_model(grid, popt[0], popt[1])
        return {
            "n_bands": int(fits.popt_xs.shape[0]),
            "band": band,
            "center_thz": float(r.center_frequencies[band]),
            "positions": _series(positions),
            "intensity": _series(norm),
            "fit_x": _series(grid),
            "fit_y": _series(curve),
            "x0": float(popt[0]),
            "w": float(abs(popt[1])),
        }

    # --------------------------------------------------------- 3D voxels
    def voxels(self, contrast=2.0, sigma=3.0, radius=9, threshold=0.1,
               max_points=120_000) -> dict:
        """Voxel instances of the final cube for the page's 3-D view
        (``threed_plot.rs:132-270``): the ``max_points`` brightest, one
        envelope launch and one packed copy back
        (``ops/voxel.extract_instances_topk``), positions and colours as
        base64."""
        from thz_image_explorer_tpu_torch.ops.voxel import extract_instances_topk

        def build(ex):
            out = ex.pipeline.output
            inp = ex.pipeline.input
            if out is None or inp is None:
                return None
            # the Explorer's 3-D settings follow the view, so SaveVTU
            # exports what the view shows
            ex.view3d.update(contrast=float(contrast), kernel_sigma=float(sigma),
                             kernel_radius=int(radius), opacity_threshold=float(threshold))
            t = out.time.cpu().numpy()
            v0 = ex.pipeline.valid_wh0 or (inp.width, inp.height)
            return extract_instances_topk(
                out.data,
                time_span=float(t[-1] - t[0]) if len(t) > 1 else 1.0,
                scaling=out.scaling,
                original_dims=(v0[0], v0[1], inp.n_time),
                max_points=int(max_points),
                valid_grid=ex.pipeline.valid_for(out),
                opacity_threshold=float(threshold),
                contrast=float(contrast),
                kernel_sigma=float(sigma),
                kernel_radius=int(radius),
            )

        try:
            res = self.worker.call(build, timeout=30.0)
        except TimeoutError:
            return {"n": 0, "busy": True}
        if res is None:
            return {"n": 0}
        positions, rgba, cw, ch, cd, thr = res
        return {
            "n": int(len(positions)),
            "threshold": float(thr),
            "extent": [float(cw), float(ch), float(cd)],
            "positions": base64.b64encode(positions.astype(np.float32).tobytes()).decode(),
            "rgba": base64.b64encode(
                (np.clip(rgba, 0, 1) * 255).astype(np.uint8).tobytes()).decode(),
        }


def _query(path: str) -> dict:
    return parse_qs(urlparse(path).query)


def make_handler(app: WebApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            try:
                payload = json.dumps(obj, allow_nan=False).encode()
            except ValueError:
                # a non-finite scalar slipped past the producers: null it
                payload = json.dumps(_nan2null(obj)).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _html(self, page: str):
            body = page.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _origin_ok(self) -> bool:
            """Reject cross-site requests: the server binds to loopback, but
            any page the browser has open could still POST here (CSRF) or
            read state after a DNS rebind. The Host and, when the browser
            sends one, the Origin header must be loopback."""
            host = (self.headers.get("Host") or "").split(":")[0]
            if host not in ("127.0.0.1", "localhost", "[::1]", ""):
                return False
            origin = self.headers.get("Origin")
            if origin and origin != "null":
                if urlparse(origin).hostname not in ("127.0.0.1", "localhost", "::1"):
                    return False
            return True

        def _answer(self, fn, error_code=500):
            try:
                self._json(fn())
            except Exception as e:  # noqa: BLE001 - reported to the page
                self._json({"error": str(e)}, error_code)

        def do_GET(self):
            if not self._origin_ok():
                self._json({"error": "forbidden origin"}, 403)
                return
            q = _query(self.path)
            route = self.path.split("?")[0]
            if self.path == "/" or self.path.startswith("/index"):
                self._html(PAGE)
            elif route in ("/psf", "/diagnostics", "/fits", "/visualizer") \
                    or self.path.startswith("/psf"):
                # /psf and the focused secondary-window routes
                # (secondary_windows.rs:22-342)
                self._html(PSF_PAGE)
            elif self.path.startswith("/api/psf_state"):
                self._answer(app.psf_state)
            elif self.path.startswith("/api/psf_image"):
                self._answer(lambda: app.psf_image_png(float(q.get("f", [1.0])[0])))
            elif self.path.startswith("/api/psf_band"):
                self._answer(lambda: app.psf_band(q.get("axis", ["x"])[0],
                                                  int(q.get("band", [0])[0])))
            elif self.path.startswith("/api/state"):
                self._answer(app.state)
            elif self.path.startswith("/api/preview"):
                self._answer(lambda: app.preview(q.get("path", [""])[0]), 400)
            elif self.path.startswith("/api/logs"):
                self._answer(lambda: app.logs(q.get("level", ["info"])[0],
                                              int(q.get("limit", ["400"])[0])), 400)
            elif self.path.startswith("/api/browse"):
                self._answer(lambda: app.browse(q.get("path", [""])[0]), 400)
            elif self.path.startswith("/api/update_check"):
                from thz_image_explorer_tpu_torch import __version__
                from thz_image_explorer_tpu_torch.utils.update import check_for_updates

                self._answer(lambda: {"current": __version__, "newer": check_for_updates()})
            elif self.path.startswith("/api/voxels"):
                def g(k, d):
                    return float(q.get(k, [d])[0])

                self._answer(lambda: app.voxels(
                    contrast=g("contrast", 2.0), sigma=g("sigma", 3.0),
                    radius=int(g("radius", 9)), threshold=g("threshold", 0.1)))
            else:
                self.send_error(404)

        def do_POST(self):
            if not self._origin_ok():
                self._json({"error": "forbidden origin"}, 403)
                return
            length = int(self.headers.get("Content-Length", 0))
            if self.path.startswith("/api/drop"):
                try:
                    name = _query(self.path).get("name", ["dropped.thzimg"])[0]
                    self._json({"ok": True, **app.drop(name, self.rfile.read(length))})
                except Exception as e:  # noqa: BLE001
                    self._json({"ok": False, "error": str(e)}, 400)
                return
            if self.path.startswith("/api/update_install"):
                try:
                    from thz_image_explorer_tpu_torch.utils.update import (
                        fetch_release_tarball_url,
                        install_update,
                    )

                    rel = fetch_release_tarball_url()
                    if rel is None:
                        self._json({"ok": False, "error": "no release reachable"}, 502)
                        return
                    tag, url = rel
                    install_update(url)
                    self._json({"ok": True, "tag": tag})
                except Exception as e:  # noqa: BLE001
                    self._json({"ok": False, "error": str(e)}, 500)
                return
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path.startswith("/api/psf_command"):
                    app.psf_command(payload.get("method", ""), payload.get("args", []))
                elif self.path.startswith("/api/command"):
                    app.command(payload.get("method", ""), payload.get("args", []),
                                payload.get("kwargs", {}))
                else:
                    self.send_error(404)
                    return
                self._json({"ok": True})
            except Exception as e:  # noqa: BLE001
                self._json({"ok": False, "error": str(e)}, 400)

    return Handler


def serve(port: int = 8080, scan: Optional[str] = None, precompile: bool = False,
          device=None):
    """Serve the page on ``127.0.0.1:port`` until interrupted. ``device``
    (None: the card) is where the worker's Explorer runs; ``precompile``
    builds the kernels from ``csrc/`` before the first command (the
    pipeline's phase reads "building" meanwhile); ``scan`` is opened at
    start."""
    app = WebApp(device=device, load_settings=True)
    if precompile and app.device.type == "cuda":
        from thz_image_explorer_tpu_torch import kernels

        # queued ahead of the open; state polls meanwhile serve the last
        # snapshot with the phase "building"
        app.worker.send(lambda _ex: kernels.build())
    if scan:
        app.worker.send("open_file", scan)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(app))
    print(f"THz Image Explorer (CUDA, {app.device}) serving on "
          f"http://127.0.0.1:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        try:
            app.save_settings()  # exit autosave (main.rs:116-126)
            # stop a PSF compute in flight; getattr, not the property, which
            # would build the tool just to shut it down
            tool = getattr(app, "_psf_tool", None)
            if tool is not None:
                tool._shutdown()
        finally:
            app.worker.close()


PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>THz Image Explorer — CUDA</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 0; background:#14161a; color:#e6e6e6; display:flex; }
 #left { width: 460px; padding: 10px; }
 #center { flex: 1; padding: 10px; }
 #right { width: 330px; padding: 10px; }
 canvas { background: #1e2128; border: 1px solid #333; }
 .panel { background:#1b1e24; border:1px solid #2a2e36; border-radius:6px; padding:8px; margin-bottom:10px; }
 h3 { margin: 4px 0 8px; font-size: 14px; color:#9ecbff; }
 label { font-size: 12px; }
 input[type=range] { width: 130px; vertical-align: middle; }
 button { background:#2a6; color:#fff; border:0; border-radius:4px; padding:3px 10px; cursor:pointer; margin:2px; }
 button.off { background:#555; }
 .ms { color:#8f8; font-size:11px; float:right; }
 .readout { font-size: 12px; color:#ffce87; margin-right: 12px; }
 select, input[type=number] { background:#23262d; color:#eee; border:1px solid #444; width:90px; }
 input[type=text] { background:#23262d; color:#eee; border:1px solid #444; }
 #warnbar { position:fixed; bottom:0; left:0; right:0; background:#5a2; color:#fff;
   font-size:12px; padding:2px 10px; display:none; }
 details summary { cursor:pointer; font-size:13px; color:#9ecbff; }
 .mdrow { font-size:11px; }
 .tab { display:inline-block; padding:2px 10px; cursor:pointer; color:#999; }
 .tab.active { color:#9ecbff; border-bottom:2px solid #9ecbff; }
 /* iOS-style toggle (toggle_widget.rs:21-105) */
 .switch { display:inline-block; width:30px; height:16px; border-radius:8px;
   background:#555; cursor:pointer; vertical-align:middle; position:relative;
   transition:background .15s; }
 .switch.on { background:#2a6; }
 .switch .knob { position:absolute; top:2px; left:2px; width:12px; height:12px;
   border-radius:6px; background:#eee; transition:left .15s; }
 .switch.on .knob { left:16px; }
 body.light { background:#f2f2f4; color:#222; }
 body.light .panel { background:#fff; border-color:#ccc; }
 body.light canvas { background:#fafafa; border-color:#bbb; }
 body.light h3 { color:#2460a8; }
</style></head><body>
<div id="left">
 <div class="panel"><h3>Scan</h3>
  <div id="fileinfo" style="font-size:12px">no scan loaded</div>
  <input id="path" style="width:240px" placeholder="/path/to/scan.thzimg"
    onchange="loadPreview(this.value)">
  <button class="off" onclick="openBrowse()">Browse…</button>
  <button onclick="cmd('open_file',[el('path').value])">Load</button>
  <button onclick="cmd('open_ref',[el('path').value])">Load Ref</button>
  <button onclick="cmd('open_psf',[el('path').value])">Load PSF</button>
  <div id="browsedlg" style="display:none;border:1px solid #2a2e36;border-radius:4px;padding:6px;margin-top:4px">
   <div id="bpath" style="font-size:11px;color:#999"></div>
   <div id="blist" style="max-height:220px;overflow:auto;font-size:12px"></div>
   <button class="off" onclick="el('browsedlg').style.display='none'">close</button>
  </div>
  <div id="mdpreview" style="font-size:11px;color:#999;max-height:120px;overflow:auto"></div>
  <div style="font-size:10px;color:#666">drop a .thz/.thzimg (scan) or .npz (PSF) anywhere to open it</div><br>
  <button class="off" onclick="cmd('open_sibling',[-1])">◀ prev</button>
  <button class="off" onclick="cmd('open_sibling',[1])">next ▶</button>
  <span id="siblings" style="font-size:11px;color:#999"></span>
  <div id="siblist" style="font-size:11px;max-height:90px;overflow:auto"></div>
  <div id="housekeeping" style="font-size:11px;color:#8bd"></div>
  <canvas id="gauge_ts" width="90" height="90" style="display:none;background:none;border:none"></canvas>
  <canvas id="gauge_p0" width="90" height="90" style="display:none;background:none;border:none"></canvas>
 </div>
 <div class="panel"><h3>Intensity image <span style="font-size:11px;color:#999">(click: pixel · shift-click: ROI)</span></h3>
  <canvas id="img" width="440" height="440"></canvas><canvas id="cbar"
    width="44" height="440" title="drag the marker: midpoint · click: set · double-click: reset"
    style="vertical-align:top;background:none;border:none;cursor:ns-resize"></canvas>
  <div style="font-size:12px">
   clip <input type="range" id="cutlo" min="0" max="100" value="0"
     onchange="cmd('set_view',['cut_low',parseFloat(this.value)])">
   <input type="range" id="cuthi" min="0" max="100" value="100"
     onchange="cmd('set_view',['cut_high',parseFloat(this.value)])">
   mid <input type="range" id="midpt" min="1" max="99" value="50"
     onchange="cmd('set_view',['midpoint',parseFloat(this.value)])">
   <label><input type="checkbox" id="bw"
     onchange="cmd('set_view',['bw',this.checked])">BW</label>
  </div>
  <div style="font-size:12px" id="roilist"></div>
  <button class="off" onclick="cmd('save_rois',[S.file])">Save ROIs</button>
 </div>
 <div class="panel"><h3>Optical properties</h3>
  ref <select id="refsel" onchange="cmd('set_reference',[this.value])"></select>
  sample <select id="sampsel" onchange="cmd('set_sample',[this.value])"></select>
  d(mm) <input id="thick" type="number" step="0.1" value="1.0"
    onchange="cmd('set_material_thickness',[parseFloat(this.value)])">
  <canvas id="optical" width="430" height="160"></canvas>
  <div style="font-size:11px;color:#999" id="optreadout"></div>
 </div>
 <div class="panel"><details><summary>Metadata editor</summary>
  <div style="margin:4px 0">
   <button class="off" id="mdeditbtn" onclick="mdToggleEdit()">Edit</button>
   <span id="mdeditctl" style="display:none">
    <button class="off" onclick="mdRevert()">Revert</button>
    <button onclick="mdSave()">Save</button>
    <button class="off" id="mdlockbtn" onclick="mdToggleLock()" title="existing attributes are protected; unlock to edit or delete them">🔒</button>
   </span>
  </div>
  <div id="mdfields"></div>
  <div id="mdattrs"></div>
  <span id="mdaddrow" style="display:none">
   <input type="text" id="mdkey" placeholder="key" style="width:90px">
   <input type="text" id="mdval" placeholder="value" style="width:120px">
   <button onclick="mdAdd()">Add</button>
  </span>
 </details></div>
</div>
<div id="center">
 <div class="panel"><h3>Pulse</h3><canvas id="pulse" width="820" height="260"></canvas></div>
 <div class="panel"><h3>Spectrum
   <label><input type="checkbox" id="logplot" onchange="cmd('set_fft_log_plot',[this.checked])">log</label>
   <label><input type="checkbox" id="phases" onchange="render()">phases</label>
   <span class="readout" id="dr"></span><span class="readout" id="ptp"></span></h3>
  <canvas id="fft" width="820" height="260"></canvas></div>
 <div class="panel"><h3>3D voxel view
   <button onclick="loadVoxels()">Update</button>
   <button class="off" onclick="autoRotate=!autoRotate">⟳</button>
   <button class="off" onclick="cmd('save_vtu',[(S.file||'scan')+'.vtu'])">Export VTU</button></h3>
  <canvas id="vox" width="560" height="380"></canvas>
  <div style="font-size:12px">
   opacity thr <input type="range" id="vthr" min="0.01" max="0.9" step="0.01" value="0.1">
   contrast <input type="range" id="vcon" min="0.5" max="8" step="0.1" value="2">
   σ <input type="range" id="vsig" min="0.5" max="10" step="0.5" value="3">
   radius <input type="range" id="vrad" min="1" max="15" step="1" value="9">
   <span id="voxinfo" style="color:#999"></span>
  </div>
 </div>
 <div class="panel"><h3>Stage timings</h3><div id="timings" style="font-size:12px"></div></div>
 <div class="panel"><details><summary>Log</summary>
  <select id="loglevel" onchange="refreshLogs()">
   <option value="info">info+</option><option value="warning">warning+</option>
   <option value="error">error</option></select>
  <button class="off" onclick="refreshLogs()">refresh</button>
  <pre id="logpane"
   style="font-size:11px;max-height:260px;overflow:auto;color:#aaa"></pre></details></div>
</div>
<div id="right">
 <div class="panel"><h3>FFT settings</h3>
  window <select id="wtype" onchange="cmd('set_fft_window_type',[this.value])">
   <option value="adapted_blackman">Adapted Blackman</option><option value="blackman">Blackman</option>
   <option value="hanning">Hanning</option><option value="hamming">Hamming</option>
   <option value="flat_top">Flat Top</option></select><br>
  low <input type="range" id="wlo" min="0" max="20" step="0.1" value="1"
    onchange="cmd('set_fft_window_low',[parseFloat(this.value)])"><span id="wlov"></span><br>
  high <input type="range" id="whi" min="0" max="20" step="0.1" value="7"
    onchange="cmd('set_fft_window_high',[parseFloat(this.value)])"><span id="whiv"></span><br>
  downscale <input type="number" id="dscale" min="1" max="10" value="1"
    onchange="cmd('set_downscaling',[parseInt(this.value)])">
  freq res (THz) <input type="number" id="fdf" min="0.0001" step="0.0001" value="1.0"
    onchange="cmd('set_fft_resolution',[parseFloat(this.value)])">
  <label><input type="checkbox" id="avgf"
    onchange="cmd('set_avg_in_fourier_space',[this.checked])">avg in Fourier</label><br>
  <canvas id="winplot" width="300" height="70"></canvas><br>
  <button onclick="cmd('update_filters',[])">Calculate All</button>
  <button class="off" onclick="cmd('abort',[])">Abort</button>
 </div>
 <div class="panel"><h3>Filters</h3><div id="filters"></div></div>
 <div class="panel"><h3>Settings</h3>
  <button class="off" onclick="themeManual=true;document.body.classList.toggle('light')">Theme</button>
  <a href="/psf"><button class="off">PSF Tool</button></a>
  <button class="off" onclick="checkUpdates()">Check updates</button>
  <button id="updbtn" style="display:none" onclick="installUpdate()">Install update</button>
  <span id="updinfo" style="font-size:11px;color:#999"></span>
 </div>
</div>
<div id="warnbar"></div>
<script>
const el = id => document.getElementById(id);
let S = null, roiDraft = [], imgScale = 1, hoverRoi = null;
function pointInPoly(x, y, poly) {
  let inside = false;
  for (let i=0, j=poly.length-1; i<poly.length; j=i++) {
    const [xi, yi] = poly[i], [xj, yj] = poly[j];
    if ((yi>y)!==(yj>y) && x < (xj-xi)*(y-yi)/(yj-yi)+xi) inside = !inside;
  }
  return inside;
}
const escH = s => String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
  .replace(/>/g,'&gt;').replace(/"/g,'&quot;').replace(/'/g,'&#39;');
const escJ = s => JSON.stringify(String(s)).slice(1,-1).replace(/'/g,"\\'");
// for inline event-handler attributes: JS-escape THEN HTML-escape, or a
// quote inside file-derived text breaks out of the attribute
const escA = s => escH(escJ(s));
// innerHTML rebuild guard: skip when content is unchanged (no relayout)
// or when the user is mid-edit of a TEXT field inside the container —
// the 1 Hz poll must never destroy a focused input before its onchange
// fires (the metadata editor's mdEdit guard, generalized). A focused
// button/checkbox/select must NOT freeze its panel: buttons keep focus
// after a click, so guarding on any focus would stall e.g. the filter
// panel until the next outside click.
const isTextEdit = n => !!n && (n.tagName === 'TEXTAREA' || n.isContentEditable
  || (n.tagName === 'INPUT' &&
      !['checkbox','radio','button','range','submit'].includes(n.type)));
function setHTML(id, html) {
  const e = el(id);
  if (e.__html === html) return;
  if (e.contains(document.activeElement) && isTextEdit(document.activeElement)) return;
  e.innerHTML = html; e.__html = html;
}
// write server state back into a control unless the user is on it —
// after a reload the widgets must show the persisted/restored config,
// not their HTML defaults. A STALE busy snapshot predates whatever the
// user just queued; writing it back would visibly revert their edit for
// the whole busy period, so it never syncs controls.
function syncInput(id, v) {
  const e = el(id);
  if (!e || v == null || document.activeElement === e) return;
  if (S && S.stale) return;
  if (e.type === 'checkbox') e.checked = !!v;
  else if (String(e.value) !== String(v)) e.value = v;
}
async function cmd(method, args) {
  await fetch('/api/command', {method:'POST', body: JSON.stringify({method, args})});
  setTimeout(refresh, 150);
}
function drawSeries(ctx, xs, series, colors, overlayLines) {
  const W = ctx.canvas.width, H = ctx.canvas.height;
  ctx.clearRect(0,0,W,H);
  let xmin=Infinity,xmax=-Infinity,ymin=Infinity,ymax=-Infinity;
  for (const s of series) if (s && s.y && s.y.length) {
    const sx = s.x || xs;
    for (let i=0;i<s.y.length;i++){ const v=s.y[i]; if(v==null) continue;
      const x=sx[Math.min(i,sx.length-1)];
      if(x<xmin)xmin=x; if(x>xmax)xmax=x; if(v<ymin)ymin=v; if(v>ymax)ymax=v; }
  }
  if (!(isFinite(xmin)&&isFinite(ymin))) return;
  if (ymax===ymin) ymax=ymin+1;
  const px = x => (x-xmin)/(xmax-xmin)*(W-20)+10;
  const py = y => H-10-(y-ymin)/(ymax-ymin)*(H-20);
  if (overlayLines) { ctx.strokeStyle='#247'; ctx.lineWidth=1;
    for (const f of overlayLines) if (f>=xmin&&f<=xmax) { ctx.beginPath(); ctx.moveTo(px(f),10); ctx.lineTo(px(f),H-10); ctx.stroke(); } }
  series.forEach((s,si)=>{ if(!s||!s.y) return; const sx=s.x||xs;
    ctx.strokeStyle=colors[si%colors.length]; ctx.lineWidth=1.3; ctx.beginPath();
    let started=false;
    for(let i=0;i<s.y.length;i++){ const v=s.y[i]; if(v==null){started=false;continue;}
      const X=px(sx[Math.min(i,sx.length-1)]), Y=py(v);
      if(!started){ctx.moveTo(X,Y);started=true;} else ctx.lineTo(X,Y); }
    ctx.stroke(); });
}
function render() {
  if (!S) return;
  // defensive defaults: a degraded busy-fallback snapshot must still
  // render every panel (plots/roi maps may be absent on the first poll)
  S.plots = S.plots || {};
  S.plots.roi_signals = S.plots.roi_signals || {};
  S.plots.roi_ffts = S.plots.roi_ffts || {};
  S.rois = S.rois || {}; S.filters = S.filters || {};
  S.timings_ms = S.timings_ms || {};
  S.config = S.config || {fft_window:[1,7]};
  S.housekeeping = S.housekeeping || {measured:[]};
  S.readouts = S.readouts || {dr_db:0, ptp:0};
  S.selection = S.selection || {available_references:[], available_samples:[]};
  S.view = S.view || {cut_low:0, cut_high:100, midpoint:50, bw:false};
  el('fileinfo').textContent = (S.file||'no scan loaded') +
    (S.preview ? '  👁 preview (host data; device results coming)' : '') +
    (S.busy ? (S.phase === 'compiling' ? '  ⏳ compiling (first run at this scan shape)' : '  ⏳') : '');
  // image
  if (S.image) {
    const c = el('img'), ctx = c.getContext('2d'), im = new Image();
    im.onload = () => {
      const sc = Math.min(c.width/im.width, c.height/im.height);
      imgScale = sc;
      ctx.clearRect(0,0,c.width,c.height);
      ctx.imageSmoothingEnabled = false;
      ctx.drawImage(im, 0, 0, im.width*sc, im.height*sc);
      // selected pixel marker: screen row = data x, column = data y
      // (matrix_plot.rs:405-426 — the texture swap and plot-y-up cancel)
      const H = S.image_shape[0];
      const dx = S.pixel[1]*sc, dy = S.pixel[0]*sc;
      ctx.strokeStyle='#fff'; ctx.strokeRect(dx-3, dy-3, 6, 6);
      // saved ROI outlines, hovered one highlighted (matrix_plot.rs:497-567)
      const roiColors = ['#e66','#6ae','#6e8','#ea6','#c6e'];
      Object.entries(S.rois).forEach(([u,r],ri)=>{
        if (!r.polygon || r.polygon.length<3) return;
        ctx.strokeStyle = roiColors[ri%roiColors.length];
        ctx.lineWidth = (u===hoverRoi)? 2.5 : 1.2;
        ctx.beginPath();
        r.polygon.forEach((p,i)=>{const X=p[0]*sc,Y=(H-1-p[1])*sc; if(i)ctx.lineTo(X,Y); else ctx.moveTo(X,Y);});
        ctx.closePath(); ctx.stroke();
        if (u===hoverRoi) {
          let cx=0, cy=0;
          r.polygon.forEach(p=>{cx+=p[0]; cy+=p[1];});
          cx/=r.polygon.length; cy/=r.polygon.length;
          ctx.fillStyle='#fff'; ctx.font='11px sans-serif';
          ctx.fillText(`${r.name} (${cx.toFixed(1)}, ${cy.toFixed(1)})`, cx*sc+6, (H-1-cy)*sc-6);
        }
      });
      // ROI draft
      if (roiDraft.length) { ctx.strokeStyle='#ff0'; ctx.beginPath();
        roiDraft.forEach((p,i)=>{const X=p[0]*sc,Y=(H-1-p[1])*sc; if(i)ctx.lineTo(X,Y); else ctx.moveTo(X,Y);});
        ctx.stroke(); }
    };
    im.src = 'data:image/png;base64,' + S.image;
  }
  const colors = ['#e66','#6ae','#6e8','#ea6','#c6e','#6ee','#ee6'];
  drawSeries(el('pulse').getContext('2d'), S.plots.time,
    [{y:S.plots.signal},{x:S.plots.filtered_time,y:S.plots.filtered_signal},{y:S.plots.avg_signal},
     ...Object.values(S.plots.roi_signals).map(r=>({y:r.y}))], colors);
  const fftSeries = el('phases').checked
    ? [{y:S.plots.phase_fft},{y:S.plots.filtered_phase_fft}]
    : [{y:S.plots.signal_fft},{y:S.plots.filtered_signal_fft},{y:S.plots.avg_signal_fft},
       ...Object.values(S.plots.roi_ffts).map(r=>({y:r.y}))];
  drawSeries(el('fft').getContext('2d'), S.plots.frequencies, fftSeries, colors, S.plots.water_lines);
  drawSeries(el('optical').getContext('2d'), S.plots.frequencies,
    [{y:S.plots.refractive_index},{y:S.plots.absorption},{y:S.plots.extinction}], colors);
  const nmax = Math.max(...(S.plots.refractive_index||[0]).filter(v=>v!=null&&isFinite(v)), 0);
  const amax = Math.max(...(S.plots.absorption||[0]).filter(v=>v!=null&&isFinite(v)), 0);
  el('optreadout').textContent = nmax ? `max n: ${nmax.toFixed(3)}  max α: ${amax.toFixed(1)} /cm` : '';
  el('dr').textContent = 'DR: ' + S.readouts.dr_db + ' dB';
  el('ptp').textContent = 'ptp: ' + S.readouts.ptp + ' nA';
  el('wlov').textContent = S.config.fft_window[0].toFixed(1);
  el('whiv').textContent = S.config.fft_window[1].toFixed(1);
  if (S.plots.window_shape && S.plots.window_shape.length)
    drawSeries(el('winplot').getContext('2d'),
      S.plots.window_shape.map((_,i)=>i), [{y:S.plots.window_shape}], ['#9ecbff']);
  setHTML('timings', Object.entries(S.timings_ms)
    .map(([k,v])=>k+': <b>'+v+' ms</b>').join('<br>'));
  // mirror server-side config/view into the controls (widgets must not
  // misrepresent restored settings after a reload)
  syncInput('logplot', S.config.fft_log_plot);
  syncInput('avgf', S.config.avg_in_fourier_space);
  syncInput('wtype', S.config.fft_window_type);
  syncInput('wlo', S.config.fft_window[0]);
  syncInput('whi', S.config.fft_window[1]);
  syncInput('dscale', S.config.scale_factor);
  syncInput('thick', S.selection.thickness);
  syncInput('cutlo', S.view.cut_low);
  syncInput('cuthi', S.view.cut_high);
  syncInput('midpt', S.view.midpoint);
  if (!cbarDrag) drawColorbar();  // don't fight an in-flight drag
  syncInput('bw', S.view.bw);
  el('siblings').textContent = S.siblings.length > 1 ? `(${S.siblings.length} files in dir)` : '';
  // sibling-file table, click to open (left_panel.rs:165-275)
  const curBase = S.file ? S.file.split('/').pop() : '';
  setHTML('siblist', S.siblings.length > 1 ? S.siblings.map((n, i) =>
    `<div style="cursor:pointer;${n===curBase?'color:#9ecbff;font-weight:bold':''}"
       onclick="cmd('open_file',['${escA(S.sibling_paths[i])}'])">${escH(n)}</div>`).join('') : '');
  const hk = S.housekeeping;
  // ambient/sample conditions appear only when the file's metadata
  // carried them (hk.measured); defaults are never shown as measurements
  const meas = hk.measured || [];
  let hkline = `dx ${hk.dx} dy ${hk.dy} · t0 ${Number(hk.t_begin).toFixed(1)} ps · range ${Number(hk.range).toFixed(1)} ps`;
  if (meas.includes('sample_temperature')) hkline += ` · T_S ${hk.sample_temperature} K`;
  if (meas.includes('ambient_pressure')) hkline += ` · p0 ${hk.ambient_pressure} hPa`;
  if (meas.includes('ambient_temperature')) hkline += ` · T0 ${hk.ambient_temperature} °C`;
  if (meas.includes('ambient_humidity')) hkline += ` · RH ${hk.ambient_humidity} %`;
  el('housekeeping').textContent = hkline;
  // housekeeping gauges (gauge_widget.rs:15-209; left_panel.rs:519-538):
  // T_S 0..400 K linear, p0 1e-8..1e3 mbar log — shown when measured
  drawGauge('gauge_ts', meas.includes('sample_temperature'),
            hk.sample_temperature, 0, 400, false, 'K', 'T_S');
  drawGauge('gauge_p0', meas.includes('ambient_pressure'),
            hk.ambient_pressure, 1e-8, 1e3, true, 'mbar', 'p0');
  // the poll refreshes the inline tail only at the default level; a
  // user-selected filter view persists until they hit refresh
  if (el('loglevel').value === 'info')
    el('logpane').textContent = (S.log||[]).join('\n');
  const wb = el('warnbar');
  if (S.last_warning) { wb.style.display='block'; wb.textContent=S.last_warning; wb.style.background='#a52'; }
  else wb.style.display='none';
  if (!mdEdit) renderMetadata();
  // filters panel
  setHTML('filters', Object.entries(S.filters).map(([u,f])=>{
    const params = Object.entries(f.params).filter(([k])=>k!=='active')
      .map(([k,v])=>`<label>${escH(k)} <input type="number" step="0.1" value="${v}"
        onchange="setParam('${escA(u)}','${escA(k)}',this.value)"></label>`).join(' ');
    const doi = f.hyperlink && f.hyperlink.length
      ? ` <a href="${escH(f.hyperlink[1])}" target="_blank" title="${escH(f.description)}">ℹ</a>` : '';
    const prog = (f.progress!=null)
      ? ` <span style="color:#8f8">${Math.round(f.progress*100)}%</span>` : '';
    return `<div style="margin-bottom:8px"><b title="${escH(f.description)}">${escH(f.name)}</b>${doi}${prog}
      <span class="ms"${f.time_stale?' style="color:#777" title="last exact-pass value; fused chain ms in the FFT panel — refreshes when idle"':''}>${f.time_stale?'(':''}${f.time_ms} ms${f.time_stale?')':''}</span><br>
      <span class="switch ${f.active?'on':''}" title="${f.active?'active':'inactive'}"
        onclick="cmd('set_filter_active',['${escA(u)}',${!f.active}])"><span class="knob"></span></span>
      <button onclick="cmd('update_filter',['${escA(u)}'],)">Apply</button> ${params}</div>`;
  }).join(''));
  // ROI list with inline rename (left_panel.rs:601-690)
  setHTML('roilist', Object.entries(S.rois).map(([u,r])=>
    `<input type="text" value="${escH(r.name)}" style="width:80px"
       onchange="renameRoi('${escA(u)}',this.value)">
     <button class="off" onclick="cmd('delete_roi',['${escA(u)}'])">x</button>`).join(' '));
  for (const sel of ['refsel','sampsel']) {
    const opts = (sel==='refsel'?S.selection.available_references:S.selection.available_samples);
    const cur = sel==='refsel'?S.selection.reference:S.selection.sample;
    // escH both sides: ROI labels come from scan-file metadata — the one
    // place file-derived text was reaching innerHTML unescaped (XSS)
    setHTML(sel, '<option></option>' + opts.map(o=>
      `<option value="${escH(o)}" ${o===cur?'selected':''}>${escH(o)}</option>`).join(''));
  }
}
async function setParam(uuid, key, value) {
  await fetch('/api/command', {method:'POST',
    body: JSON.stringify({method:'set_filter_param', args:[uuid, key, parseFloat(value)]})});
}
el('img').addEventListener('mousemove', ev => {
  if (!S || !S.image_shape[0]) return;
  const r = ev.target.getBoundingClientRect();
  // plot coords: x = column (data y), y = flipped row (canvas height =
  // data width = image_shape[0]) — the frame ROI polygons live in
  const H = S.image_shape[0];
  const x = (ev.clientX-r.left)/imgScale;
  const y = H-1-(ev.clientY-r.top)/imgScale;
  let found = null;
  for (const [u, roi] of Object.entries(S.rois))
    if (roi.polygon && roi.polygon.length>2 && pointInPoly(x, y, roi.polygon)) { found = u; break; }
  if (found !== hoverRoi) { hoverRoi = found; render(); }
});
el('img').addEventListener('click', ev => {
  if (!S || !S.image_shape[0]) return;
  const r = ev.target.getBoundingClientRect();
  // plot coords (matrix_plot.rs:585 stores ROI vertices in plot space)
  const H = S.image_shape[0];
  const x = Math.floor((ev.clientX-r.left)/imgScale);
  const y = H-1-Math.floor((ev.clientY-r.top)/imgScale);
  if (ev.shiftKey) {
    // polygon ROI: auto-close within 5% of the SMALLER image dimension
    // of the first vertex, once more than ONE vertex is drafted
    // (matrix_plot.rs:594: width.min(height)*0.05 && polygon.len() > 1)
    if (roiDraft.length > 1) {
      const [fx, fy] = roiDraft[0];
      const tol = 0.05*Math.min(S.image_shape[0], S.image_shape[1]);
      if (Math.hypot(fx-x, fy-y) < tol) {
        const uuid = 'roi-' + Date.now();
        cmd('add_roi', [uuid, 'ROI ' + Object.keys(S.rois).length, roiDraft]);
        roiDraft = [];
        return;
      }
    }
    roiDraft.push([x, y]); render();
  } else {
    roiDraft = [];
    // plot -> data pixel: data x = (H-1)-plot_y (row), data y = plot_x
    // (matrix_plot.rs:610-613)
    cmd('set_selected_pixel', [H-1-y, x]);
  }
});
// ---- colorbar midpoint (matrix_plot.rs:219-271): click on the bar sets
// the midpoint from the distance to the bar TOP (the reference's
// val_y = height - pointer.y in its y-up plot); dragging the triangle
// marker moves it RELATIVELY by delta_y / bar_height * 100; double-click
// resets to 50. Clamped to 1..99 where the reference clamps 0..100: its
// Rust colormap silently tolerates the divide-by-zero at the ends, the
// server's numpy one must never see it. Mirrored in viz/jslogic.py
// (cbar_click_mid / cbar_drag_mid / cbar_marker_y) and pinned by
// tests/test_jslogic.py.
function cbarClickMid(y, barH) { return Math.min(99, Math.max(1, y/barH*100)); }
function cbarDragMid(mid, dy, barH) { return Math.min(99, Math.max(1, mid + dy/barH*100)); }
function cbarMarkerY(mid, barH) { return mid/100*barH; }
const CBAR_W = 18;
function drawColorbar() {
  const c = el('cbar'); if (!c || !S.colorbar) return;
  const ctx = c.getContext('2d'), barH = c.height;
  const im = new Image();
  im.onload = () => {
    ctx.clearRect(0, 0, c.width, c.height);
    ctx.imageSmoothingEnabled = true;
    ctx.drawImage(im, 2, 0, CBAR_W, barH);
    const y = cbarMarkerY(S.view.midpoint, barH);
    ctx.beginPath();  // triangle marker, tip on the bar edge
    ctx.moveTo(CBAR_W + 3, y); ctx.lineTo(CBAR_W + 13, y - 6);
    ctx.lineTo(CBAR_W + 13, y + 6);
    ctx.closePath(); ctx.fillStyle = '#fff'; ctx.strokeStyle = '#555';
    ctx.fill(); ctx.stroke();
  };
  im.src = 'data:image/png;base64,' + S.colorbar;
}
let cbarDrag = null, cbarLastSend = 0;
el('cbar').addEventListener('mousedown', ev => {
  const r = ev.target.getBoundingClientRect(), barH = ev.target.height;
  const y = ev.clientY - r.top;
  if (Math.abs(y - cbarMarkerY(S.view.midpoint, barH)) > 10 || ev.offsetX <= CBAR_W) {
    S.view.midpoint = cbarClickMid(y, barH);   // click: absolute set
    drawColorbar(); cmd('set_view', ['midpoint', S.view.midpoint]);
  }
  cbarDrag = {startY: ev.clientY, startMid: S.view.midpoint};
  ev.preventDefault();
});
window.addEventListener('mousemove', ev => {
  if (!cbarDrag) return;
  S.view.midpoint = cbarDragMid(
    cbarDrag.startMid, ev.clientY - cbarDrag.startY, el('cbar').height);
  drawColorbar();
  const now = performance.now();   // coalesce: ~20 Hz while dragging
  if (now - cbarLastSend > 50) {
    cbarLastSend = now; cmd('set_view', ['midpoint', S.view.midpoint]);
  }
});
window.addEventListener('mouseup', () => {
  if (!cbarDrag) return;
  cmd('set_view', ['midpoint', S.view.midpoint]);  // final value, lossless
  cbarDrag = null;
});
el('cbar').addEventListener('dblclick', () => {
  S.view.midpoint = 50; drawColorbar();
  cmd('set_view', ['midpoint', 50]);   // double-click reset (rs:219-220)
});
async function refresh() {
  // an {"error":...} body is NOT a state snapshot — keep the last good S
  try {
    const j = await (await fetch('/api/state')).json();
    if (!j || j.error !== undefined) return;
    S = j; render();
  } catch(e) {}
}
setInterval(refresh, 1000);
refresh();
async function checkUpdates() {
  const j = await (await fetch('/api/update_check')).json();
  el('updinfo').textContent = j.error ? 'check failed' :
    (j.newer ? ('update available: ' + j.newer) : ('up to date (v' + j.current + ')'));
  el('updbtn').style.display = j.newer ? 'inline' : 'none';
}
async function installUpdate() {
  el('updinfo').textContent = 'installing…';
  const j = await (await fetch('/api/update_install', {method:'POST', body:'{}'})).json();
  el('updinfo').textContent = j.ok
    ? ('installed ' + j.tag + ' — restart the server to use it')
    : ('install failed: ' + (j.error || ''));
}

// ------------------------- 3D voxel view (threed_plot.rs equivalent) ----
let vox = null, rotX = -1.0, rotZ = 0.6, autoRotate = true;
async function loadVoxels() {
  const q = `threshold=${el('vthr').value}&contrast=${el('vcon').value}` +
            `&sigma=${el('vsig').value}&radius=${el('vrad').value}`;
  const r = await (await fetch('/api/voxels?' + q)).json();
  // busy/error are not "empty cube": keep the current cloud on screen
  if (r.busy) { el('voxinfo').textContent = 'worker busy — try again'; return; }
  if (r.error !== undefined) { el('voxinfo').textContent = 'error: ' + r.error; return; }
  if (!r.n) { vox = null; el('voxinfo').textContent = 'no voxels'; return; }
  const pos = new Float32Array(Uint8Array.from(atob(r.positions), c=>c.charCodeAt(0)).buffer);
  const col = Uint8Array.from(atob(r.rgba), c=>c.charCodeAt(0));
  vox = {n: r.n, pos, col};
  el('voxinfo').textContent = r.n + ' voxels, thr ' + r.threshold.toFixed(3);
}
function drawVoxels() {
  const c = el('vox'), ctx = c.getContext('2d');
  ctx.fillStyle = '#171a20'; ctx.fillRect(0, 0, c.width, c.height);
  if (!vox) return;
  if (autoRotate) rotZ += 0.01;
  const cx=Math.cos(rotX), sx=Math.sin(rotX), cz=Math.cos(rotZ), sz=Math.sin(rotZ);
  // extent for scale
  let m = 1;
  for (let i = 0; i < vox.n*3; i++) { const a = Math.abs(vox.pos[i]); if (a > m) m = a; }
  const sc = Math.min(c.width, c.height) / (2.2*m);
  const order = [];
  for (let i = 0; i < vox.n; i++) {
    const x = vox.pos[3*i], y = vox.pos[3*i+1], z = vox.pos[3*i+2];
    const x1 = x*cz - y*sz, y1 = x*sz + y*cz;           // rotate about z
    const y2 = y1*cx - z*sx, z2 = y1*sx + z*cx;         // rotate about x
    order.push([z2, x1, y2, i]);
  }
  order.sort((a, b) => a[0] - b[0]);
  for (const [z2, x1, y2, i] of order) {
    const a = vox.col[4*i+3] / 255;
    ctx.fillStyle = `rgba(${vox.col[4*i]},${vox.col[4*i+1]},${vox.col[4*i+2]},${Math.min(1, a+0.15)})`;
    ctx.fillRect(c.width/2 + x1*sc, c.height/2 - y2*sc, 2, 2);
  }
}
setInterval(drawVoxels, 66);
let dragging = false, lastXY = null;
el('vox').addEventListener('mousedown', e => { dragging = true; autoRotate = false; lastXY=[e.clientX,e.clientY]; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  rotZ += (e.clientX - lastXY[0]) * 0.01;
  rotX += (e.clientY - lastXY[1]) * 0.01;
  lastXY = [e.clientX, e.clientY];
});

function renameRoi(u, name) {
  // pseudo-ROIs (loaded reference pulses) have no polygon and keep
  // their name, as in the reference
  const r = S && S.rois && S.rois[u];
  if (r && r.polygon && name) cmd('update_roi', [u, name, r.polygon]);
}

// ---- sibling navigation with arrow keys (left_panel.rs:165-275): the
// reference's sibling table responds to up/down; here left/right cycle
// the directory's files when no input field has focus
window.addEventListener('keydown', e => {
  const tag = (document.activeElement || {}).tagName;
  if (tag === 'INPUT' || tag === 'TEXTAREA' || tag === 'SELECT') return;
  if (e.key === 'ArrowLeft') cmd('open_sibling', [-1]);
  else if (e.key === 'ArrowRight') cmd('open_sibling', [1]);
});

// ---- OS theme detection (system_theme.rs:1-162): follow the system's
// light/dark preference, live on changes; the Theme button still
// overrides manually (and stops following until reload)
let themeManual = false;
const osTheme = window.matchMedia && window.matchMedia('(prefers-color-scheme: light)');
function applyOsTheme() {
  if (!themeManual && osTheme) document.body.classList.toggle('light', osTheme.matches);
}
if (osTheme && osTheme.addEventListener) osTheme.addEventListener('change', applyOsTheme);
applyOsTheme();

// ---- housekeeping gauges (gauge_widget.rs): arc -45°..150°, colored
// fill to the mapped value, major/minor ticks, log10 mapping for mbar
function drawGauge(id, show, value, minI, maxI, log, suffix, label) {
  const c = el(id);
  c.style.display = show ? 'inline-block' : 'none';
  if (!show) return;
  const ctx = c.getContext('2d');
  const W = c.width, H = c.height, cx = W/2, cy = H/2, r = H/2 - 8;
  const A0 = -45, A1 = 150;
  const ang = d => (180 - d) * Math.PI / 180;  // reference's x = -cos(phi)
  ctx.clearRect(0, 0, W, H);
  const arc = (from, to, width, color) => {
    ctx.beginPath(); ctx.lineWidth = width; ctx.strokeStyle = color;
    // canvas arcs run clockwise in screen coords; our angles decrease
    ctx.arc(cx, cy, r, ang(from), ang(to), true);
    ctx.stroke();
  };
  arc(A0, A1, 2, '#888');
  const frac = log
    ? (Math.log10(Math.max(value, minI)) - Math.log10(minI)) / (Math.log10(maxI) - Math.log10(minI))
    : (value - minI) / (maxI - minI);
  const vdeg = A0 + Math.max(0, Math.min(1, frac)) * (A1 - A0);
  arc(A0, vdeg, 6, '#9ecbff');
  ctx.strokeStyle = '#aaa'; ctx.lineWidth = 1;
  const majorStep = log ? 30 : 50;
  for (let d = A0; d <= A1; d += 10) {
    const major = ((d - A0) % majorStep) === 0, len = major ? 6 : 3;
    const a = ang(d);
    ctx.beginPath();
    ctx.moveTo(cx + Math.cos(a) * (r + 2), cy + Math.sin(a) * (r + 2));
    ctx.lineTo(cx + Math.cos(a) * (r + 2 + len), cy + Math.sin(a) * (r + 2 + len));
    ctx.stroke();
  }
  ctx.fillStyle = '#e6e6e6'; ctx.textAlign = 'center';
  ctx.font = '11px system-ui';
  const vtxt = log ? Number(value).toExponential(1) : Number(value).toFixed(1);
  ctx.fillText(vtxt + ' ' + suffix, cx, cy + 12);
  ctx.fillStyle = '#9ecbff';
  ctx.fillText(label, cx, cy - 4);
}

// ---- metadata editor: Edit / Revert / Save with protected attributes
// (left_panel.rs:693-1009). Existing attributes are read-only until the
// lock is opened; new rows can always be added while editing.
let mdEdit = false, mdUnlocked = false, mdStaged = {fields:{}, attrs:{}, dels:[]};
function mdToggleEdit() {
  mdEdit = !mdEdit; mdUnlocked = false;
  mdStaged = {fields:{}, attrs:{}, dels:[]};
  el('mdeditbtn').textContent = mdEdit ? 'Cancel' : 'Edit';
  el('mdeditctl').style.display = mdEdit ? 'inline' : 'none';
  el('mdaddrow').style.display = mdEdit ? 'inline' : 'none';
  el('mdlockbtn').textContent = '🔒';
  renderMetadata();
}
function mdToggleLock() {
  mdUnlocked = !mdUnlocked;
  el('mdlockbtn').textContent = mdUnlocked ? '🔓' : '🔒';
  renderMetadata();
}
function mdRevert() {
  cmd('revert_metadata', []);
  if (mdEdit) mdToggleEdit();
}
async function mdSave() {
  for (const [k,v] of Object.entries(mdStaged.fields)) await cmd('set_metadata_field',[k,v]);
  for (const [k,v] of Object.entries(mdStaged.attrs)) await cmd('set_metadata_attr',[k,v]);
  for (const k of mdStaged.dels) await cmd('delete_metadata_attr',[k]);
  await cmd('update_metadata', []);
  if (mdEdit) mdToggleEdit();
}
function mdAdd() {
  const k = el('mdkey').value, v = el('mdval').value;
  if (k && v) { mdStaged.attrs[k] = v; el('mdkey').value = el('mdval').value = ''; renderMetadata(); }
}
function renderMetadata() {
  if (!S) return;
  if (!mdEdit) {
    el('mdfields').innerHTML = Object.entries(S.metadata.fields).map(([k,v])=>
      `<div class="mdrow">${escH(k)}: ${escH(v)}</div>`).join('');
    el('mdattrs').innerHTML = Object.entries(S.metadata.md).map(([k,v])=>
      `<div class="mdrow">${escH(k)}: ${escH(v)}</div>`).join('');
    return;
  }
  // while editing, only re-render on explicit state changes (typed text
  // must survive the poll loop) — render() skips us via mdEdit guard
  el('mdfields').innerHTML = Object.entries(S.metadata.fields).map(([k,v])=>
    `<div class="mdrow">${escH(k)} <input type="text" value="${escH(mdStaged.fields[k] ?? v)}" style="width:200px"
      onchange="mdStaged.fields['${escA(k)}']=this.value"></div>`).join('');
  el('mdattrs').innerHTML = Object.entries({...S.metadata.md, ...mdStaged.attrs})
    .filter(([k]) => !mdStaged.dels.includes(k)).map(([k,v])=>
    `<div class="mdrow">${escH(k)}: <input type="text" value="${escH(mdStaged.attrs[k] ?? v)}" style="width:160px"
      ${mdUnlocked || !(k in S.metadata.md) ? '' : 'disabled'}
      onchange="mdStaged.attrs['${escA(k)}']=this.value">
      <button class="off" ${mdUnlocked ? '' : 'disabled'}
        onclick="mdStaged.dels.push('${escA(k)}');renderMetadata()">x</button></div>`).join('');
}

// ---- file-dialog metadata preview (application.rs:861-900)
async function loadPreview(path) {
  const box = el('mdpreview');
  if (!path) { box.textContent = ''; return; }
  try {
    const j = await (await fetch('/api/preview?path=' + encodeURIComponent(path))).json();
    if (j.error) { box.textContent = 'preview: ' + j.error; return; }
    const rows = [['Groups', (j.groups||[]).join(', ')], ['Description', j.description],
      ['Mode', j.mode], ['Version', j.version], ['Instrument', j.instrument],
      ...Object.entries(j.md || {})];
    box.innerHTML = rows.filter(([,v]) => v)
      .map(([k,v]) => `${escH(k)}: ${escH(String(v))}`).join('<br>');
  } catch (e) { box.textContent = ''; }
}

// ---- directory browser (the reference's native file pickers,
// left_panel.rs:326-352) + level-filtered log view (settings_window.rs)
async function openBrowse(p) {
  const seed = p !== undefined ? p : (el('path').value || '');
  try {
    const j = await (await fetch('/api/browse?path=' + encodeURIComponent(seed))).json();
    if (j.error && !j.dirs.length && !j.files.length) return;
    el('browsedlg').style.display = 'block';
    el('bpath').textContent = j.path;
    let h = '';
    // onclick lives in a double-quoted HTML attribute: escA (JS- then
    // HTML-escape) keeps hostile filenames inside it (round-3 review)
    const item = (label, act) =>
      `<div style="cursor:pointer;padding:1px 2px" onclick="${act}">${label}</div>`;
    if (j.parent) h += item('📁 ..', `openBrowse('${escA(j.parent)}')`);
    const join = (d) => (j.path === '/' ? '/' : j.path + '/') + d;
    for (const d of (j.dirs || []))
      h += item('📁 ' + escH(d), `openBrowse('${escA(join(d))}')`);
    for (const f of (j.files || []))
      h += item(escH(f.name) +
        ` <span style="color:#777">${(f.size / 1e6).toFixed(1)} MB</span>`,
        `pickFile('${escA(join(f.name))}')`);
    el('blist').innerHTML = h || '<span style="color:#777">empty</span>';
  } catch (e) {}
}
function pickFile(p) {
  el('path').value = p;
  loadPreview(p);
  el('browsedlg').style.display = 'none';
}
async function refreshLogs() {
  const lv = el('loglevel').value;
  try {
    const j = await (await fetch('/api/logs?level=' + lv + '&limit=800')).json();
    el('logpane').textContent = (j.lines || []).join('\n');
  } catch (e) {}
}

// ---- drag & drop (left_panel.rs:281-322): .npz -> PSF, else open scan
window.addEventListener('dragover', e => e.preventDefault());
window.addEventListener('drop', async e => {
  e.preventDefault();
  const f = e.dataTransfer && e.dataTransfer.files && e.dataTransfer.files[0];
  if (!f) return;
  const buf = await f.arrayBuffer();
  await fetch('/api/drop?name=' + encodeURIComponent(f.name), {method:'POST', body: buf});
  setTimeout(refresh, 300);
});
</script></body></html>
"""


PSF_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>PSF Tool — THz Image Explorer CUDA</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 0; background:#14161a; color:#e6e6e6; display:flex; }
 #left { width: 380px; padding: 10px; }
 #main { flex: 1; padding: 10px; }
 canvas { background: #1e2128; border: 1px solid #333; }
 .panel { background:#1b1e24; border:1px solid #2a2e36; border-radius:6px; padding:8px; margin-bottom:10px; }
 h3 { margin: 4px 0 8px; font-size: 14px; color:#9ecbff; }
 label { font-size: 12px; display:inline-block; min-width: 110px; }
 button { background:#2a6; color:#fff; border:0; border-radius:4px; padding:3px 10px; cursor:pointer; margin:2px; }
 button.off { background:#555; }
 select, input[type=number], input[type=text] { background:#23262d; color:#eee; border:1px solid #444; }
 input[type=number] { width: 70px; }
 .warn { color:#fa6; font-size:12px; }
 pre { font-size:11px; color:#aaa; white-space: pre-wrap; }
 a { color:#9ecbff; }
</style></head><body>
<div id="left">
 <div class="panel"><h3>Knife-edge measurements</h3>
  <label>X scan (.thz)</label><input type="text" id="xpath" style="width:220px"
    onchange="pcmd('set_path',['x',this.value])"><br>
  <label>Y scan (.thz)</label><input type="text" id="ypath" style="width:220px"
    onchange="pcmd('set_path',['y',this.value])"><br>
 </div>
 <div class="panel"><h3>Filter bank</h3>
  <label>n_filters</label><input type="number" id="nf" value="20" onchange="pcmd('set_filter_param',['n_filters',parseInt(this.value)])"><br>
  <label>start freq (THz)</label><input type="number" id="sf" step="0.05" value="0.15" onchange="pcmd('set_filter_param',['start_freq',parseFloat(this.value)])"><br>
  <label>end freq (THz)</label><input type="number" id="ef" step="0.05" value="5.0" onchange="pcmd('set_filter_param',['end_freq',parseFloat(this.value)])"><br>
  <label>low cut</label><input type="number" id="lc" step="0.05" value="0.1" onchange="pcmd('set_filter_param',['low_cut',parseFloat(this.value)])"><br>
  <label>high cut</label><input type="number" id="hc" step="0.1" value="10.0" onchange="pcmd('set_filter_param',['high_cut',parseFloat(this.value)])"><br>
  <label>transition width</label><input type="number" id="ww" step="0.05" value="0.5" onchange="pcmd('set_filter_param',['win_width',parseFloat(this.value)])"><br>
  <label>spacing</label><select id="sp" onchange="pcmd('set_filter_param',['frequency_spacing',this.value])">
    <option value="log">log</option><option value="linear">linear</option></select>
 </div>
 <div class="panel"><h3>Beam fit</h3>
  <label>w_max (mm)</label><input type="number" id="wm" step="1" value="30" onchange="pcmd('set_fit_param',['w_max',parseFloat(this.value)])"><br>
  <label><input type="checkbox" id="mono" checked
    onchange="pcmd('set_fit_param',['use_monotonicity_constraint',this.checked])">monotonic bounds</label>
 </div>
 <div class="panel">
  <button onclick="pcmd('run',[])">Compute</button>
  <button class="off" onclick="pcmd('cancel',[])">Cancel</button>
  <button class="off" title="Reset all filter and fitting parameters to default"
    onclick="pcmd('reset_params',[])">&#x1F504; Reset Parameters</button>
  <div id="progress" style="font-size:12px;color:#8f8"></div>
  <div id="warnings" class="warn"></div>
  <div id="error" class="warn"></div>
 </div>
 <div class="panel"><h3>Export / Apply</h3>
  <input type="text" id="outpath" style="width:220px" placeholder="/path/psf.npz">
  <button onclick="pcmd('export',[el('outpath').value])">Export .npz</button><br>
  <button onclick="pcmd('apply',[])">Use for deconvolution</button>
  <a href="/" style="font-size:12px">← back to explorer</a>
 </div>
 <div class="panel"><h3>Windows</h3>
  <a href="/diagnostics" target="_blank" style="font-size:12px">Diagnostics ↗</a><br>
  <a href="/fits" target="_blank" style="font-size:12px">Individual fits ↗</a><br>
  <a href="/visualizer" target="_blank" style="font-size:12px">PSF visualizer ↗</a>
 </div>
</div>
<div id="main">
 <div class="panel" id="pnl_widths"><h3>Beam widths vs frequency</h3><canvas id="widths" width="760" height="240"></canvas></div>
 <div class="panel" id="pnl_centers"><h3>Beam centers vs frequency</h3><canvas id="centers" width="760" height="170"></canvas></div>
 <div class="panel" id="pnl_fits"><h3>Individual band fit
   axis <select id="bandaxis"><option>x</option><option>y</option></select>
   band <input type="number" id="bandidx" value="0" min="0" style="width:60px">
   <button class="off" onclick="loadBand()">Show</button>
   <span id="bandinfo" style="font-size:12px;color:#999"></span></h3>
  <canvas id="bandfit" width="760" height="200"></canvas></div>
 <div class="panel" id="pnl_vis"><h3>PSF preview
   f(THz) <input type="range" id="pf" min="0.2" max="5" step="0.1" value="1.0" onchange="loadPsfImage()">
   <span id="pfv"></span><span id="pext" style="font-size:11px;color:#999"></span></h3>
  <img id="psfimg" width="256" height="256" style="border:1px solid #333"></div>
 <div class="panel" id="pnl_diag"><h3>Diagnostics</h3><pre id="diag"></pre></div>
 <div class="panel" id="diagplots" style="display:none"><h3>Diagnostic plots</h3>
  <div style="font-size:12px;color:#999">1. Beam waist w0 vs frequency — <span style="color:#e66">measured</span>, <span style="color:#888">theory (D_eff const)</span></div>
  <canvas id="dg_w0f_x" width="370" height="160"></canvas><canvas id="dg_w0f_y" width="370" height="160"></canvas>
  <div style="font-size:12px;color:#999">2. w0 vs wavelength λ — <span style="color:#e66">measured</span>, <span style="color:#6ae">fit w0=A·λ</span>, <span style="color:#888">theory</span> <span id="dg_a"></span></div>
  <canvas id="dg_w0l_x" width="370" height="160"></canvas><canvas id="dg_w0l_y" width="370" height="160"></canvas>
  <div style="font-size:12px;color:#999">3. Ratio π·w0/λ (should be constant) — <span style="color:#e66">measured</span>, <span style="color:#6ae">mean (all)</span>, <span style="color:#9cf">mean (&lt;1 THz)</span></div>
  <canvas id="dg_ratio_x" width="370" height="160"></canvas><canvas id="dg_ratio_y" width="370" height="160"></canvas>
  <div style="font-size:12px;color:#999">4. Effective aperture D_eff(λ) — <span style="color:#e66">measured</span>, <span style="color:#6ae">mean</span>, <span style="color:#9cf">mean (&lt;1 THz)</span>, <span style="color:#888">theory @ f_ref</span></div>
  <canvas id="dg_deff_x" width="370" height="160"></canvas><canvas id="dg_deff_y" width="370" height="160"></canvas>
  <div style="font-size:12px;color:#999">5. Rayleigh range z_R(λ) — <span style="color:#e66">measured π·w0²/λ</span>, <span style="color:#6ae">fit π·A²·λ</span>, <span style="color:#888">theory</span></div>
  <canvas id="dg_zr_x" width="370" height="160"></canvas><canvas id="dg_zr_y" width="370" height="160"></canvas>
 </div>
</div>
<script>
const el = id => document.getElementById(id);
let P = null;
// ---- independent secondary windows (secondary_windows.rs:22-342): the
// /diagnostics, /fits and /visualizer routes serve this page focused on
// one section — each opens in its own browser window/tab, all polling
// the same shared state (the reference's five concurrent OS windows).
const SECTION = {'/diagnostics': ['pnl_diag','diagplots'],
                 '/fits': ['pnl_fits'],
                 '/visualizer': ['pnl_vis']}[location.pathname] || null;
if (SECTION) window.addEventListener('DOMContentLoaded', () => {
  el('left').style.display = 'none';
  for (const p of ['pnl_widths','pnl_centers','pnl_fits','pnl_vis','pnl_diag','diagplots'])
    if (!SECTION.includes(p)) el(p).style.display = 'none';
});
async function pcmd(method, args) {
  const r = await fetch('/api/psf_command', {method:'POST', body: JSON.stringify({method, args})});
  const j = await r.json();
  if (!j.ok) el('error').textContent = j.error || '';
  setTimeout(refresh, 200);
}
function drawXY(ctx, seriesList, colors) {
  const W = ctx.canvas.width, H = ctx.canvas.height;
  ctx.clearRect(0,0,W,H);
  let xmin=Infinity,xmax=-Infinity,ymin=Infinity,ymax=-Infinity;
  for (const s of seriesList) if (s && s.x && s.y)
    for (let i=0;i<s.y.length;i++){ const x=s.x[i], v=s.y[i]; if(v==null||x==null) continue;
      if(x<xmin)xmin=x; if(x>xmax)xmax=x; if(v<ymin)ymin=v; if(v>ymax)ymax=v; }
  if (!isFinite(xmin)) return;
  if (ymax===ymin) ymax=ymin+1;
  const px = x => (x-xmin)/(xmax-xmin)*(W-30)+20;
  const py = y => H-15-(y-ymin)/(ymax-ymin)*(H-30);
  seriesList.forEach((s,si)=>{ if(!s||!s.y) return;
    ctx.strokeStyle = ctx.fillStyle = colors[si%colors.length];
    if (s.points) { for(let i=0;i<s.y.length;i++){ if(s.y[i]==null) continue;
        ctx.fillRect(px(s.x[i])-2, py(s.y[i])-2, 4, 4); } }
    else { ctx.lineWidth=1.3; ctx.beginPath(); let st=false;
      for(let i=0;i<s.y.length;i++){ const v=s.y[i]; if(v==null){st=false;continue;}
        if(!st){ctx.moveTo(px(s.x[i]),py(v));st=true;} else ctx.lineTo(px(s.x[i]),py(v)); }
      ctx.stroke(); } });
}
// inputs mirror the tool's state (persisted params, server-side clamps,
// Reset Parameters) — but never while the user is typing in that field
const PARAM_IDS = {nf:['filter_params','n_filters'], sf:['filter_params','start_freq'],
  ef:['filter_params','end_freq'], lc:['filter_params','low_cut'],
  hc:['filter_params','high_cut'], ww:['filter_params','win_width'],
  sp:['filter_params','frequency_spacing'], wm:['fit_params','w_max'],
  xpath:[null,'x_path'], ypath:[null,'y_path']};
function syncParams() {
  for (const [id, [grp, key]] of Object.entries(PARAM_IDS)) {
    const e = el(id);
    if (!e || document.activeElement === e) continue;
    const v = grp ? (P[grp]||{})[key] : P[key];
    if (v !== undefined && v !== null && String(e.value) !== String(v)) e.value = v;
  }
  const m = el('mono');
  if (m && document.activeElement !== m && P.fit_params)
    m.checked = !!P.fit_params.use_monotonicity_constraint;
}
function render() {
  if (!P) return;
  syncParams();
  el('progress').textContent = P.running
    ? 'computing… ' + Object.entries(P.progress).map(([a,[c,t]])=>`${a}: ${c}/${t}`).join('  ')
    : (P.result ? 'done' : '');
  el('warnings').textContent = (P.warnings||[]).join('\n');
  el('error').textContent = P.error || '';
  el('diag').textContent = P.diagnostics || '';
  const r = P.result, colors = ['#e66','#6ae','#f99','#9cf'];
  if (r) {
    drawXY(el('widths').getContext('2d'), [
      {x:r.centers, y:r.wx, points:true}, {x:r.centers, y:r.wy, points:true},
      {x:r.fit_freq, y:r.fit_wx}, {x:r.fit_freq, y:r.fit_wy}], colors);
    drawXY(el('centers').getContext('2d'), [
      {x:r.centers, y:r.x0, points:true}, {x:r.centers, y:r.y0, points:true},
      {x:r.fit_freq, y:r.fit_x0}, {x:r.fit_freq, y:r.fit_y0}], colors);
  }
  const D = P.diag_series;
  el('diagplots').style.display = D ? 'block' : 'none';
  if (D) {
    const span = [D.lam[0], D.lam[D.lam.length-1]];
    const flat = v => ({x: span, y: [v, v]});
    const dcol = ['#e66','#6ae','#9cf','#888'];
    for (const ax of ['x','y']) {
      const w0 = D['w0'+ax], th = D['w0_th_'+ax], fit = D['w0_fit_'+ax];
      drawXY(el('dg_w0f_'+ax).getContext('2d'),
        [{x:D.f, y:w0, points:true}, null, null, {x:D.f, y:th}], dcol);
      drawXY(el('dg_w0l_'+ax).getContext('2d'),
        [{x:D.lam, y:w0, points:true}, {x:D.lam, y:fit}, null, {x:D.lam, y:th}], dcol);
      drawXY(el('dg_ratio_'+ax).getContext('2d'),
        [{x:D.lam, y:D['ratio_'+ax], points:true}, flat(D['ratio_'+ax+'_mean']),
         flat(D['ratio_'+ax+'_mean_f'])], dcol);
      drawXY(el('dg_deff_'+ax).getContext('2d'),
        [{x:D.lam, y:D['d_eff_'+ax], points:true}, flat(D['d_eff_'+ax+'_mean']),
         flat(D['d_eff_'+ax+'_mean_f']), flat(D['d_eff_'+ax+'_th'])], dcol);
      drawXY(el('dg_zr_'+ax).getContext('2d'),
        [{x:D.lam, y:D['z_r_'+ax], points:true}, {x:D.lam, y:D['z_r_fit_'+ax]},
         null, {x:D.lam, y:D['z_r_th_'+ax]}], dcol);
    }
    el('dg_a').textContent =
      ` (A_x=${(D.a_x*1e3).toFixed(3)}, A_y=${(D.a_y*1e3).toFixed(3)})`;
  }
}
async function loadPsfImage() {
  el('pfv').textContent = el('pf').value + ' THz';
  const j = await (await fetch('/api/psf_image?f=' + el('pf').value)).json();
  if (j.image) { el('psfimg').src = 'data:image/png;base64,' + j.image;
    el('pext').textContent = '  extent(mm): ' + j.extent.join(', '); }
}
async function loadBand() {
  const j = await (await fetch(`/api/psf_band?axis=${el('bandaxis').value}&band=${el('bandidx').value}`)).json();
  if (!j.n_bands) return;
  el('bandinfo').textContent = ` ${j.center_thz.toFixed(2)} THz  x0=${j.x0.toFixed(2)}  w=${j.w.toFixed(2)} mm  (${j.n_bands} bands)`;
  drawXY(el('bandfit').getContext('2d'), [
    {x:j.positions, y:j.intensity, points:true}, {x:j.fit_x, y:j.fit_y}], ['#e66','#6ae']);
}
async function refresh() {
  try { P = await (await fetch('/api/psf_state')).json(); render(); } catch(e) {}
}
setInterval(refresh, 1000);
refresh();
</script></body></html>
"""
