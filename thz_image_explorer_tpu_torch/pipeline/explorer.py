"""Host API facade: the command surface of the application.

Port of ``thz_image_explorer_tpu/pipeline/explorer.py`` (reference
``ConfigCommand`` API, ``config.rs:58-164``, and the ``main_thread``
handlers, ``data_thread.rs:148-1050``) as plain synchronous methods. After
every command the Explorer publishes a :class:`PlotData` snapshot of small
host arrays; the cube itself never leaves the device. A scan opens in two
phases (a host preview, then the device phase), deferred through the
worker of :mod:`thz_image_explorer_tpu_torch.pipeline.worker` when one is
attached and run back to back otherwise.

``Explorer(device=None)`` runs on ``"cuda"`` and raises when CUDA is
missing; it never moves to the CPU on its own (tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import uuid as _uuidlib
from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube, make_cube, resolve_device
from thz_image_explorer_tpu_torch.io import dotthz as thzio
from thz_image_explorer_tpu_torch.io.files import find_files_with_same_extension
from thz_image_explorer_tpu_torch.io.psf_npz import load_psf
from thz_image_explorer_tpu_torch.io.vtk import export_to_vtk
from thz_image_explorer_tpu_torch.ops.roi import polygon_mask
from thz_image_explorer_tpu_torch.ops.voxel import extract_instances
from thz_image_explorer_tpu_torch.ops.windows import WindowType, window_array
from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline
from thz_image_explorer_tpu_torch.pipeline.publish import Publisher
from thz_image_explorer_tpu_torch.pipeline.stage import FilterStage
from thz_image_explorer_tpu_torch.utils import spans

log = logging.getLogger(__name__)

SELECTED_PIXEL = "Selected Pixel"


@dataclasses.dataclass
class HouseKeeping:
    """Scan-condition metadata (``data_container.rs:18-56``), populated at
    load time from the scan geometry (``data_thread.rs:617-639``)."""

    dx: float = 1.0
    x_range: tuple[float, float] = (0.0, 10.0)
    dy: float = 1.0
    y_range: tuple[float, float] = (0.0, 10.0)
    t_begin: float = 1000.0
    range: float = 50.0
    ambient_temperature: float = 22.0
    ambient_pressure: float = 950.0
    ambient_humidity: float = 50.0
    sample_temperature: float = 0.0
    #: which ambient/sample fields were read from file metadata (the rest
    #: are the reference's struct defaults)
    measured: list = dataclasses.field(default_factory=list)

    _MD_KEYS = {
        "T_S [K]": "sample_temperature",
        "P [mbar]": "ambient_pressure",
        "T [C]": "ambient_temperature",
        "RH [%]": "ambient_humidity",
    }

    def apply_metadata(self, md: dict):
        """Ambient/sample conditions from file metadata when present
        (``left_panel.rs:125-130``); unparsable values are logged and
        skipped."""
        for key, field in self._MD_KEYS.items():
            if key in md:
                try:
                    setattr(self, field, float(str(md[key]).strip()))
                    self.measured.append(field)
                except ValueError:
                    log.warning("metadata %r=%r is not numeric; ignored", key, md[key])

    @staticmethod
    def from_scan(host: thzio.HostScan) -> "HouseKeeping":
        return HouseKeeping._from_geometry(host.dx, host.dy, host.x_min, host.y_min,
                                           host.valid_wh, host.time)

    @staticmethod
    def from_cube(cube: ScanCube, valid_wh: Optional[tuple[int, int]] = None) -> "HouseKeeping":
        """From a cube's geometry; the ranges span ``valid_wh`` (the cube's
        own size when None)."""
        wh = valid_wh if valid_wh is not None else (cube.width, cube.height)
        return HouseKeeping._from_geometry(cube.dx, cube.dy, cube.x_min, cube.y_min, wh,
                                           cube.time.cpu().numpy())

    @staticmethod
    def _from_geometry(dx, dy, x_min, y_min, wh, time) -> "HouseKeeping":
        hk = HouseKeeping()
        hk.dx = dx if dx is not None else 1.0
        hk.dy = dy if dy is not None else 1.0
        x0 = x_min if x_min is not None else 0.0
        y0 = y_min if y_min is not None else 0.0
        w, h = wh
        hk.x_range = (x0, x0 + w * hk.dx)
        hk.y_range = (y0, y0 + h * hk.dy)
        if len(time):
            hk.t_begin = float(time[0])
            hk.range = float(time[-1] - time[0])
        return hk


def _empty():
    return dataclasses.field(default_factory=lambda: np.zeros(0))


@dataclasses.dataclass
class PlotData:
    """Published plot series (``PlotDataContainer``,
    ``data_container.rs:60-105``)."""

    time: np.ndarray = _empty()
    signal: np.ndarray = _empty()
    filtered_time: np.ndarray = _empty()
    filtered_signal: np.ndarray = _empty()
    avg_signal: np.ndarray = _empty()
    frequencies: np.ndarray = _empty()
    signal_fft: np.ndarray = _empty()
    phase_fft: np.ndarray = _empty()
    filtered_frequencies: np.ndarray = _empty()
    filtered_signal_fft: np.ndarray = _empty()
    filtered_phase_fft: np.ndarray = _empty()
    avg_signal_fft: np.ndarray = _empty()
    avg_phase_fft: np.ndarray = _empty()
    roi_signal: dict = dataclasses.field(default_factory=dict)
    roi_signal_fft: dict = dataclasses.field(default_factory=dict)
    roi_phase: dict = dataclasses.field(default_factory=dict)
    refractive_index: np.ndarray = _empty()
    absorption_coefficient: np.ndarray = _empty()
    extinction_coefficient: np.ndarray = _empty()
    available_references: list = dataclasses.field(default_factory=list)
    available_samples: list = dataclasses.field(default_factory=list)


class Explorer:
    """Synchronous command facade over the incremental pipeline."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.pipeline = Pipeline(self.device)
        self.publisher = Publisher()
        self.plot = PlotData()
        self.metadata = thzio.DotthzMetadata()
        self.pixel_selected = [0, 0]
        #: uuid -> (name, polygon); a polygon of None is a pseudo-ROI (a
        #: loaded reference pulse, ``data_thread.rs:568-583``)
        self.rois: dict[str, tuple[str, Optional[list]]] = {}
        #: pseudo-ROI spectra: uuid -> (trace, amplitudes, phases), host f32
        self._datasets: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        #: (uuid, its bins, the scan's bins) of optical selections already
        #: warned about as skipped
        self._warned_optical: set = set()
        self.sample_selection = ""
        self.reference_selection = ""
        self.sample_thickness = 1.0  # (application.rs:184)
        self.image: Optional[np.ndarray] = None
        self.file_path: Optional[str] = None
        self.housekeeping = HouseKeeping()
        #: the two-phase open (``data_thread.rs:1242-1316`` paints the image
        #: right after the load): ``defer`` is set by the worker; a pending
        #: open is (epoch, HostScan, facade snapshot) until its device phase
        self.defer = None
        self._open_epoch = 0
        self._pending_open = None
        #: keeps the finalize's own publish from re-entering the finalize
        self._finalizing = False
        self._mask_key = None
        self._mask_stack: Optional[torch.Tensor] = None
        self._poly_masks: dict = {}
        # 3-D voxel view parameters (threed_plot.rs / paper.md:100-111)
        self.view3d = {
            "contrast": 2.0,
            "kernel_sigma": 3.0,
            "kernel_radius": 9,
            "opacity_threshold": 0.1,
        }

    # ------------------------------------------------------------ files
    def open_file(self, path: str):
        """OpenFile (``data_thread.rs:589-740``): read the dotTHz file, then
        the two phases of :meth:`_open`."""
        self._open(thzio.open_scan_host(path), path)

    def open_arrays(self, time, data, metadata: Optional[thzio.DotthzMetadata] = None):
        """Open a scan held in memory: a (T,) time axis and a raw (X, Y, T)
        cube (DC offset still in), with optional file metadata; the same two
        phases as :meth:`open_file`."""
        self._open(thzio.open_scan_arrays(time, data, metadata), None)

    def _open(self, host: thzio.HostScan, path: Optional[str]):
        """Phase 1, host only: metadata, ROIs, housekeeping and a preview
        (the intensity image and the selected pixel's trace in host numpy)
        are published at once. Phase 2 (:meth:`_finalize_open`), the device
        copy and the first chain pass, is deferred through the worker when
        one is attached (state reads between the phases see the preview)
        and runs right away otherwise, so a direct caller sees the
        single-phase contract."""
        # taken before any change: a failed device phase rolls back to it
        snapshot = self._open_snapshot()
        self.metadata = host.metadata
        self.file_path = path
        if self.defer is not None:
            # only a deferred device phase leaves the preview image on show;
            # a direct open's own publish replaces it at once
            self.image = host.preview_image()
        # ROIs serialized in metadata come back (data_thread.rs:646-711)
        self.rois = {
            str(_uuidlib.uuid4()): (label, coords)
            for label, coords in host.metadata.get_rois()
        }
        self._datasets = {}
        self.pixel_selected = [0, 0]
        self.housekeeping = HouseKeeping.from_scan(host)
        self.housekeeping.apply_metadata(host.metadata.md)
        plot = PlotData()
        plot.time = host.time
        plot.signal = host.preview_trace(0, 0)
        plot.available_references = [name for name, _p in self.rois.values()]
        plot.available_samples = plot.available_references + [SELECTED_PIXEL]
        self.plot = plot
        self._open_epoch += 1
        self._pending_open = (self._open_epoch, host, snapshot)
        if self.defer is not None:
            self.defer("_finalize_open", self._open_epoch)
        else:
            self._finalize_open(self._open_epoch)

    @property
    def preview_pending(self) -> bool:
        """True from the preview until the device phase has published."""
        return self._pending_open is not None

    def _open_snapshot(self) -> dict:
        """The facade attributes phase 1 changes."""
        return {
            "metadata": self.metadata,
            "file_path": self.file_path,
            "image": self.image,
            "rois": self.rois,
            "_datasets": self._datasets,
            "pixel_selected": self.pixel_selected,
            "housekeeping": self.housekeeping,
            "plot": self.plot,
        }

    def _finalize_open(self, epoch: int):
        """Phase 2: the host-to-device copy, DC offset and cube on the
        device, the first chain pass and the full publish. Epoch-guarded (a
        newer open supersedes a stale deferred finalize) and idempotent.
        ``preview_pending`` stays True through this phase's own publish;
        ``_finalizing`` keeps that publish from re-entering here. If the
        device copy fails, the facade rolls back to the previous scan, which
        the pipeline still holds."""
        pending = self._pending_open
        if pending is None or pending[0] != epoch or self._finalizing:
            return
        _, host, snapshot = pending
        self._finalizing = True
        try:
            try:
                cube, _img = thzio.finalize_scan(host, self.device)
            except BaseException:
                for attr, value in snapshot.items():
                    setattr(self, attr, value)
                raise
            self.pipeline.set_input(cube)
            self.publish()
        finally:
            self._finalizing = False
            # consumed on the way out, on failure too: a failed device phase
            # must not be retried by every later command
            if self._pending_open is pending:
                self._pending_open = None

    def _ensure_open_finalized(self):
        """A command that needs the device state finalizes a pending open
        first; this also completes an open whose deferred finalize an abort
        drained."""
        if self._pending_open is not None:
            self._finalize_open(self._pending_open[0])

    def save_file(self, path: str):
        """SaveFile: initial cube + metadata with the ROIs
        (``data_thread.rs:741-768``)."""
        self._ensure_open_finalized()
        inp = self.pipeline.input
        if inp is None:
            return
        md = self.metadata
        if "time" not in md.ds_description:
            md.ds_description = ["time", "dataset"]
        md.set_rois(self._polygon_rois())
        thzio.save_scan(path, inp, md)

    def save_rois(self, path: str):
        """SaveROIs: rewrite the ROI entries of a file's metadata in place
        (``data_thread.rs:274-330``)."""
        md = thzio.load_metadata(path)
        md.set_rois(self._polygon_rois())
        thzio.update_metadata(path, md)

    def update_metadata(self):
        """UpdateMetaData: rewrite the open file's metadata in place
        (``io.rs:363-380``)."""
        if self.file_path is None:
            return
        thzio.update_metadata(self.file_path, self.metadata)

    def revert_metadata(self):
        """Reload the open file's metadata, dropping unsaved edits (the
        metadata editor's Revert, ``left_panel.rs:718-736``)."""
        if self.file_path is None:
            return
        self.metadata = thzio.load_metadata(self.file_path)

    @staticmethod
    def load_metadata(path: str) -> thzio.DotthzMetadata:
        """LoadMetaData: a file's metadata without opening its scan (the
        file dialog's preview, ``gui/application.rs:861-900``)."""
        return thzio.load_metadata(path)

    def set_metadata_field(self, key: str, value):
        """Edit a top-level metadata field (``left_panel.rs:693-1009``)."""
        if hasattr(self.metadata, key) and key != "md":
            setattr(self.metadata, key, str(value))

    def set_metadata_attr(self, key: str, value):
        self.metadata.md[str(key)] = str(value)

    def delete_metadata_attr(self, key: str):
        self.metadata.md.pop(str(key), None)

    def sibling_files(self) -> list[str]:
        """Files with the open file's extension in its directory, sorted:
        the arrow-key navigation table (``io.rs:285-308``)."""
        if self.file_path is None:
            return []
        return find_files_with_same_extension(self.file_path)

    def open_sibling(self, delta: int):
        """Arrow-key previous/next navigation with wrap-around
        (``left_panel.rs:165-275``)."""
        sibs = self.sibling_files()
        if not sibs:
            return
        try:
            idx = sibs.index(os.path.abspath(self.file_path))
        except ValueError:
            return
        self.open_file(sibs[(idx + delta) % len(sibs)])

    def open_ref(self, path: str):
        """OpenRef (``data_thread.rs:372-588``): load a reference pulse from
        a dotTHz file as a pseudo-ROI."""
        time, signal, _md = thzio.open_pulse(path)
        self.open_ref_arrays(time, signal)

    def open_ref_arrays(self, time, signal):
        """The in-memory counterpart of :meth:`open_ref`: a pulse given as a
        (T,) time axis and a (T,) signal. It is aligned to the scan's time
        axis, windowed and transformed once with the current FFT settings
        (host math: one trace), and registered as the pseudo-ROI
        "Reference File" (numbered after the first). Without a scan a 1x1
        zero scan on the pulse's axis is opened first."""
        self._ensure_open_finalized()
        time = np.asarray(time, np.float32)
        if self.pipeline.input is None:
            self.pipeline.set_input(make_cube(time, np.zeros((1, 1, len(time)), np.float32),
                                              device=self.device))
        scan_time = self.pipeline._host_time[0]
        signal = _align_reference(signal, time, scan_time)
        cfg = self.pipeline.config
        w = window_array(torch.as_tensor(scan_time), cfg.fft_window_type,
                         cfg.fft_window[0], cfg.fft_window[1]).numpy()
        windowed = (signal * w).astype(np.float32)
        spec = np.fft.rfft(windowed)
        amplitudes = np.abs(spec).astype(np.float32)
        phases = np.unwrap(np.angle(spec)).astype(np.float32)
        n_refs = sum(1 for name, _p in self.rois.values() if "Reference File" in name)
        uuid = str(_uuidlib.uuid4())
        self.rois[uuid] = (f"Reference File {n_refs}" if n_refs else "Reference File", None)
        self._datasets[uuid] = (windowed, amplitudes, phases)
        self.publish()

    def save_vtu(self, path: str):
        """SaveVTU (``data_thread.rs:769-786``): export the 3-D voxel
        instances of the final slot (the dense extraction) with the current
        3-D view settings."""
        self._ensure_open_finalized()
        out = self.pipeline.output
        inp = self.pipeline.input
        if out is None or inp is None:
            return
        t = out.time.cpu().numpy()
        v0 = self.pipeline.valid_wh0 or (inp.width, inp.height)
        positions, rgba, *_ = extract_instances(
            out.data,
            time_span=float(t[-1] - t[0]) if len(t) > 1 else 1.0,
            scaling=out.scaling,
            original_dims=(v0[0], v0[1], inp.n_time),
            valid_grid=self.pipeline.valid_for(out),
            opacity_threshold=self.view3d["opacity_threshold"],
            contrast=self.view3d["contrast"],
            kernel_sigma=self.view3d["kernel_sigma"],
            kernel_radius=self.view3d["kernel_radius"],
        )
        export_to_vtk(positions, rgba, path)

    def open_psf(self, path: str):
        """OpenPSF (``data_thread.rs:797-812``): load a PSF ``.npz`` for the
        deconvolution. Takes effect at the next Apply."""
        self.pipeline.psf = load_psf(path)

    def apply_psf(self, psf):
        """ApplyPSF from the PSF tool (``data_thread.rs:787-796``)."""
        self.pipeline.psf = psf

    def apply_settings(self, s):
        """Apply persisted preferences (the reference loads its
        ``GuiSettingsContainer``, the serialized PSF included, before the
        first frame: ``main.rs:144-161``, ``gui/application.rs:134-170``)."""
        cfg = self.pipeline.config
        cfg.fft_log_plot = bool(s.fft_log_plot)
        cfg.avg_in_fourier_space = bool(s.avg_in_fourier_space)
        cfg.scale_factor = int(s.downscaling)
        self.sample_thickness = float(s.sample_thickness)
        self.view3d.update(
            opacity_threshold=float(s.opacity_threshold),
            contrast=float(s.contrast_3d),
            kernel_sigma=float(s.kernel_sigma),
            kernel_radius=int(s.kernel_radius),
        )
        if s.psf is not None and s.psf.is_loaded:
            self.pipeline.psf = s.psf

    def collect_settings(self):
        """The current preferences, for the exit autosave
        (``main.rs:116-126``)."""
        from thz_image_explorer_tpu_torch.utils.settings import Settings

        cfg = self.pipeline.config
        return Settings(
            fft_log_plot=bool(cfg.fft_log_plot),
            avg_in_fourier_space=bool(cfg.avg_in_fourier_space),
            downscaling=int(cfg.scale_factor),
            sample_thickness=float(self.sample_thickness),
            opacity_threshold=float(self.view3d["opacity_threshold"]),
            contrast_3d=float(self.view3d["contrast"]),
            kernel_sigma=float(self.view3d["kernel_sigma"]),
            kernel_radius=int(self.view3d["kernel_radius"]),
            psf=self.pipeline.psf,
        )

    # ------------------------------------------------- 3D view settings
    def set_3d_contrast(self, contrast: float):
        """Set3DContrast (``data_thread.rs:849-852``)."""
        self.view3d["contrast"] = float(contrast)

    def set_kernel_sigma(self, sigma: float):
        """SetKernelSigma (``data_thread.rs:845-848``)."""
        self.view3d["kernel_sigma"] = float(sigma)

    def set_kernel_radius(self, radius: int):
        """SetKernelRadius (``data_thread.rs:841-844``)."""
        self.view3d["kernel_radius"] = int(radius)

    def set_opacity_threshold(self, threshold: float):
        self.view3d["opacity_threshold"] = float(threshold)

    # ------------------------------------------------------- fft config
    def set_fft_window_low(self, low: float):
        self.pipeline.config.fft_window[0] = low
        self._rerun_from_fft()

    def set_fft_window_high(self, high: float):
        self.pipeline.config.fft_window[1] = high
        self._rerun_from_fft()

    def set_fft_window_type(self, window_type: WindowType):
        self.pipeline.config.fft_window_type = window_type
        self._rerun_from_fft()

    def set_avg_in_fourier_space(self, enabled: bool):
        self.pipeline.config.avg_in_fourier_space = enabled
        self._rerun_from_fft()

    def set_fft_log_plot(self, enabled: bool):
        """A display setting the GUI reads; nothing recomputes."""
        self.pipeline.config.fft_log_plot = enabled

    def set_fft_resolution(self, df: float):
        """SetFFTResolution stores the value and republishes
        (``UpdateType::Plot``, ``data_thread.rs:829-832``; the reference
        reads ``fft_df`` nowhere else)."""
        self.pipeline.config.fft_df = df
        self.publish()

    def set_downscaling(self, scale: int):
        """SetDownScaling re-runs from the scaling stage
        (``data_thread.rs:837-840``)."""
        self.pipeline.config.scale_factor = scale
        self._ensure_open_finalized()
        self.pipeline.run_from(self.pipeline.scaling_index)
        self.publish()

    def _rerun_from_fft(self):
        """FFT-window commands re-run from the fft stage
        (``data_thread.rs:813-836``)."""
        self._ensure_open_finalized()
        self.pipeline.run_from(self.pipeline.fft_index)
        self.publish()

    # ------------------------------------------------------- filters
    def update_filter(self, uuid: str, *, force: bool = False):
        """UpdateFilter from one filter's position; ``force=True`` is the
        deconvolution's Apply button (the rerun-suppression rule does not
        hold it back)."""
        self._ensure_open_finalized()
        self.pipeline.update_filter(uuid, force=force)
        self.publish()

    def update_filters(self):
        """Calculate All: the whole chain, the deconvolution included."""
        self._ensure_open_finalized()
        self.pipeline.update_all()
        self.publish()

    def set_filter_param(self, uuid: str, key: str, value):
        """Set one filter parameter where ``FilterStage.param_owner`` puts
        it (an unknown key is ignored), coerced to the type of the current
        value (the UI sends every number as a float, and integer fields
        such as ``n_filters`` must stay integers). Takes effect at the
        next ``update_filter``."""
        target = self.pipeline.filters[uuid].param_owner(key)
        if target is None:
            return
        cur = getattr(target, key)
        if isinstance(cur, bool):
            value = bool(value)
        elif isinstance(cur, (int, float)):
            value = type(cur)(value)
        setattr(target, key, value)

    def set_filter_active(self, uuid: str, active: bool):
        """Toggle a filter; a change re-runs the chain from it. Switching
        the deconvolution on does not: it waits for Apply, while switching
        it off re-runs to remove its effect (``filters/filter.rs:590-605``)."""
        stage = self.pipeline.filters[uuid]
        changed = stage.active != active
        stage.active = active
        if changed and (not stage.is_deconvolution or not active):
            self.update_filter(uuid)

    # ------------------------------------------------------- selection
    def set_selected_pixel(self, x: int, y: int):
        """A pixel click: re-publish the selection only
        (``data_thread.rs:853-903``). Stages whose class overrides
        ``FilterStage.show_data`` (no built-in one does) first get the final
        slot (``Pipeline.materialize_output``) and the pixel in its
        downscaled coordinates, clamped to its valid region
        (``data_thread.rs:858``); with none, a click does nothing more."""
        self.pixel_selected = [max(int(x), 0), max(int(y), 0)]
        hooks = [f for f in self.pipeline.filters.values()
                 if type(f).show_data is not FilterStage.show_data]
        if hooks:
            self._ensure_open_finalized()
            out = self.pipeline.materialize_output()
            if out is not None:
                s = max(out.scaling, 1)
                vw, vh = self.pipeline.valid_for(out) or (out.width, out.height)
                pixel = (min(self.pixel_selected[0] // s, vw - 1),
                         min(self.pixel_selected[1] // s, vh - 1))
                for f in hooks:
                    f.show_data(out, pixel)
        self.publish()

    # ------------------------------------------------------- ROIs
    def add_roi(self, uuid: str, name: str, polygon: Optional[list]):
        """Add or replace an ROI; a polygon of None is a pseudo-ROI entry
        (it has a spectrum only when :meth:`open_ref` made it)."""
        coords = None if polygon is None else [(int(x), int(y)) for x, y in polygon]
        self.rois[uuid] = (name, coords)
        self.publish()

    def update_roi(self, uuid: str, name: str, polygon: list):
        self.add_roi(uuid, name, polygon)

    def delete_roi(self, uuid: str):
        self.rois.pop(uuid, None)
        self._datasets.pop(uuid, None)
        self.publish()

    # ------------------------------------------------- material params
    def set_reference(self, name: str):
        self.reference_selection = name
        self.publish()

    def set_sample(self, name: str):
        self.sample_selection = name
        self.publish()

    def set_material_thickness(self, thickness: float):
        self.sample_thickness = thickness
        self.publish()

    def update_material_calculation(self):
        self.publish()

    # ------------------------------------------------------- publish
    def publish(self):
        """Publish the plot series and the intensity image of the current
        slots (the ``data_lock`` write, ``data_thread.rs:1336-1560``).
        A pending open is finalized first."""
        with spans.span("publish"):
            self._ensure_open_finalized()
            final = self.pipeline.output
            if self.pipeline.input is None or final is None:
                self.plot = PlotData()
                return
            poly_rois = [(u, name, poly) for u, (name, poly) in self.rois.items()
                         if poly is not None]
            masks, roi_key = self._roi_masks(poly_rois, final)
            optical = self._optical_request(poly_rois, final.n_freq)
            # pseudo entries build no mask, but a pseudo entry added, renamed or
            # deleted still changes the key of what the publisher caches
            pseudo_key = tuple((u, name) for u, (name, poly) in self.rois.items() if poly is None)
            host = self.publisher.publish(
                self.pipeline, masks, (roi_key, pseudo_key), tuple(self.pixel_selected), optical
            )
            plot = PlotData()
            for key in ("time", "signal", "frequencies", "signal_fft", "phase_fft",
                        "filtered_time", "filtered_signal", "filtered_frequencies",
                        "filtered_signal_fft", "filtered_phase_fft", "avg_signal",
                        "avg_signal_fft", "avg_phase_fft"):
                setattr(plot, key, host[key])
            v0 = self.pipeline.valid_wh0
            self.image = host["image"][: v0[0], : v0[1]]
            for i, (uuid, name, _poly) in enumerate(poly_rois):
                plot.roi_signal[uuid] = (name, host["roi_trace"][i])
                plot.roi_signal_fft[uuid] = (name, host["roi_amp"][i])
                plot.roi_phase[uuid] = (name, host["roi_ph"][i])
            for uuid, (name, poly) in self.rois.items():
                data = self._datasets.get(uuid) if poly is None else None
                if data is not None:
                    plot.roi_signal[uuid] = (name, data[0])
                    plot.roi_signal_fft[uuid] = (name, data[1])
                    plot.roi_phase[uuid] = (name, data[2])
            if optical is not None:
                plot.refractive_index = host["refractive_index"]
                plot.absorption_coefficient = host["absorption_coefficient"]
                plot.extinction_coefficient = host["extinction_coefficient"]
            plot.available_references = [name for name, _p in self.rois.values()]
            plot.available_samples = plot.available_references + [SELECTED_PIXEL]
            self.plot = plot

    def _polygon_rois(self) -> dict:
        return {u: entry for u, entry in self.rois.items() if entry[1] is not None}

    def _optical_request(self, poly_rois, nf: int) -> Optional[dict]:
        """The optical-property selection (``data_thread.rs:1489-1559``):
        the reference and the sample each resolve by name to the first ROI
        of that name, a polygon ROI (its index in ``poly_rois``) or a loaded
        pulse (its host amplitude and phase, mode "pseudo"); the sample may
        also be the selected pixel. None when either does not resolve. A
        pulse whose bin count differs from the final slot's ``nf`` (another
        time axis, e.g. after a tilt) is skipped with one warning per
        (selection, bins) pair."""
        roi_index = {u: i for i, (u, _n, _p) in enumerate(poly_rois)}

        def resolve(name):
            uuid = next((u for u, (n, _p) in self.rois.items() if n == name), None)
            if uuid is None:
                return None
            if uuid in roi_index:
                return "roi", roi_index[uuid], None
            data = self._datasets.get(uuid)
            if data is None:
                return None
            if len(data[1]) != nf:
                key = (uuid, len(data[1]), nf)
                if key not in self._warned_optical:
                    self._warned_optical.add(key)
                    log.warning(
                        "optical selection %r skipped: its spectrum has %d frequency "
                        "bins but the scan has %d (different time axis); reload it "
                        "after opening this scan", name, len(data[1]), nf)
                return None
            return "pseudo", 0, np.stack([data[1], data[2]]).astype(np.float32)

        ref = resolve(self.reference_selection)
        if ref is None:
            return None
        opt = {"ref_mode": ref[0], "ref_idx": ref[1], "ref_pseudo": ref[2],
               "thickness": self.sample_thickness}
        if self.sample_selection == SELECTED_PIXEL:
            opt["samp_mode"] = "pixel"
            return opt
        samp = resolve(self.sample_selection)
        if samp is None:
            return None
        opt.update(samp_mode=samp[0], samp_idx=samp[1], samp_pseudo=samp[2])
        return opt

    def _roi_masks(self, poly_rois, final) -> tuple[torch.Tensor, tuple]:
        """(R, X, Y) f32 mask stack of the polygon ROIs on the final slot's
        (possibly downscaled) grid, on the device, plus its cache key.
        Each polygon is rasterized once per grid."""
        with spans.span("publish.masks"):
            shape = (final.width, final.height)
            valid = tuple(final.valid_wh)
            geom = (shape, valid, final.scaling)
            key = (tuple((u, tuple(poly)) for u, _n, poly in poly_rois), geom)
            if key != self._mask_key:
                stack = np.zeros((len(poly_rois),) + shape, np.float32)
                masks = {}
                for i, (_u, _n, poly) in enumerate(poly_rois):
                    pkey = (tuple(poly), geom)
                    m = self._poly_masks.get(pkey)
                    if m is None:
                        m = polygon_mask(poly, valid, final.scaling)
                    masks[pkey] = m
                    stack[i, : valid[0], : valid[1]] = m
                self._poly_masks = masks
                self._mask_stack = torch.as_tensor(stack, device=self.device)
                self._mask_key = key
            return self._mask_stack, key


def _align_reference(signal, time: np.ndarray, scan_time: np.ndarray) -> np.ndarray:
    """Resize and align a reference pulse onto the scan's time axis
    (``data_thread.rs:405-481``): placed by the offset of its first sample
    in steps of its own dt, zero-filled; both adjustments are logged."""
    signal = np.asarray(signal, np.float32)
    if len(scan_time) == len(signal) and (
        len(time) == 0 or abs(scan_time[0] - time[0]) <= 1e-9
    ):
        return signal
    target_len = len(scan_time)
    if len(signal) != target_len:
        log.warning("reference pulse resized from %d to %d samples to match the "
                    "scan's time axis", len(signal), target_len)
    out = np.zeros(target_len, np.float32)
    if len(scan_time) > 1 and len(time) > 1:
        ref_dt = time[1] - time[0]
        scan_dt = scan_time[1] - scan_time[0]
        if abs(float(ref_dt) - float(scan_dt)) > 1e-9:
            log.warning("time steps of scan (%.4g ps) and reference (%.4g ps) do not "
                        "match; the aligned reference trace is approximate",
                        float(scan_dt), float(ref_dt))
        offset = int(np.round((scan_time[0] - time[0]) / ref_dt))
        src_start = offset if offset > 0 else 0
        dst_start = -offset if offset < 0 else 0
        copy_len = min(len(signal) - src_start, target_len - dst_start)
        if copy_len > 0:
            out[dst_start: dst_start + copy_len] = signal[src_start: src_start + copy_len]
        return out
    n = min(target_len, len(signal))
    out[:n] = signal[:n]
    return out
