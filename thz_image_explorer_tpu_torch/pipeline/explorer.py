"""Host API facade: the command surface of the application.

Port of ``thz_image_explorer_tpu/pipeline/explorer.py`` (reference
``ConfigCommand`` API, ``config.rs:58-164``, and the ``main_thread``
handlers, ``data_thread.rs:148-1050``) as plain synchronous methods. After
every command the Explorer publishes a :class:`PlotData` snapshot of small
host arrays; the cube itself never leaves the device.

``Explorer(device=None)`` runs on ``"cuda"`` and raises when CUDA is
missing; it never moves to the CPU on its own (tests pass ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import logging
import uuid as _uuidlib
from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import resolve_device
from thz_image_explorer_tpu_torch.io import dotthz as thzio
from thz_image_explorer_tpu_torch.ops.roi import polygon_mask
from thz_image_explorer_tpu_torch.ops.windows import WindowType
from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline
from thz_image_explorer_tpu_torch.pipeline.publish import Publisher

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
        hk = HouseKeeping()
        hk.dx = host.dx if host.dx is not None else 1.0
        hk.dy = host.dy if host.dy is not None else 1.0
        x0 = host.x_min if host.x_min is not None else 0.0
        y0 = host.y_min if host.y_min is not None else 0.0
        w, h = host.valid_wh
        hk.x_range = (x0, x0 + w * hk.dx)
        hk.y_range = (y0, y0 + h * hk.dy)
        if len(host.time):
            hk.t_begin = float(host.time[0])
            hk.range = float(host.time[-1] - host.time[0])
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
        #: uuid -> (name, polygon)
        self.rois: dict[str, tuple[str, list]] = {}
        self.sample_selection = ""
        self.reference_selection = ""
        self.sample_thickness = 1.0  # (application.rs:184)
        self.image: Optional[np.ndarray] = None
        self.file_path: Optional[str] = None
        self.housekeeping = HouseKeeping()
        self._mask_key = None
        self._mask_stack: Optional[torch.Tensor] = None
        self._poly_masks: dict = {}

    # ------------------------------------------------------------ files
    def open_file(self, path: str):
        """OpenFile (``data_thread.rs:589-740``): read the dotTHz file, move
        the scan to the device, run the chain and publish."""
        self._open(thzio.open_scan_host(path), path)

    def open_arrays(self, time, data, metadata: Optional[thzio.DotthzMetadata] = None):
        """Open a scan held in memory: a (T,) time axis and a raw (X, Y, T)
        cube (DC offset still in), with optional file metadata."""
        self._open(thzio.open_scan_arrays(time, data, metadata), None)

    def _open(self, host: thzio.HostScan, path: Optional[str]):
        # the device phase first: if it fails (e.g. out of memory) the
        # facade still describes the previous scan
        cube, _img = thzio.finalize_scan(host, self.device)
        self.pipeline.set_input(cube)
        self.metadata = host.metadata
        self.file_path = path
        # ROIs serialized in metadata come back (data_thread.rs:646-711)
        self.rois = {
            str(_uuidlib.uuid4()): (label, coords)
            for label, coords in host.metadata.get_rois()
        }
        self.pixel_selected = [0, 0]
        self.housekeeping = HouseKeeping.from_scan(host)
        self.housekeeping.apply_metadata(host.metadata.md)
        self.publish()

    def save_file(self, path: str):
        """SaveFile: initial cube + metadata with the ROIs
        (``data_thread.rs:741-768``)."""
        inp = self.pipeline.input
        if inp is None:
            return
        md = self.metadata
        if "time" not in md.ds_description:
            md.ds_description = ["time", "dataset"]
        md.set_rois(self.rois)
        thzio.save_scan(path, inp, md)

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

    def set_downscaling(self, scale: int):
        """SetDownScaling re-runs from the scaling stage
        (``data_thread.rs:837-840``)."""
        self.pipeline.config.scale_factor = scale
        self.pipeline.run_from(self.pipeline.scaling_index)
        self.publish()

    def _rerun_from_fft(self):
        """FFT-window commands re-run from the fft stage
        (``data_thread.rs:813-836``)."""
        self.pipeline.run_from(self.pipeline.fft_index)
        self.publish()

    # ------------------------------------------------------- filters
    def update_filter(self, uuid: str):
        self.pipeline.update_filter(uuid)
        self.publish()

    def update_filters(self):
        self.pipeline.update_all()
        self.publish()

    def set_filter_param(self, uuid: str, key: str, value):
        """Set one filter parameter, coerced to the type of its current
        value (the UI sends every number as a float). Takes effect at the
        next ``update_filter``."""
        f = self.pipeline.filters[uuid]
        if not hasattr(f, key):
            return
        cur = getattr(f, key)
        if isinstance(cur, bool):
            value = bool(value)
        elif isinstance(cur, (int, float)):
            value = type(cur)(value)
        setattr(f, key, value)

    def set_filter_active(self, uuid: str, active: bool):
        """Toggle a filter; a change re-runs the chain from it."""
        stage = self.pipeline.filters[uuid]
        changed = stage.active != active
        stage.active = active
        if changed:
            self.update_filter(uuid)

    # ------------------------------------------------------- selection
    def set_selected_pixel(self, x: int, y: int):
        """A pixel click: re-publish the selection only
        (``data_thread.rs:853-903``)."""
        self.pixel_selected = [max(int(x), 0), max(int(y), 0)]
        self.publish()

    # ------------------------------------------------------- ROIs
    def add_roi(self, uuid: str, name: str, polygon: list):
        self.rois[uuid] = (name, [(int(x), int(y)) for x, y in polygon])
        self.publish()

    def update_roi(self, uuid: str, name: str, polygon: list):
        self.add_roi(uuid, name, polygon)

    def delete_roi(self, uuid: str):
        self.rois.pop(uuid, None)
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

    # ------------------------------------------------------- publish
    def publish(self):
        """Publish the plot series and the intensity image of the current
        slots (the ``data_lock`` write, ``data_thread.rs:1336-1560``)."""
        final = self.pipeline.output
        if self.pipeline.input is None or final is None:
            self.plot = PlotData()
            return
        poly_rois = [(u, name, poly) for u, (name, poly) in self.rois.items()]
        masks, roi_key = self._roi_masks(poly_rois, final)
        optical = self._optical_request(poly_rois)
        host = self.publisher.publish(
            self.pipeline, masks, roi_key, tuple(self.pixel_selected), optical
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
        if optical is not None:
            plot.refractive_index = host["refractive_index"]
            plot.absorption_coefficient = host["absorption_coefficient"]
            plot.extinction_coefficient = host["extinction_coefficient"]
        plot.available_references = [name for _u, name, _p in poly_rois]
        plot.available_samples = plot.available_references + [SELECTED_PIXEL]
        self.plot = plot

    def _optical_request(self, poly_rois) -> Optional[dict]:
        """The optical-property selection (``data_thread.rs:1489-1559``):
        the reference is an ROI, the sample an ROI or the selected pixel;
        None when either does not resolve."""
        index = {}
        for i, (_u, name, _p) in enumerate(poly_rois):
            index.setdefault(name, i)  # the first ROI of a name wins
        if self.reference_selection not in index:
            return None
        opt = {"ref_idx": index[self.reference_selection],
               "thickness": self.sample_thickness}
        if self.sample_selection == SELECTED_PIXEL:
            opt["samp_mode"] = "pixel"
        elif self.sample_selection in index:
            opt["samp_mode"] = "roi"
            opt["samp_idx"] = index[self.sample_selection]
        else:
            return None
        return opt

    def _roi_masks(self, poly_rois, final) -> tuple[torch.Tensor, tuple]:
        """(R, X, Y) f32 mask stack of the polygon ROIs on the final slot's
        (possibly downscaled) grid, on the device, plus its cache key.
        Each polygon is rasterized once per grid."""
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
