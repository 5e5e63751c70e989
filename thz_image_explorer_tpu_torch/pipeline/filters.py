"""Built-in filter stages.

Port of ``thz_image_explorer_tpu/pipeline/filters.py``: tilt
compensation, the time-domain band-passes before the FFT and after the
iFFT, the frequency-domain band-pass, the water-vapor notch and the
deconvolution, with the same uuids, parameters and defaults (the
reference's ``src/filters/``).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from thz_image_explorer_tpu_torch.assets.water_lines import WATER_LINES_THZ
from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.ops import bandpass as bp
from thz_image_explorer_tpu_torch.ops import deconvolution as dec
from thz_image_explorer_tpu_torch.ops import tilt
from thz_image_explorer_tpu_torch.parallel.mesh import any_rank
from thz_image_explorer_tpu_torch.pipeline.stage import (
    FilterConfig,
    FilterDomain,
    FilterStage,
    StageContext,
    register_filter,
)
from thz_image_explorer_tpu_torch.utils import spans

log = logging.getLogger(__name__)


@register_filter
class TiltCompensation(FilterStage):
    """Per-pixel time shifts for tilted samples
    (``tilt_compensation.rs:97-226``); tilts in degrees (range ±15).
    Inactive by default like every toggleable filter at startup. The only
    stage that changes the time axis's length: the executor replans the
    frequency axis from ``host_time_out``."""

    def __init__(self):
        self.tilt_x = 0.0
        self.tilt_y = 0.0
        self.active = False

    def config(self) -> FilterConfig:
        return FilterConfig(
            name="Tilt Compensation",
            description="Compensate misalignment of the sample along x and y.",
            domain=FilterDomain.TIME_BEFORE_FFT_PRIO_FIRST,
        )

    def apply(self, cube: ScanCube, context: StageContext) -> ScanCube:
        return tilt.tilt_compensate(cube, self.tilt_x, self.tilt_y,
                                    valid_wh=context.valid_wh, host_time=context.time)

    def host_time_out(self, time: np.ndarray, cube: ScanCube, valid_wh) -> np.ndarray:
        num_steps = tilt.geometry(cube, self.tilt_x, self.tilt_y, valid_wh)
        if num_steps is None:
            return time
        return tilt.extended_time(time, num_steps)


class _TimeBandPass(FilterStage):
    """Shared TD band-pass behaviour: zero outside [low, high] ps with
    adapted-Blackman edges (``band_pass_td_before_fft.rs:124-182``)."""

    default_window_width = 2.0

    def __init__(self):
        self.low = 0.0
        self.high = 0.0
        self.window_width = self.default_window_width
        self.active = False

    def reset(self, time: np.ndarray, shape) -> None:
        # the reference resets the bounds to the full time range
        self.low = float(time[0]) if len(time) else 0.0
        self.high = float(time[-1]) if len(time) else 0.0

    def clamp_params(self, cube: ScanCube, time: np.ndarray) -> None:
        if len(time):
            self.low = max(self.low, float(time[0]))
            self.high = min(self.high, float(time[-1]))

    def apply(self, cube: ScanCube, context: StageContext) -> ScanCube:
        return cube.replace(data=cube.data * self.td_weight_vector(cube.time))

    def td_weight_vector(self, time: torch.Tensor) -> torch.Tensor:
        """The stage's whole effect as a per-time-sample weight."""
        return bp.td_bandpass_weights(time, self.low, self.high, self.window_width)


@register_filter
class TimeBandPassBeforeFFT(_TimeBandPass):
    default_window_width = 2.0

    def config(self) -> FilterConfig:
        return FilterConfig(
            name="Time Band Pass",
            description="Band-Pass Filter in Time Domain before the FFT.",
            domain=FilterDomain.TIME_BEFORE_FFT,
        )


@register_filter
class TimeBandPassAfterFFT(_TimeBandPass):
    default_window_width = 0.1  # band_pass_td_after_fft.rs default

    def config(self) -> FilterConfig:
        return FilterConfig(
            name="Time Band Pass (post-FFT)",
            description="Band-Pass Filter in Time Domain after the iFFT.",
            domain=FilterDomain.TIME_AFTER_FFT,
        )


@register_filter
class FrequencyBandPass(FilterStage):
    """FD band-pass (``band_pass_fd.rs``): defaults 0.2-5.0 THz, window
    width 0.1; complex spectrum and amplitudes weighted, phases untouched."""

    def __init__(self):
        self.low = 0.2
        self.high = 5.0
        self.window_width = 0.1
        self.active = False

    def config(self) -> FilterConfig:
        return FilterConfig(
            name="Frequency Band Pass",
            description="Band Pass Filter in Frequency Domain.",
            domain=FilterDomain.FREQUENCY,
        )

    def apply(self, cube: ScanCube, context: StageContext) -> ScanCube:
        return bp.weigh_spectrum(cube, self.fd_weight_vector(cube.freq))

    def fd_weight_vector(self, freq: torch.Tensor) -> torch.Tensor:
        """The stage's whole effect as a per-frequency weight."""
        return bp.fd_bandpass_weights(freq, self.low, self.high, self.window_width)


@register_filter
class WaterVaporNotch(FilterStage):
    """Comb of notches at atmospheric water-vapor lines (the reference only
    overlays these lines on plots, ``center_panel.rs:477-485``)."""

    def __init__(self):
        self.notch_width = 0.02  # THz half-width per line
        self.depth = 1.0  # 1 = full suppression
        self.active = False
        self._lines = np.asarray(WATER_LINES_THZ, np.float32)

    def config(self) -> FilterConfig:
        return FilterConfig(
            name="Water Vapor Notch",
            description=(
                "Suppress atmospheric water-vapor absorption lines with "
                "Blackman-shaped notches."
            ),
            domain=FilterDomain.FREQUENCY,
        )

    def apply(self, cube: ScanCube, context: StageContext) -> ScanCube:
        return bp.weigh_spectrum(cube, self.fd_weight_vector(cube.freq))

    def fd_weight_vector(self, freq: torch.Tensor) -> torch.Tensor:
        """The stage's whole effect as a per-frequency weight."""
        return bp.water_notch_weights(
            freq, self._lines_on(freq), self.notch_width, self.depth
        )

    def _lines_on(self, freq: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self._lines, device=freq.device)


@register_filter
class Deconvolution(FilterStage):
    """Frequency-resolved Richardson-Lucy deconvolution
    (``deconvolution.rs``; IEEE TTHZ.2025.3546756). Switching it on does not
    run it: only an explicit Apply does (``deconvolution.rs:1113-1116``),
    and the executor applies the rerun-suppression rule.

    The port never pads the pixel grid, so the stage deconvolves the whole
    cube; the JAX stage's crop to the valid region and re-insert
    (``_crop2`` / ``_insert2``) have no counterpart here. On a mesh the
    stage plans for the whole grid and runs ``deconvolve_cube``'s sharded
    form on the rank's block."""

    is_deconvolution = True

    def __init__(self):
        self.params = dec.DeconvolutionParams()
        self.active = False
        #: (plan key, geometry) of the last plan
        self._plan_cache = None

    def config(self) -> FilterConfig:
        return FilterConfig(
            name="Deconvolution",
            description=(
                "Frequency-dependent deconvolution for enhanced THz-TDS "
                "scans, accounting for beam width variations in time traces."
            ),
            domain=FilterDomain.TIME_AFTER_FFT_PRIO_LAST,
            hyperlink=("TTHZ.2025.3546756", "https://doi.org/10.1109/TTHZ.2025.3546756"),
        )

    def apply(self, cube: ScanCube, context: StageContext) -> ScanCube:
        context.progress(0.0)
        try:
            skip, geometry = self._skip_reason(cube, context), None
            if skip is None:
                geometry = self._geometry(cube, context)
                if geometry is None:
                    skip = "Deconvolution preconditions not met; skipping."
            # every rank of a mesh takes the same branch, or one would wait
            # in a collective the others never enter: one 4-byte all_reduce
            if context.mesh is not None:
                if any_rank(skip is not None, context.mesh, cube.device) and skip is None:
                    skip = "Another rank skips the deconvolution; skipping."
            if skip is not None:
                log.error(skip)
                return cube
            kw = {} if context.mesh is None else dict(
                mesh=context.mesh, origin=cube.origin, grid=cube.grid_wh)
            out = dec.deconvolve_cube(
                cube.data, geometry, progress=context.progress, cancelled=context.cancelled,
                **kw,
            )
            if out is None:  # cancelled
                return cube
            return cube.replace(data=out)
        finally:
            context.progress(None)

    @staticmethod
    def _skip_reason(cube: ScanCube, context: StageContext):
        if cube.dx is None or cube.dy is None:
            return "No spatial resolution (dx/dy); skipping deconvolution."
        psf = context.psf
        if psf is None or not psf.is_loaded:
            return "No PSF loaded; skipping deconvolution."
        return None

    def _geometry(self, cube: ScanCube, context: StageContext):
        """The band plan for the whole pixel grid (a rank's block of a
        sharded cube is deconvolved as part of it), cached on its inputs."""
        with spans.span("deconv.plan"):
            psf = context.psf
            time = context.time if context.time is not None else cube.time.cpu().numpy()
            # keyed on the PSF's content, not its id(): a new PSF allocated
            # at a freed one's address must not hit a stale plan
            key = (
                dataclasses.astuple(self.params), psf.fingerprint(), time.shape,
                float(time[0]), float(time[-1]), cube.grid_wh, cube.dx, cube.dy,
            )
            if self._plan_cache is None or self._plan_cache[0] != key:
                self._plan_cache = (key, dec.plan_bands(
                    self.params, psf, time, cube.grid_wh, cube.dx, cube.dy,
                ))
            return self._plan_cache[1]
