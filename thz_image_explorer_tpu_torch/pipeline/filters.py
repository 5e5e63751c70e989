"""Built-in filter stages.

Port of ``thz_image_explorer_tpu/pipeline/filters.py``: the time-domain
band-passes before the FFT and after the iFFT, the frequency-domain
band-pass and the water-vapor notch, with the same uuids, parameters and
defaults (the reference's ``src/filters/``). Tilt compensation
and deconvolution are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from thz_image_explorer_tpu_torch.assets.water_lines import WATER_LINES_THZ
from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.ops import bandpass as bp
from thz_image_explorer_tpu_torch.pipeline.stage import (
    FilterConfig,
    FilterDomain,
    FilterStage,
    StageContext,
    register_filter,
)


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
        return cube.replace(data=bp.td_bandpass(
            cube.data, cube.time, self.low, self.high, self.window_width
        ))

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
        fft, amplitudes = bp.fd_bandpass(
            cube.fft, cube.amplitudes, cube.freq, self.low, self.high,
            self.window_width,
        )
        return cube.replace(fft=fft, amplitudes=amplitudes)

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
        fft, amplitudes = bp.water_notch(
            cube.fft, cube.amplitudes, cube.freq, self._lines_on(cube.freq),
            self.notch_width, self.depth,
        )
        return cube.replace(fft=fft, amplitudes=amplitudes)

    def fd_weight_vector(self, freq: torch.Tensor) -> torch.Tensor:
        """The stage's whole effect as a per-frequency weight."""
        return bp.water_notch_weights(
            freq, self._lines_on(freq), self.notch_width, self.depth
        )

    def _lines_on(self, freq: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self._lines, device=freq.device)
