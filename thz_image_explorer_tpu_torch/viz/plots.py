"""Plot-series math of the reference's center panel
(``gui/center_panel.rs``), frontend-agnostic.

The port's own copy of ``thz_image_explorer_tpu/viz/plots.py`` (host
numpy, the same values bit for bit)."""

from __future__ import annotations

import numpy as np


def stacked_pulse_series(
    signals: dict[str, np.ndarray],
) -> tuple[dict[str, np.ndarray], float]:
    """Min-offset stacking (``center_panel.rs:40-99``): every time-domain
    trace is shifted up by 1.05x the largest |min| across all traces so the
    pulses stack above zero. Returns (shifted signals, offset)."""
    offset = max(
        (abs(float(np.min(s))) for s in signals.values() if len(s)), default=0.0
    ) * 1.05
    return {k: np.asarray(s, np.float64) + offset for k, s in signals.items()}, offset


def fft_plot_series(
    amplitudes: np.ndarray,
    reference_amplitudes: np.ndarray | None = None,
    log_plot: bool = True,
) -> np.ndarray:
    """FFT display values: ``20·log10`` with a floor of ``min/5`` of the
    *raw* pixel spectrum (``center_panel.rs:207-231``)."""
    amp = np.asarray(amplitudes, np.float64)
    if not log_plot:
        return amp
    ref = amp if reference_amplitudes is None else np.asarray(reference_amplitudes)
    floor = float(ref.min()) / 5.0 if len(ref) else 0.0
    with np.errstate(divide="ignore"):
        # an exact-zero bin under a zero floor yields -inf, like the
        # reference's log10 (center_panel.rs:224-231); the web layer maps
        # non-finite values to null at the JSON boundary (web.py:67)
        return np.where(
            amp < floor,
            20.0 * np.log10(floor) if floor > 0.0 else -np.inf,
            20.0 * np.log10(amp),
        )


def dynamic_range_db(signal_fft: np.ndarray, log_plot: bool = True) -> float:
    """DR readout (``center_panel.rs:565-578``): mean of the last 100
    amplitude bins in dB, relative to the DISPLAYED plot's maximum
    (``center_panel.rs:335-342`` computes ``max_fft_signals`` from the
    plotted series — dB values when the log plot is on, raw amplitudes
    otherwise — clamped at −200).

    Lenient extensions over the reference: spectra shorter than 100
    bins average what exists (the reference's ``[len-100..len]`` slice
    panics there), and an empty spectrum returns 0."""
    amp = np.asarray(signal_fft, np.float64)
    if len(amp) == 0:
        return 0.0
    tail = amp[-100:]
    noise = float(tail.sum()) / min(len(amp), 100)
    shown = fft_plot_series(amp, log_plot=log_plot)
    max_fft = max(float(shown.max()), -200.0)
    return 20.0 * np.log10(abs(noise) + 1e-10) - max_fft


def peak_to_peak(signal: np.ndarray) -> float:
    """ptp readout in nA (``center_panel.rs:582-591``)."""
    s = np.asarray(signal, np.float64)
    if len(s) == 0:
        return 0.0
    return float(s.max() - s.min())
