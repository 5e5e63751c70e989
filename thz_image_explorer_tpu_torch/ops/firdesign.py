"""Kaiser-windowed FIR filter-bank design (host, float64).

The port's own copy of ``thz_image_explorer_tpu/ops/firdesign.py`` (the
reference's ``deconvolution.rs:30-211`` firwin-style design). Filter
design is cheap, parameter-dependent host math that produces static band
data, so it stays numpy f64 and gives the JAX package's taps bit for bit.

Design rules (``deconvolution.rs:134-211``):

* Kaiser attenuation ``2.285·(ntaps−1)·π·width_ratio + 7.95``, beta via the
  standard Kaiser formula;
* low-pass = Kaiser-windowed sinc normalized to unit DC gain, with the
  window forced to 0 at its endpoints and even tap counts handled by
  designing odd and appending a zero;
* high-pass by spectral inversion; band-pass = hp(low) − hp(high);
* bank: log- (or linear-) spaced centers, band edges at the geometric means
  of neighbouring centers; the first/last bands degenerate to low-/high-pass.
"""

from __future__ import annotations

import numpy as np

NTAPS = 499  # deconvolution.rs:167


def kaiser_atten(ntaps: int, width_ratio: float) -> float:
    return max(2.285 * (ntaps - 1) * np.pi * width_ratio + 7.95, 0.0)


def kaiser_beta(atten: float) -> float:
    if atten > 50.0:
        return 0.1102 * (atten - 8.7)
    if atten >= 21.0:
        return 0.5842 * (atten - 21.0) ** 0.4 + 0.07886 * (atten - 21.0)
    return 0.0


def bessel_i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel I0 via the truncated power series the reference uses
    (50 terms, relative tail < 1e-12 for the betas that occur here)."""
    x = np.asarray(x, np.float64)
    x_half_sq = (x / 2.0) ** 2
    total = np.ones_like(x)
    term = np.ones_like(x)
    for k in range(1, 50):
        term = term * x_half_sq / (k * k)
        total = total + term
    return total


def _sinc(x: np.ndarray) -> np.ndarray:
    """sin(x)/x (unnormalized argument)."""
    out = np.ones_like(x)
    nz = np.abs(x) >= 1e-10
    out[nz] = np.sin(x[nz]) / x[nz]
    return out


def _kaiser_window(n_taps: int, beta: float) -> np.ndarray:
    n = np.arange(n_taps, dtype=np.float64)
    arg = 2.0 * n / (n_taps - 1.0) - 1.0
    w = bessel_i0(beta * np.sqrt(np.maximum(1.0 - arg * arg, 0.0))) / bessel_i0(
        np.float64(beta)
    )
    w[0] = 0.0  # the reference zeroes the endpoints
    w[-1] = 0.0
    return w


def firwin_lowpass(n_taps: int, cutoff_hz: float, beta: float, fs: float) -> np.ndarray:
    adjusted = n_taps - 1 if n_taps % 2 == 0 else n_taps
    mid = (adjusted - 1) / 2.0
    cutoff = cutoff_hz / fs
    n = np.arange(adjusted, dtype=np.float64)
    taps = _sinc(2.0 * np.pi * cutoff * (n - mid)) * _kaiser_window(adjusted, beta)
    s = taps.sum()
    if abs(s) > 1e-10:
        taps = taps / s
    if n_taps % 2 == 0:
        taps = np.append(taps, 0.0)
    return taps


def firwin_highpass(n_taps: int, cutoff_hz: float, beta: float, fs: float) -> np.ndarray:
    adjusted = n_taps - 1 if n_taps % 2 == 0 else n_taps
    mid = (adjusted - 1) / 2.0
    taps = firwin_lowpass(adjusted, cutoff_hz, beta, fs)
    taps = -taps
    taps[int(mid)] += 1.0  # spectral inversion: delta - lowpass
    if n_taps % 2 == 0:
        taps = np.append(taps, 0.0)
    return taps


def bandpass_kaiser(
    ntaps: int, lowcut: float, highcut: float, fs: float, width: float
) -> np.ndarray:
    width_ratio = width / (0.5 * fs)
    beta = kaiser_beta(kaiser_atten(ntaps, width_ratio))
    if lowcut <= 0.0:
        return firwin_lowpass(ntaps, highcut, beta, fs)
    if highcut >= 0.5 * fs:
        return firwin_highpass(ntaps, lowcut, beta, fs)
    return firwin_highpass(ntaps, lowcut, beta, fs) - firwin_highpass(
        ntaps, highcut, beta, fs
    )


def center_frequencies(
    n_filters: int, start_freq: float, end_freq: float, spacing: str = "log"
) -> np.ndarray:
    if spacing == "log":
        return np.exp(
            np.linspace(np.log(start_freq), np.log(end_freq), n_filters)
        )
    if spacing == "linear":
        return np.linspace(start_freq, end_freq, n_filters)
    raise ValueError(f"unknown spacing {spacing!r}")


def create_filter_bank(
    n_filters: int,
    start_freq: float,
    end_freq: float,
    win_width: float,
    time: np.ndarray,
    low_cut: float | None = None,
    high_cut: float | None = None,
    spacing: str = "log",
    ntaps: int = NTAPS,
) -> tuple[np.ndarray, np.ndarray]:
    """Bank of ``n_filters`` FIRs, shape ``(n_filters, ntaps)``, plus the
    center frequencies.

    ``low_cut``/``high_cut`` default to the deconvolution variant's 0 and
    Nyquist (``deconvolution.rs:185-199``). Band edges are the geometric
    means of adjacent centers.
    """
    time = np.asarray(time, np.float64)
    dt = time[1] - time[0]
    fs = 1.0 / dt  # THz (time in ps)
    if low_cut is None:
        low_cut = 0.0
    if high_cut is None:
        high_cut = 0.5 * fs

    centers = center_frequencies(n_filters, start_freq, end_freq, spacing)
    bank = np.zeros((n_filters, ntaps), np.float64)
    for i, fc in enumerate(centers):
        lo = low_cut if i == 0 else float(np.sqrt(centers[i - 1] * fc))
        hi = high_cut if i == n_filters - 1 else float(np.sqrt(fc * centers[i + 1]))
        bank[i] = bandpass_kaiser(ntaps, lo, hi, fs, win_width)
    return bank, centers


def frequency_response(
    taps: np.ndarray, n_points: int, fs: float
) -> tuple[np.ndarray, np.ndarray]:
    """Magnitude response sampled at ``n_points`` up to fs/2
    (``psf_tool/filters.rs:280-304``)."""
    taps = np.asarray(taps, np.float64)
    k = np.arange(n_points)
    freqs = k * fs / (2.0 * n_points)
    omega = 2.0 * np.pi * freqs / fs
    n = np.arange(len(taps))
    phases = -np.outer(omega, n)
    mags = np.abs((taps * np.exp(1j * phases)).sum(axis=1))
    return freqs, mags
