"""Beam fitting: knife-edge intensity profiles -> Gaussian beam parameters.

Port of ``thz_image_explorer_tpu/psf_tool/fitting.py`` (the reference's
``psf_tool/fitting.rs``). The erf-model knife-edge fit
``I(x) = (1 + erf(sqrt(2) (x - x0) / w)) / 2`` is a 2-parameter
Nelder-Mead per band on the host (scipy); the band filtering of every trace
with every band is one call of ``ops/firapply`` on the device, whose
filtered cube stays there while only the (B, P) intensities come back. The
per-band fits stay sequential: each is warm-started from the previous
band's optimum with monotonicity-constrained moving bounds
(``fitting.rs:287-442``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
from scipy.optimize import minimize

from thz_image_explorer_tpu_torch.ops import firapply


def erf_model(x, x0, w):
    """Knife-edge model: cumulative Gaussian (``fitting.rs:25-27``)."""
    from scipy.special import erf

    return (1.0 + erf(np.sqrt(2.0) * (x - x0) / w)) / 2.0


def compute_intensity(traces: np.ndarray) -> np.ndarray:
    """Sum of squares per position, min-max normalized
    (``fitting.rs:159-177``)."""
    intensity = (traces.astype(np.float64) ** 2).sum(axis=-1)
    lo, hi = intensity.min(), intensity.max()
    if abs(hi - lo) > 1e-10:
        intensity = (intensity - lo) / (hi - lo)
    return intensity


def fit_error_function(
    x_data: np.ndarray,
    y_data: np.ndarray,
    initial_guess: tuple[float, float],
    bounds: Optional[tuple[tuple[float, float], tuple[float, float]]] = None,
) -> tuple[float, float]:
    """2-parameter Nelder-Mead with penalty bounds (``fitting.rs:97-156``):
    the initial simplex ([x0, w], [x0 + 0.1, w], [x0, w + 0.1]), cost 1e10
    out of bounds, at most 8000 iterations."""
    x = np.asarray(x_data, np.float64)
    y = np.asarray(y_data, np.float64)

    def cost(p):
        x0, w = p
        if bounds is not None:
            (lo, hi) = bounds
            if x0 < lo[0] or x0 > hi[0] or w < lo[1] or w > hi[1]:
                return 1e10
        pred = erf_model(x, x0, w)
        return float(((y - pred) ** 2).sum())

    x0g, wg = initial_guess
    simplex = np.array([[x0g, wg], [x0g + 0.1, wg], [x0g, wg + 0.1]])
    res = minimize(
        cost,
        np.asarray(initial_guess, np.float64),
        method="Nelder-Mead",
        options={"initial_simplex": simplex, "maxiter": 8000, "xatol": 1e-8,
                 "fatol": 1e-12},
    )
    return float(res.x[0]), float(res.x[1])


@dataclasses.dataclass
class MeanBeamFit:
    x0: float
    y0: float
    popt_x: tuple[float, float]
    popt_y: tuple[float, float]


def fit_mean_beam(x_positions, y_positions, x_traces, y_traces) -> MeanBeamFit:
    """Broadband beam fit for the centre and the initial width
    (``fitting.rs:180-263``). The same knife half for both axes is fitted
    once."""
    ix = compute_intensity(np.asarray(x_traces))
    popt_x = fit_error_function(x_positions, ix, (0.0, 10.0))
    if y_traces is x_traces and y_positions is x_positions:
        popt_y = popt_x
    else:
        iy = compute_intensity(np.asarray(y_traces))
        popt_y = fit_error_function(y_positions, iy, (0.0, 10.0))
    return MeanBeamFit(x0=popt_x[0], y0=popt_y[0], popt_x=popt_x, popt_y=popt_y)


def filter_traces_all_bands(traces: np.ndarray, taps: np.ndarray, device=None) -> np.ndarray:
    """(P, T) traces x (B, L) taps -> (B, P, T) filtered traces as numpy:
    the reference's ``convolve``, a zero-boundary 'same' correlation
    (``fitting.rs:266-284``)."""
    return firapply.fir_correlate_bands(traces, taps, device=device)


def filter_and_intensity_all_bands(traces: np.ndarray, taps: np.ndarray, device=None):
    """(P, T) traces x (B, L) taps -> ``(filtered, intensities)``: the
    (B, P, T) cube as a tensor left on ``device`` and the (B, P) per-band
    normalized knife-edge curves as numpy. The erf fits read only the
    intensities."""
    return firapply.fir_correlate_bands_device(traces, taps, device=device)


@dataclasses.dataclass
class BeamFitParams:
    """(``fitting.rs:42-60``)"""

    w_max: float = 30.0
    use_monotonicity_constraint: bool = True


@dataclasses.dataclass
class BeamWidthFits:
    popt_xs: np.ndarray  # (B, 2)
    popt_ys: np.ndarray  # (B, 2)
    #: (B, P, T) float32 tensors on the filtering device
    filtered_traces_x: object
    filtered_traces_y: object
    x_positions: np.ndarray
    y_positions: np.ndarray


def fit_beam_widths(
    mean_fit: MeanBeamFit,
    x_positions,
    y_positions,
    x_traces,
    y_traces,
    taps: np.ndarray,
    fit_params: BeamFitParams,
    progress: Callable[[int, int], bool] = lambda _c, _t: True,
    device=None,
) -> Optional[BeamWidthFits]:
    """Per-band beam fits with warm starts and moving monotonic bounds
    (``fitting.rs:287-442``). Returns None when cancelled via ``progress``.

    The same traces, positions and warm start for both axes (the PSF tool
    fits one knife half for both) make the y chain bitwise the x chain: it
    is neither filtered nor fitted a second time."""
    n_filters = taps.shape[0]
    dedupe_y = (
        y_traces is x_traces
        and y_positions is x_positions
        and mean_fit.popt_y == mean_fit.popt_x
    )
    x_positions = np.asarray(x_positions, np.float64)
    y_positions = np.asarray(y_positions, np.float64)

    fx, ix_all = filter_and_intensity_all_bands(np.asarray(x_traces), taps, device)
    if y_traces is x_traces:
        fy, iy_all = fx, ix_all
    else:
        fy, iy_all = filter_and_intensity_all_bands(np.asarray(y_traces), taps, device)

    popt_xs = np.zeros((n_filters, 2))
    popt_ys = np.zeros((n_filters, 2))

    popt_x = (mean_fit.popt_x[0], fit_params.w_max)
    popt_y = (mean_fit.popt_y[0], fit_params.w_max)
    w_max = fit_params.w_max
    range_max = w_max * 1.5
    bounds_x = ((-range_max / 2.0, 0.01), (range_max / 2.0, w_max))
    bounds_y = ((-range_max / 2.0, 0.01), (range_max / 2.0, w_max))

    for nf in range(n_filters):
        popt_x = fit_error_function(x_positions, ix_all[nf], popt_x, bounds_x)
        if fit_params.use_monotonicity_constraint:
            x_off, w_x = popt_x
            bounds_x = ((-w_x / 2.0 + x_off, 0.0), (w_x / 2.0 + x_off, w_x))
        else:
            bounds_x = ((-range_max / 2.0, 0.01), (range_max / 2.0, w_max))

        if dedupe_y:
            popt_y, bounds_y = popt_x, bounds_x
        else:
            popt_y = fit_error_function(y_positions, iy_all[nf], popt_y, bounds_y)
            if fit_params.use_monotonicity_constraint:
                y_off, w_y = popt_y
                bounds_y = ((-w_y / 2.0 + y_off, 0.0), (w_y / 2.0 + y_off, w_y))
            else:
                bounds_y = ((-range_max / 2.0, 0.01), (range_max / 2.0, w_max))

        popt_xs[nf] = (popt_x[0], abs(popt_x[1]))
        popt_ys[nf] = (popt_y[0], abs(popt_y[1]))

        if not progress(nf + 1, n_filters):
            return None

    return BeamWidthFits(
        popt_xs=popt_xs,
        popt_ys=popt_ys,
        filtered_traces_x=fx,
        filtered_traces_y=fy,
        x_positions=x_positions,
        y_positions=y_positions,
    )
