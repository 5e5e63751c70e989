"""Runtime PSF model: frequency-resolved beam widths and centers.

The port's own copy of ``thz_image_explorer_tpu/models/psf.py`` (the
reference's ``filters/psf.rs``): cubic-spline coefficients for beam centers
and a hybrid fit (physical ``a/f + b`` base plus spline correction) for beam
widths, with the reference's constrained extrapolation rules. Evaluations
are host numpy: the values fix the deconvolution's band geometry (PSF
canvas sizes, iteration counts), which is host data.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass
class CubicSplineCoeffs:
    """Piecewise cubic ``S_i(x) = a + b·dx + c·dx² + d·dx³`` on knot
    intervals (``filters/psf.rs:6-14``)."""

    knots: np.ndarray
    values: np.ndarray
    coeff_a: np.ndarray
    coeff_b: np.ndarray
    coeff_c: np.ndarray
    coeff_d: np.ndarray

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, np.asarray(getattr(self, f.name), np.float32))

    def _segment(self, x: np.ndarray) -> np.ndarray:
        n = len(self.knots)
        idx = np.searchsorted(self.knots, x, side="right") - 1
        return np.clip(idx, 0, max(n - 2, 0))

    def _poly(self, x: np.ndarray, seg: np.ndarray) -> np.ndarray:
        dx = x - self.knots[seg]
        return (
            self.coeff_a[seg]
            + self.coeff_b[seg] * dx
            + self.coeff_c[seg] * dx * dx
            + self.coeff_d[seg] * dx * dx * dx
        )

    def _end_value_slope(self) -> tuple[float, float]:
        n = len(self.knots)
        i = n - 2
        dx_end = self.knots[n - 1] - self.knots[i]
        y_end = (
            self.coeff_a[i]
            + self.coeff_b[i] * dx_end
            + self.coeff_c[i] * dx_end**2
            + self.coeff_d[i] * dx_end**3
        )
        slope_end = (
            self.coeff_b[i]
            + 2.0 * self.coeff_c[i] * dx_end
            + 3.0 * self.coeff_d[i] * dx_end**2
        )
        return float(y_end), float(slope_end)

    def eval(self, x) -> np.ndarray:
        """Linear-tangent extrapolation clamped to >= 1e-6 outside the knot
        range (beam widths must stay positive; ``psf.rs:26-80``)."""
        x = np.asarray(x, np.float32)
        scalar = x.ndim == 0
        x = np.atleast_1d(x)
        if len(self.knots) == 0:
            out = np.zeros_like(x)
            return out[0] if scalar else out
        out = self._poly(x, self._segment(x))
        left = x < self.knots[0]
        if left.any():
            y0 = self.coeff_a[0]
            slope = self.coeff_b[0]
            out[left] = np.maximum(y0 + slope * (x[left] - self.knots[0]), 1e-6)
        right = x > self.knots[-1]
        if right.any():
            y_end, slope_end = self._end_value_slope()
            out[right] = np.maximum(
                y_end + slope_end * (x[right] - self.knots[-1]), 1e-6
            )
        return out[0] if scalar else out

    def eval_const_extrap(self, x) -> np.ndarray:
        """Constant extrapolation with the end ``values`` (beam centers;
        ``psf.rs:83-117``)."""
        x = np.asarray(x, np.float32)
        scalar = x.ndim == 0
        x = np.atleast_1d(x)
        if len(self.knots) == 0:
            out = np.zeros_like(x)
            return out[0] if scalar else out
        out = self._poly(x, self._segment(x))
        out[x < self.knots[0]] = self.values[0]
        out[x > self.knots[-1]] = self.values[-1]
        return out[0] if scalar else out


@dataclasses.dataclass
class HybridFit:
    """Beam-width model: physical ``a/f + b`` base plus spline correction
    with slope-constrained extrapolation (``filters/psf.rs:17-22,120-179``).

    The extrapolation slope is capped at ``a/f²`` so the *total* width
    derivative stays non-positive (width must not grow with frequency).
    """

    base_a: float
    base_b: float
    correction: CubicSplineCoeffs

    def eval(self, f) -> np.ndarray:
        f = np.asarray(f, np.float32)
        scalar = f.ndim == 0
        f = np.atleast_1d(f)
        base = self.base_a / f + self.base_b
        out = base + self._eval_correction(f)
        out = np.maximum(out, 1e-6)
        return out[0] if scalar else out

    def _eval_correction(self, f: np.ndarray) -> np.ndarray:
        c = self.correction
        if len(c.knots) == 0:
            return np.zeros_like(f)
        out = c._poly(f, c._segment(f))
        f_min, f_max = c.knots[0], c.knots[-1]
        left = f < f_min
        if left.any():
            max_slope = self.base_a / (f[left] * f[left])
            safe = np.minimum(c.coeff_b[0], max_slope)
            out[left] = c.coeff_a[0] + safe * (f[left] - f_min)
        right = f > f_max
        if right.any():
            y_end, slope_end = c._end_value_slope()
            max_slope = self.base_a / (f[right] * f[right])
            safe = np.minimum(slope_end, max_slope)
            out[right] = y_end + safe * (f[right] - f_max)
        return out


def _empty_spline() -> CubicSplineCoeffs:
    z = np.zeros(0, np.float32)
    return CubicSplineCoeffs(z, z, z, z, z, z)


@dataclasses.dataclass
class PSF:
    """Full PSF model (``filters/psf.rs:202-207``)."""

    wx_fit: HybridFit
    wy_fit: HybridFit
    x0_spline: CubicSplineCoeffs
    y0_spline: CubicSplineCoeffs

    @staticmethod
    def empty() -> "PSF":
        return PSF(
            HybridFit(0.0, 0.0, _empty_spline()),
            HybridFit(0.0, 0.0, _empty_spline()),
            _empty_spline(),
            _empty_spline(),
        )

    @property
    def is_loaded(self) -> bool:
        """The reference's loaded-check: non-empty wx correction knots
        (``deconvolution.rs:790``)."""
        return len(self.wx_fit.correction.knots) > 0

    def fingerprint(self) -> str:
        """Content digest of every coefficient array and base value: the
        deconvolution's plan-cache key. Two PSFs with equal content share
        a plan; a new PSF never aliases a stale one by object identity.
        Equal to the JAX package's digest for the same content."""
        h = hashlib.sha256()
        for fit in (self.wx_fit, self.wy_fit):
            h.update(np.float32(fit.base_a).tobytes())
            h.update(np.float32(fit.base_b).tobytes())
        for spline in (
            self.wx_fit.correction,
            self.wy_fit.correction,
            self.x0_spline,
            self.y0_spline,
        ):
            for f in dataclasses.fields(spline):
                arr = np.asarray(getattr(spline, f.name), np.float32)
                h.update(str(arr.shape).encode())
                h.update(arr.tobytes())
        return h.hexdigest()


def gaussian(x: np.ndarray, x0: float, w: float) -> np.ndarray:
    """Gaussian with the reference's normalization
    (``filters/psf.rs:326-332``): ``sqrt(2/π)·exp(−2(x−x0)²/w²)/w``."""
    x = np.asarray(x, np.float32)
    return (
        np.sqrt(2.0 / np.pi) * np.exp(-2.0 * (x - x0) ** 2 / (w * w)) / w
    ).astype(np.float32)


def create_psf_axes(
    psf_x: np.ndarray,
    psf_y: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    dx: float,
    dy: float,
) -> tuple[np.ndarray, np.ndarray]:
    """The two 1-D axis profiles whose outer product is the 2-D PSF
    (``filters/psf.rs:228-313``: the reference's PSF is exactly separable).

    Reproduces the reference's construction, including its grid: the
    output spans ``±floor(max(axis_mm))`` *integer* steps of size ``dx``
    (an int-floor of a millimetre value used as a step count), with
    per-axis max-normalization and zero-padding before linear
    interpolation.
    """
    psf_x = np.asarray(psf_x, np.float64).copy()
    psf_y = np.asarray(psf_y, np.float64).copy()
    x = np.asarray(x, np.float64).copy()
    y = np.asarray(y, np.float64).copy()

    psf_x /= psf_x.max()
    psf_y /= psf_y.max()

    x_max = int(np.floor(x.max()))
    y_max = int(np.floor(y.max()))

    factor = 2.0
    new_x_max = np.ceil(factor * x_max)
    new_y_max = np.ceil(factor * y_max)

    x_step = x[-1] - x[-2]
    y_step = y[-1] - y[-2]
    n_new_x = int(np.ceil((new_x_max - x[-1]) / x_step))
    n_new_y = int(np.ceil((new_y_max - y[-1]) / y_step))

    if n_new_x > 0:
        x = np.concatenate(
            [
                x[0] - x_step * np.arange(n_new_x, 0, -1),
                x,
                x[-1] + x_step * np.arange(1, n_new_x + 1),
            ]
        )
        psf_x = np.concatenate([np.zeros(n_new_x), psf_x, np.zeros(n_new_x)])
    if n_new_y > 0:
        y = np.concatenate(
            [
                y[0] - y_step * np.arange(n_new_y, 0, -1),
                y,
                y[-1] + y_step * np.arange(1, n_new_y + 1),
            ]
        )
        psf_y = np.concatenate([np.zeros(n_new_y), psf_y, np.zeros(n_new_y)])

    xx = np.arange(-x_max, x_max + 1, dtype=np.float64) * dx
    yy = np.arange(-y_max, y_max + 1, dtype=np.float64) * dy

    interp_x = np.interp(xx, x, psf_x)
    interp_y = np.interp(yy, y, psf_y)
    return interp_x.astype(np.float32), interp_y.astype(np.float32)


def create_psf_2d(
    psf_x: np.ndarray,
    psf_y: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    dx: float,
    dy: float,
) -> np.ndarray:
    """Dense 2-D PSF: the outer product of :func:`create_psf_axes`
    (``filters/psf.rs:228-313``); not sum-normalized."""
    px, py = create_psf_axes(psf_x, psf_y, x, y, dx, dy)
    return np.outer(px, py).astype(np.float32)
