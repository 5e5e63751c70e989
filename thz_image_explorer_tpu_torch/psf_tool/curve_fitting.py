"""Curve fitting for the PSF tool (float64 host math).

The port's own copy of ``thz_image_explorer_tpu/psf_tool/curve_fitting.py``
(the reference's ``psf_tool/curve_fitting.rs``): a natural
cubic spline (tridiagonal solve) and the hybrid physical fit
``w(f) = a/f + b + spline(residuals)`` with slope-constrained extrapolation
and a monotone-decreasing clip on array evaluation. Exact coefficient
parity matters: these coefficients round-trip through the ``.npz`` file
into the deconvolution filter's runtime PSF model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from thz_image_explorer_tpu_torch.models.psf import (
    PSF,
    CubicSplineCoeffs,
    HybridFit as RuntimeHybridFit,
)


@dataclasses.dataclass
class CubicSpline:
    """Natural cubic spline ``S_i(x) = a + b·dx + c·dx² + d·dx³``."""

    x: np.ndarray
    y: np.ndarray
    coeffs: np.ndarray  # (n-1, 4)

    @staticmethod
    def fit(x, y) -> "CubicSpline":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if len(x) != len(y):
            raise ValueError("x and y must have same length")
        if len(x) < 2:
            raise ValueError("need at least 2 points")
        order = np.argsort(x, kind="stable")
        xs, ys = x[order], y[order]
        n = len(xs)
        h = np.diff(xs)
        if (h <= 0).any():
            raise ValueError("x values must be strictly increasing")

        # natural boundary: second derivative zero at the ends; solve the
        # standard tridiagonal system for the c-coefficients
        a = np.zeros(n)
        b = np.zeros(n)
        c = np.zeros(n)
        d = np.zeros(n)
        b[0] = b[-1] = 1.0
        for i in range(1, n - 1):
            a[i] = h[i - 1]
            b[i] = 2.0 * (h[i - 1] + h[i])
            c[i] = h[i]
            d[i] = 3.0 * (
                (ys[i + 1] - ys[i]) / h[i] - (ys[i] - ys[i - 1]) / h[i - 1]
            )
        m = _solve_tridiagonal(a, b, c, d)

        coeffs = np.zeros((n - 1, 4))
        for i in range(n - 1):
            dx = h[i]
            dy = ys[i + 1] - ys[i]
            coeffs[i, 0] = ys[i]
            coeffs[i, 1] = dy / dx - dx * (2.0 * m[i] + m[i + 1]) / 3.0
            coeffs[i, 2] = m[i]
            coeffs[i, 3] = (m[i + 1] - m[i]) / (3.0 * dx)
        return CubicSpline(xs, ys, coeffs)

    # -- evaluation ---------------------------------------------------
    def _segment(self, x):
        return np.clip(
            np.searchsorted(self.x, x, side="right") - 1, 0, len(self.x) - 2
        )

    def _poly(self, x, seg):
        dx = x - self.x[seg]
        c = self.coeffs[seg]
        return c[..., 0] + c[..., 1] * dx + c[..., 2] * dx**2 + c[..., 3] * dx**3

    def _end_value_slope(self):
        i = len(self.x) - 2
        dxe = self.x[-1] - self.x[i]
        c = self.coeffs[i]
        y_end = c[0] + c[1] * dxe + c[2] * dxe**2 + c[3] * dxe**3
        slope = c[1] + 2.0 * c[2] * dxe + 3.0 * c[3] * dxe**2
        return y_end, slope

    def evaluate(self, xq) -> np.ndarray:
        """Tangent-linear extrapolation clamped positive (beam widths)."""
        xq = np.atleast_1d(np.asarray(xq, np.float64))
        out = self._poly(xq, self._segment(xq))
        left = xq < self.x[0]
        out[left] = np.maximum(
            self.coeffs[0, 0] + self.coeffs[0, 1] * (xq[left] - self.x[0]), 1e-6
        )
        right = xq > self.x[-1]
        if right.any():
            y_end, slope = self._end_value_slope()
            out[right] = np.maximum(y_end + slope * (xq[right] - self.x[-1]), 1e-6)
        return out

    def evaluate_const_extrap(self, xq) -> np.ndarray:
        """Constant extrapolation (beam centers)."""
        xq = np.atleast_1d(np.asarray(xq, np.float64))
        out = self._poly(xq, self._segment(xq))
        out[xq < self.x[0]] = self.y[0]
        out[xq > self.x[-1]] = self.y[-1]
        return out

    def to_runtime(self) -> CubicSplineCoeffs:
        return CubicSplineCoeffs(
            knots=self.x,
            values=self.y,
            coeff_a=self.coeffs[:, 0],
            coeff_b=self.coeffs[:, 1],
            coeff_c=self.coeffs[:, 2],
            coeff_d=self.coeffs[:, 3],
        )


def _solve_tridiagonal(a, b, c, d) -> np.ndarray:
    """Thomas algorithm (``curve_fitting.rs:349-375``)."""
    n = len(b)
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, n):
        denom = b[i] - a[i] * cp[i - 1]
        if abs(denom) < 1e-10:
            raise ValueError("tridiagonal system is singular")
        cp[i] = c[i] / denom
        dp[i] = (d[i] - a[i] * dp[i - 1]) / denom
    x = np.zeros(n)
    x[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return x


@dataclasses.dataclass
class HybridFitF64:
    """``w(f) = a/f + b`` least squares + spline of the residuals."""

    a: float
    b: float
    correction: CubicSpline

    @staticmethod
    def fit(frequencies, values) -> "HybridFitF64":
        f = np.asarray(frequencies, np.float64)
        w = np.asarray(values, np.float64)
        if len(f) != len(w):
            raise ValueError("frequencies and values must have same length")
        if len(f) < 3:
            raise ValueError("need at least 3 points for hybrid fit")
        inv_f = 1.0 / f
        # 2x2 normal equations for [a, b]
        s11 = (inv_f * inv_f).sum()
        s12 = inv_f.sum()
        s22 = float(len(f))
        r1 = (w * inv_f).sum()
        r2 = w.sum()
        det = s11 * s22 - s12 * s12
        if abs(det) < 1e-10:
            raise ValueError("singular base fit")
        a = (r1 * s22 - r2 * s12) / det
        b = (s11 * r2 - s12 * r1) / det
        residuals = w - (a / f + b)
        return HybridFitF64(a, b, CubicSpline.fit(f, residuals))

    def _eval_correction(self, f: np.ndarray) -> np.ndarray:
        c = self.correction
        out = c._poly(f, c._segment(f))
        f_min, f_max = c.x[0], c.x[-1]
        left = f < f_min
        if left.any():
            slope = np.minimum(c.coeffs[0, 1], self.a / (f[left] * f[left]))
            out[left] = c.coeffs[0, 0] + slope * (f[left] - f_min)
        right = f > f_max
        if right.any():
            y_end, slope_end = c._end_value_slope()
            slope = np.minimum(slope_end, self.a / (f[right] * f[right]))
            out[right] = y_end + slope * (f[right] - f_max)
        return out

    def evaluate(self, frequencies) -> np.ndarray:
        """Array evaluation with the monotone-decreasing clip
        (``curve_fitting.rs:113-130``)."""
        f = np.atleast_1d(np.asarray(frequencies, np.float64))
        out = self.a / f + self.b + self._eval_correction(f)
        # enforce monotonic decrease left to right
        np.minimum.accumulate(out, out=out)
        return out

    def to_runtime(self) -> RuntimeHybridFit:
        return RuntimeHybridFit(
            base_a=float(self.a),
            base_b=float(self.b),
            correction=self.correction.to_runtime(),
        )


@dataclasses.dataclass
class CurveFits:
    """Fitted beam-width and center curves (``curve_fitting.rs:377-400``)."""

    wx_fit: HybridFitF64
    wy_fit: HybridFitF64
    x0_fit: CubicSpline
    y0_fit: CubicSpline

    @staticmethod
    def fit_from_data(frequencies, wx, wy, x0, y0) -> "CurveFits":
        return CurveFits(
            wx_fit=HybridFitF64.fit(frequencies, wx),
            wy_fit=HybridFitF64.fit(frequencies, wy),
            x0_fit=CubicSpline.fit(frequencies, x0),
            y0_fit=CubicSpline.fit(frequencies, y0),
        )

    def to_runtime_psf(self) -> PSF:
        """Convert to the runtime PSF model consumed by deconvolution
        (the ``ApplyPSF`` handshake, ``psf_tool/app.rs:214-217``)."""
        return PSF(
            wx_fit=self.wx_fit.to_runtime(),
            wy_fit=self.wy_fit.to_runtime(),
            x0_spline=self.x0_fit.to_runtime(),
            y0_spline=self.y0_fit.to_runtime(),
        )
