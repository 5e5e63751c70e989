"""Gaussian-beam physics diagnostics.

The port's own copy of ``thz_image_explorer_tpu/psf_tool/diagnostics.py``
(the reference's ``psf_tool/diagnostics.rs``): checks
whether the fitted beam widths behave like a diffraction-limited system —
the ratio ``π·w0/λ``, the implied effective aperture ``D_eff = λ·F/(π·w0)``
vs a constant-aperture theory, a linear fit ``w0 = A·λ``, Rayleigh ranges
``z_R = π·w0²/λ`` — with the diffraction-limited verdict based on the
coefficient of variation of D_eff (< 5 % on both axes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

C_LIGHT = 299_792_458.0  # m/s
FOCAL_LENGTH_MM = 152.4  # 6 inches, measured at 1 THz (diagnostics.rs:6)


def _linear_fit(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    n = len(x)
    sx, sy = x.sum(), y.sum()
    sxy = (x * y).sum()
    sx2 = (x * x).sum()
    a = (n * sxy - sx * sy) / (n * sx2 - sx * sx)
    b = (sy - a * sx) / n
    return float(a), float(b)


def _mean_std(v: np.ndarray) -> tuple[float, float]:
    m = float(v.mean())
    return m, float(np.sqrt(((v - m) ** 2).mean()))


@dataclasses.dataclass
class DiagnosticResults:
    frequencies_thz: np.ndarray
    wavelengths_um: np.ndarray
    w0x_mm: np.ndarray
    w0y_mm: np.ndarray
    freq_ref_thz: float
    lambda_ref_um: float
    w0x_ref_mm: float
    w0y_ref_mm: float
    ratio_x: np.ndarray
    ratio_y: np.ndarray
    ratio_x_mean: float
    ratio_x_std: float
    ratio_y_mean: float
    ratio_y_std: float
    ratio_x_mean_filtered: float
    ratio_x_std_filtered: float
    ratio_y_mean_filtered: float
    ratio_y_std_filtered: float
    d_eff_x_mm: np.ndarray
    d_eff_y_mm: np.ndarray
    d_eff_x_mean_mm: float
    d_eff_x_std_mm: float
    d_eff_y_mean_mm: float
    d_eff_y_std_mm: float
    d_eff_x_mean_filtered_mm: float
    d_eff_x_std_filtered_mm: float
    d_eff_y_mean_filtered_mm: float
    d_eff_y_std_filtered_mm: float
    d_eff_x_theory_mm: float
    d_eff_y_theory_mm: float
    a_x: float
    a_y: float
    w0_fit_x_mm: np.ndarray
    w0_fit_y_mm: np.ndarray
    rmse_x_mm: float
    rmse_y_mm: float
    w0_theory_x_mm: np.ndarray
    w0_theory_y_mm: np.ndarray
    rmse_theory_x_mm: float
    rmse_theory_y_mm: float
    z_r_x_mm: np.ndarray
    z_r_y_mm: np.ndarray
    z_r_fit_x_mm: np.ndarray
    z_r_fit_y_mm: np.ndarray
    z_r_theory_x_mm: np.ndarray
    z_r_theory_y_mm: np.ndarray
    is_diffraction_limited: bool
    cv_x_percent: float
    cv_y_percent: float

    @staticmethod
    def compute(
        frequencies_thz,
        w0x_mm,
        w0y_mm,
        focal_length_mm: float = FOCAL_LENGTH_MM,
        freq_ref_thz: float = 1.0,
    ) -> "DiagnosticResults":
        f_thz = np.asarray(frequencies_thz, np.float64)
        w0x = np.asarray(w0x_mm, np.float64)
        w0y = np.asarray(w0y_mm, np.float64)
        if len(f_thz) != len(w0x) or len(f_thz) != len(w0y):
            raise ValueError("input arrays must have the same length")
        if len(f_thz) == 0:
            raise ValueError("input arrays cannot be empty")

        freq_hz = f_thz * 1e12
        lam_m = C_LIGHT / freq_hz
        w0x_m = w0x * 1e-3
        w0y_m = w0y * 1e-3
        f_m = focal_length_mm * 1e-3

        idx_ref = int(np.argmin(np.abs(freq_hz - freq_ref_thz * 1e12)))
        lam_ref = lam_m[idx_ref]

        ratio_x = np.pi * w0x_m / lam_m
        ratio_y = np.pi * w0y_m / lam_m
        rxm, rxs = _mean_std(ratio_x)
        rym, rys = _mean_std(ratio_y)

        sub = f_thz < 1.0
        rxm_f, rxs_f = _mean_std(ratio_x[sub]) if sub.any() else (rxm, rxs)
        rym_f, rys_f = _mean_std(ratio_y[sub]) if sub.any() else (rym, rys)

        d_eff_x = f_m / ratio_x
        d_eff_y = f_m / ratio_y
        dxm, dxs = _mean_std(d_eff_x)
        dym, dys = _mean_std(d_eff_y)
        dxm_f, dxs_f = (
            _mean_std(d_eff_x[sub] * 1e3) if sub.any() else (dxm * 1e3, dxs * 1e3)
        )
        dym_f, dys_f = (
            _mean_std(d_eff_y[sub] * 1e3) if sub.any() else (dym * 1e3, dys * 1e3)
        )

        d_eff_x_th = lam_ref * f_m / (np.pi * w0x_m[idx_ref])
        d_eff_y_th = lam_ref * f_m / (np.pi * w0y_m[idx_ref])

        a_x, _ = _linear_fit(lam_m, w0x_m)
        a_y, _ = _linear_fit(lam_m, w0y_m)
        w0_fit_x = a_x * lam_m
        w0_fit_y = a_y * lam_m
        rmse_x = float(np.sqrt(((w0x_m - w0_fit_x) ** 2).mean())) * 1e3
        rmse_y = float(np.sqrt(((w0y_m - w0_fit_y) ** 2).mean())) * 1e3

        w0_th_x = lam_m * f_m / (np.pi * d_eff_x_th)
        w0_th_y = lam_m * f_m / (np.pi * d_eff_y_th)
        rmse_th_x = float(np.sqrt(((w0x_m - w0_th_x) ** 2).mean())) * 1e3
        rmse_th_y = float(np.sqrt(((w0y_m - w0_th_y) ** 2).mean())) * 1e3

        z_r_x = np.pi * w0x_m**2 / lam_m
        z_r_y = np.pi * w0y_m**2 / lam_m
        z_r_fit_x = np.pi * a_x**2 * lam_m
        z_r_fit_y = np.pi * a_y**2 * lam_m
        z_r_th_x = np.pi * w0_th_x**2 / lam_m
        z_r_th_y = np.pi * w0_th_y**2 / lam_m

        cv_x = dxs / dxm * 100.0
        cv_y = dys / dym * 100.0

        return DiagnosticResults(
            frequencies_thz=f_thz,
            wavelengths_um=lam_m * 1e6,
            w0x_mm=w0x,
            w0y_mm=w0y,
            freq_ref_thz=freq_hz[idx_ref] / 1e12,
            lambda_ref_um=lam_ref * 1e6,
            w0x_ref_mm=w0x_m[idx_ref] * 1e3,
            w0y_ref_mm=w0y_m[idx_ref] * 1e3,
            ratio_x=ratio_x,
            ratio_y=ratio_y,
            ratio_x_mean=rxm,
            ratio_x_std=rxs,
            ratio_y_mean=rym,
            ratio_y_std=rys,
            ratio_x_mean_filtered=rxm_f,
            ratio_x_std_filtered=rxs_f,
            ratio_y_mean_filtered=rym_f,
            ratio_y_std_filtered=rys_f,
            d_eff_x_mm=d_eff_x * 1e3,
            d_eff_y_mm=d_eff_y * 1e3,
            d_eff_x_mean_mm=dxm * 1e3,
            d_eff_x_std_mm=dxs * 1e3,
            d_eff_y_mean_mm=dym * 1e3,
            d_eff_y_std_mm=dys * 1e3,
            d_eff_x_mean_filtered_mm=dxm_f,
            d_eff_x_std_filtered_mm=dxs_f,
            d_eff_y_mean_filtered_mm=dym_f,
            d_eff_y_std_filtered_mm=dys_f,
            d_eff_x_theory_mm=d_eff_x_th * 1e3,
            d_eff_y_theory_mm=d_eff_y_th * 1e3,
            a_x=a_x,
            a_y=a_y,
            w0_fit_x_mm=w0_fit_x * 1e3,
            w0_fit_y_mm=w0_fit_y * 1e3,
            rmse_x_mm=rmse_x,
            rmse_y_mm=rmse_y,
            w0_theory_x_mm=w0_th_x * 1e3,
            w0_theory_y_mm=w0_th_y * 1e3,
            rmse_theory_x_mm=rmse_th_x,
            rmse_theory_y_mm=rmse_th_y,
            z_r_x_mm=z_r_x * 1e3,
            z_r_y_mm=z_r_y * 1e3,
            z_r_fit_x_mm=z_r_fit_x * 1e3,
            z_r_fit_y_mm=z_r_fit_y * 1e3,
            z_r_theory_x_mm=z_r_th_x * 1e3,
            z_r_theory_y_mm=z_r_th_y * 1e3,
            is_diffraction_limited=bool(cv_x < 5.0 and cv_y < 5.0),
            cv_x_percent=cv_x,
            cv_y_percent=cv_y,
        )

    def summary(self) -> str:
        lines = [
            "PSF Diagnostics",
            "===============",
            f"Reference: {self.freq_ref_thz:.3f} THz "
            f"(λ = {self.lambda_ref_um:.1f} µm), "
            f"w0x = {self.w0x_ref_mm:.3f} mm, w0y = {self.w0y_ref_mm:.3f} mm",
            f"π·w0/λ:  x = {self.ratio_x_mean:.2f} ± {self.ratio_x_std:.2f}, "
            f"y = {self.ratio_y_mean:.2f} ± {self.ratio_y_std:.2f}",
            f"D_eff:   x = {self.d_eff_x_mean_mm:.1f} ± {self.d_eff_x_std_mm:.1f} mm "
            f"(theory {self.d_eff_x_theory_mm:.1f} mm), "
            f"y = {self.d_eff_y_mean_mm:.1f} ± {self.d_eff_y_std_mm:.1f} mm "
            f"(theory {self.d_eff_y_theory_mm:.1f} mm)",
            f"w0 = A·λ fit: A_x = {self.a_x:.3f} (rmse {self.rmse_x_mm:.3f} mm), "
            f"A_y = {self.a_y:.3f} (rmse {self.rmse_y_mm:.3f} mm)",
            f"CV(D_eff): x = {self.cv_x_percent:.1f} %, y = {self.cv_y_percent:.1f} %",
            (
                "System is diffraction-limited (CV < 5 % both axes)."
                if self.is_diffraction_limited
                else "System is NOT diffraction-limited."
            ),
        ]
        return "\n".join(lines)
