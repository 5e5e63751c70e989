"""PSF ``.npz`` codec: the port's own copy of
``thz_image_explorer_tpu/io/psf_npz.py``.

Reads and writes the 28-array schema of the reference's PSF-tool export
(``psf_tool/export.rs:8-128``) and loader (``io.rs:190-267``): hybrid-fit
base coefficients plus correction-spline knots/values/coefficients for
wx/wy, and plain spline coefficients for the beam centers x0/y0. Values
are stored f64 and consumed f32, like the reference loader.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from thz_image_explorer_tpu_torch.models.psf import PSF, CubicSplineCoeffs, HybridFit

_SPLINE_FIELDS = (
    ("knots", "knots_thz"), ("values", "values_mm"), ("coeff_a", "coeff_a"),
    ("coeff_b", "coeff_b"), ("coeff_c", "coeff_c"), ("coeff_d", "coeff_d"),
)


def _arr(z, name: str) -> np.ndarray:
    return np.asarray(z[name], np.float64).reshape(-1)


def _scalar(z, name: str) -> float:
    a = _arr(z, name)
    if a.size == 0:
        raise ValueError(f"array {name} is empty")
    return float(a[0])


def _spline(z, prefix: str) -> CubicSplineCoeffs:
    return CubicSplineCoeffs(
        **{field: _arr(z, f"{prefix}_{key}") for field, key in _SPLINE_FIELDS}
    )


def _hybrid(z, prefix: str) -> HybridFit:
    return HybridFit(
        base_a=_scalar(z, f"{prefix}_base_a"),
        base_b=_scalar(z, f"{prefix}_base_b"),
        correction=_spline(z, f"{prefix}_corr"),
    )


def psf_from_arrays(z: Mapping[str, np.ndarray]) -> PSF:
    """A PSF from the 28 schema arrays (an open ``.npz`` or a dict)."""
    return PSF(
        wx_fit=_hybrid(z, "wx"),
        wy_fit=_hybrid(z, "wy"),
        x0_spline=_spline(z, "x0"),
        y0_spline=_spline(z, "y0"),
    )


def psf_to_arrays(psf: PSF) -> dict[str, np.ndarray]:
    """The 28 schema arrays of ``psf``, all f64."""

    def spline_entries(prefix: str, s: CubicSplineCoeffs) -> dict:
        return {
            f"{prefix}_{key}": np.asarray(getattr(s, field), np.float64)
            for field, key in _SPLINE_FIELDS
        }

    return {
        "wx_base_a": np.asarray([psf.wx_fit.base_a], np.float64),
        "wx_base_b": np.asarray([psf.wx_fit.base_b], np.float64),
        **spline_entries("wx_corr", psf.wx_fit.correction),
        "wy_base_a": np.asarray([psf.wy_fit.base_a], np.float64),
        "wy_base_b": np.asarray([psf.wy_fit.base_b], np.float64),
        **spline_entries("wy_corr", psf.wy_fit.correction),
        **spline_entries("x0", psf.x0_spline),
        **spline_entries("y0", psf.y0_spline),
    }


def load_psf(path: str) -> PSF:
    with np.load(path) as z:
        return psf_from_arrays(z)


def save_psf(path: str, psf: PSF):
    """Write the 28-key schema to exactly ``path`` (through an open handle:
    a bare ``np.savez`` would append ``.npz`` to a suffix-less path)."""
    with open(path, "wb") as fh:
        np.savez(fh, **psf_to_arrays(psf))
