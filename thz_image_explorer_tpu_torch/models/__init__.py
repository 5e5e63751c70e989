"""The frequency-resolved PSF model (splines + hybrid physical fits)."""

from thz_image_explorer_tpu_torch.models.psf import (  # noqa: F401
    PSF,
    CubicSplineCoeffs,
    HybridFit,
    create_psf_axes,
    gaussian,
)
