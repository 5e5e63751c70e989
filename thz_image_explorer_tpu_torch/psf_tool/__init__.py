"""PSF tool: knife-edge measurements -> frequency-resolved PSF model.

Port of ``thz_image_explorer_tpu/psf_tool`` (the reference's second
application, ``psf_tool/``): load double-knife-edge THz scans, band-filter
the traces on the device (``ops/firapply``), fit Gaussian-beam widths and
centres per band (host Nelder-Mead), fit smooth spline/hybrid curves, run
the Gaussian-beam diagnostics and export the 28-key PSF ``.npz`` the
deconvolution reads.
"""

from thz_image_explorer_tpu_torch.psf_tool.data_loader import (  # noqa: F401
    KnifeEdgeMeasurement,
    load_knife_edge_measurements,
    split_and_flip,
)
from thz_image_explorer_tpu_torch.psf_tool.curve_fitting import (  # noqa: F401
    CubicSpline,
    CurveFits,
    HybridFitF64,
)
from thz_image_explorer_tpu_torch.psf_tool.fitting import (  # noqa: F401
    BeamFitParams,
    BeamWidthFits,
    MeanBeamFit,
    fit_beam_widths,
    fit_mean_beam,
)
from thz_image_explorer_tpu_torch.psf_tool.diagnostics import DiagnosticResults  # noqa: F401
from thz_image_explorer_tpu_torch.psf_tool.app import (  # noqa: F401
    FilterParams,
    PsfToolApp,
    compute_psf,
)
