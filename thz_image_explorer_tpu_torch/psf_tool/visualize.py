"""PSF visualization: the 2-D beam-profile preview at a chosen frequency.

The port's own copy of ``thz_image_explorer_tpu/psf_tool/visualize.py``
(the reference's ``psf_tool/psf_visualizer.rs:43-101``):
evaluate the fitted width/center curves at one frequency and render the
normalized 2-D Gaussian ``I(x,y) = exp(-2((x-x0)²/wx² + (y-y0)²/wy²))``
over a ±4σ extent (y flipped for display).
"""

from __future__ import annotations

import numpy as np

from thz_image_explorer_tpu_torch.psf_tool.curve_fitting import CurveFits


def psf_image(
    curve_fits: CurveFits, frequency_thz: float, resolution: int = 256
) -> tuple[np.ndarray, tuple[float, float, float, float]]:
    """Return ``(intensity (res, res) in [0,1], (x_min, x_max, y_min,
    y_max) mm extents)``."""
    f = [frequency_thz]
    wx = float(curve_fits.wx_fit.evaluate(f)[0])
    wy = float(curve_fits.wy_fit.evaluate(f)[0])
    x0 = float(curve_fits.x0_fit.evaluate_const_extrap(f)[0])
    y0 = float(curve_fits.y0_fit.evaluate_const_extrap(f)[0])

    extent_x, extent_y = 4.0 * wx, 4.0 * wy
    x_min, x_max = x0 - extent_x, x0 + extent_x
    y_min, y_max = y0 - extent_y, y0 + extent_y

    j = np.arange(resolution) / (resolution - 1)
    i = np.arange(resolution) / (resolution - 1)
    x = x_min + j * (x_max - x_min)
    y = y_max - i * (y_max - y_min)  # flip y for display
    dx = (x[None, :] - x0) / wx
    dy = (y[:, None] - y0) / wy
    intensity = np.exp(-2.0 * (dx * dx + dy * dy))
    intensity /= intensity.max()
    return intensity, (x_min, x_max, y_min, y_max)
