"""Presentation helpers: the behavioural spec of the reference's GUI layer
as host-side functions (colormaps, plot-series math, the page's pure
functions), the port's own copies of ``thz_image_explorer_tpu/viz``."""

from thz_image_explorer_tpu_torch.viz.colormap import (  # noqa: F401
    color_from_intensity,
    intensity_image_rgba,
)
from thz_image_explorer_tpu_torch.viz.plots import (  # noqa: F401
    dynamic_range_db,
    fft_plot_series,
    peak_to_peak,
    stacked_pulse_series,
)
