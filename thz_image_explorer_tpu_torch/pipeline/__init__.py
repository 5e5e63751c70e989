"""Pipeline: stage protocol, built-in filters, executor, publish, facade."""

from thz_image_explorer_tpu_torch.pipeline import filters as _builtin_filters  # noqa: F401
from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline, PipelineConfig  # noqa: F401
from thz_image_explorer_tpu_torch.pipeline.explorer import Explorer, PlotData  # noqa: F401
