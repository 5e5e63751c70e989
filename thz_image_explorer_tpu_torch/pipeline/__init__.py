"""Pipeline: stage protocol, built-in filters, executor, publish, facade."""

from thz_image_explorer_tpu_torch.pipeline.stage import (  # noqa: F401
    FilterConfig,
    FilterDomain,
    FilterStage,
    StageContext,
    build_chain,
    instantiate_filters,
    register_filter,
    registered_filters,
)
from thz_image_explorer_tpu_torch.pipeline import filters as _builtin_filters  # noqa: F401
from thz_image_explorer_tpu_torch.pipeline.executor import Pipeline, PipelineConfig  # noqa: F401
from thz_image_explorer_tpu_torch.pipeline.explorer import Explorer, PlotData  # noqa: F401
