"""The pixel-grid mesh over ``torch.distributed`` ranks: the sharded update
step and the per-rank partial open (port of ``thz_image_explorer_tpu/
parallel``). The sharded Apply and live view are
``ops.deconvolution.deconvolve_cube(..., mesh=)`` and
``ops.voxel.extract_instances_topk(..., mesh=)``."""

from thz_image_explorer_tpu_torch.parallel.mesh import (  # noqa: F401
    cube_sharding,
    make_mesh,
    shard_cube,
)
from thz_image_explorer_tpu_torch.parallel.multihost import (  # noqa: F401
    open_arrays_sharded,
    open_scan_sharded,
)
from thz_image_explorer_tpu_torch.parallel.step import interactive_update, lean_update  # noqa: F401
