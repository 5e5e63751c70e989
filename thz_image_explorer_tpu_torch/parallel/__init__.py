"""The pixel-grid mesh over ``torch.distributed`` ranks and the per-rank
partial open (port of ``thz_image_explorer_tpu/parallel``). The sharded
update step is ``parallel.step`` (``interactive_update``, ``lean_update``);
the sharded Apply and live view are
``ops.deconvolution.deconvolve_cube(..., mesh=)`` and
``ops.voxel.extract_instances_topk(..., mesh=)``; the incremental
``pipeline.executor.Pipeline(mesh=)`` runs on one rank's block.

The step is not imported here: it runs ops that import ``parallel.mesh``
themselves, and importing it with the package would make a cycle."""

from thz_image_explorer_tpu_torch.parallel.mesh import (  # noqa: F401
    cube_sharding,
    make_mesh,
    shard_cube,
)
from thz_image_explorer_tpu_torch.parallel.multihost import (  # noqa: F401
    open_arrays_sharded,
    open_scan_sharded,
)
