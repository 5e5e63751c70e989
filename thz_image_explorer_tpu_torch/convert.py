"""Carry JAX-side state across to the port: numpy leaves -> tensors.

The system has no weights; its state is the scan cube and the filter
parameters. The tests use these helpers to feed the JAX package's
intermediate state (converted to numpy by the caller) into the port's
stages, so each stage can be compared on identical inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.pipeline.stage import FilterStage, instantiate_filters

_TENSOR_FIELDS = (
    "time", "data", "freq", "fft", "amplitudes", "phases",
    "avg_data", "avg_fft", "avg_signal_fft", "avg_phase_fft",
)


def cube_from_numpy(leaves: dict[str, np.ndarray], *, dx: Optional[float],
                    dy: Optional[float], x_min: Optional[float],
                    y_min: Optional[float], scaling: int, device) -> ScanCube:
    """The port's ScanCube from a JAX ScanCube's array leaves as numpy
    (f32 stays f32, complex64 stays complex64). ``valid_wh`` is taken from
    the ``valid_wh`` leaf when given, else the full grid."""
    fields = {
        name: torch.as_tensor(np.array(leaves[name]), device=device)
        for name in _TENSOR_FIELDS
    }
    vwh = leaves.get("valid_wh")
    if vwh is None:
        vwh = fields["data"].shape[:2]
    return ScanCube(
        **fields,
        valid_wh=(int(vwh[0]), int(vwh[1])),
        dx=dx, dy=dy, x_min=x_min, y_min=y_min, scaling=int(scaling),
    )


def filter_params_from_numpy(params: dict[str, dict]) -> dict[str, FilterStage]:
    """Fresh port filter instances, uuid-keyed, with the given parameters
    copied on: ``{uuid: {attribute: value}}`` (numpy scalars become Python
    numbers; ``active`` is a parameter like any other). Unknown uuids or
    attributes raise, so a renamed parameter cannot be dropped silently."""
    filters = instantiate_filters()
    for uuid, values in params.items():
        stage = filters[uuid]
        for key, value in values.items():
            if not hasattr(stage, key):
                raise AttributeError(f"{uuid} has no parameter {key!r}")
            if isinstance(value, np.generic) or (
                isinstance(value, np.ndarray) and value.ndim == 0
            ):
                value = value.item()
            setattr(stage, key, value)
    return filters
