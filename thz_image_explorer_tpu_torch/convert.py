"""Carry JAX-side state across to the port: numpy leaves -> tensors.

The system has no weights; its state is the scan cube, the filter
parameters, the PSF and the PSF tool's measurements and fits. The tests use these helpers to feed the JAX package's
intermediate state (converted to numpy by the caller) into the port's
stages, so each stage can be compared on identical inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.io.psf_npz import psf_from_arrays
from thz_image_explorer_tpu_torch.pipeline.stage import FilterStage, instantiate_filters
from thz_image_explorer_tpu_torch.psf_tool.data_loader import KnifeEdgeMeasurement
from thz_image_explorer_tpu_torch.psf_tool.fitting import BeamWidthFits, MeanBeamFit

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


def step_params_from_numpy(params) -> "StepParams":
    """The port's ``parallel.step.StepParams`` from a JAX ``StepParams``
    (any object with its fields, scalar leaves as numpy or Python numbers):
    floats, and the water-line table as a float32 copy."""
    from thz_image_explorer_tpu_torch.parallel.step import StepParams

    values = {f.name: getattr(params, f.name) for f in dataclasses.fields(StepParams)}
    lines = np.array(values.pop("water_lines"), np.float32)
    return StepParams(**{k: float(np.asarray(v)) for k, v in values.items()}, water_lines=lines)


#: the port's PSF from a JAX PSF's arrays as numpy, keyed as in the
#: 28-array ``.npz`` schema (``wx_base_a``, ``wx_knots_thz``, ...,
#: ``y0_coeff_d``; ``io/psf_npz.py``)
psf_from_numpy = psf_from_arrays


def filter_params_from_numpy(params: dict[str, dict]) -> dict[str, FilterStage]:
    """Fresh port filter instances, uuid-keyed, with the given parameters
    copied on: ``{uuid: {attribute: value}}`` (numpy scalars become Python
    numbers; ``active`` is a parameter like any other). Each key goes where
    ``FilterStage.param_owner`` says. Unknown uuids or keys raise, so a
    renamed parameter cannot be dropped silently."""
    filters = instantiate_filters()
    for uuid, values in params.items():
        stage = filters[uuid]
        for key, value in values.items():
            target = stage.param_owner(key)
            if target is None:
                raise AttributeError(f"{uuid} has no parameter {key!r}")
            if isinstance(value, np.generic) or (
                isinstance(value, np.ndarray) and value.ndim == 0
            ):
                value = value.item()
            setattr(target, key, value)
    return filters


def knife_edge_from_numpy(positions, time_traces, times) -> KnifeEdgeMeasurement:
    """The port's knife-edge measurement from a JAX one's arrays (float64
    copies, so neither side's later edits reach the other)."""
    return KnifeEdgeMeasurement(
        positions=np.array(positions, np.float64),
        time_traces=np.array(time_traces, np.float64),
        times=np.array(times, np.float64),
    )


def mean_beam_fit_from_numpy(x0, y0, popt_x, popt_y) -> MeanBeamFit:
    """A JAX ``MeanBeamFit``'s values as the port's (the warm start of a
    band fit chain)."""
    return MeanBeamFit(x0=float(x0), y0=float(y0),
                       popt_x=tuple(float(v) for v in popt_x),
                       popt_y=tuple(float(v) for v in popt_y))


def beam_width_fits_from_numpy(popt_xs, popt_ys, filtered_traces_x, filtered_traces_y,
                               x_positions, y_positions, *, device) -> BeamWidthFits:
    """A JAX ``BeamWidthFits``'s arrays as the port's, the filtered (B, P, T)
    cubes as float32 tensors on ``device`` (one tensor when the JAX side
    shared one cube for x and y)."""
    fx = torch.as_tensor(np.array(filtered_traces_x, np.float32), device=device)
    fy = fx if filtered_traces_y is filtered_traces_x else torch.as_tensor(
        np.array(filtered_traces_y, np.float32), device=device)
    return BeamWidthFits(popt_xs=np.array(popt_xs, np.float64),
                         popt_ys=np.array(popt_ys, np.float64),
                         filtered_traces_x=fx, filtered_traces_y=fy,
                         x_positions=np.array(x_positions, np.float64),
                         y_positions=np.array(y_positions, np.float64))
