"""Knife-edge measurement loader.

The port's own copy of ``thz_image_explorer_tpu/psf_tool/data_loader.py``
(the reference's ``psf_tool/data_loader.rs``): a ``.thz``
file where every HDF5 group is one knife position, the position encoded in
the group name (``"Beam Width Measurement x=-0.10"``); each group's first
dataset is a 2-D ``[time, signal]`` array. Traces are sorted by position;
``split_and_flip`` halves + mirrors for double-knife-edge processing.
Files are read through the port's own HDF5 module (:mod:`..io.hdf5`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from thz_image_explorer_tpu_torch.io import hdf5


def _position_from_group_name(name: str) -> float | None:
    idx = name.find("=")
    if idx < 0:
        return None
    rest = name[idx + 1 :]
    num = []
    for ch in rest:
        if ch.isdigit() or ch in ".-+":
            num.append(ch)
        else:
            break
    try:
        return float("".join(num))
    except ValueError:
        return None


@dataclasses.dataclass
class KnifeEdgeMeasurement:
    positions: np.ndarray  # (P,) f64, sorted ascending
    time_traces: np.ndarray  # (P, T) f64
    times: np.ndarray  # (T,) f64

    @staticmethod
    def from_thz_file(path: str) -> "KnifeEdgeMeasurement":
        positions = []
        traces = []
        times = None
        with hdf5.File(path, "r") as f:
            for group_name in f.keys():
                pos = _position_from_group_name(group_name)
                if pos is None:
                    continue
                group = f[group_name]
                ds_names = sorted(group.keys())
                if not ds_names:
                    continue
                arr = np.asarray(group[ds_names[0]][()], np.float64)
                if arr.ndim != 2:
                    continue
                if times is None:
                    times = arr[:, 0]
                positions.append(pos)
                traces.append(arr[:, 1])
        if times is None or not positions:
            raise ValueError(f"no knife-edge groups in {path}")
        positions = np.asarray(positions, np.float64)
        # the reference copies each trace into an Array2::zeros sized by
        # the FIRST group's time axis (data_loader.rs:99-104): shorter
        # traces zero-pad the tail; longer ones would index out of bounds
        # there (panic), so here they truncate instead of crashing
        n_t = len(times)
        padded = np.zeros((len(traces), n_t), np.float64)
        for i, tr in enumerate(traces):
            m = min(len(tr), n_t)
            padded[i, :m] = tr[:m]
        traces = padded
        order = np.argsort(positions, kind="stable")
        return KnifeEdgeMeasurement(
            positions=positions[order], time_traces=traces[order], times=times
        )


def split_and_flip(
    meas: KnifeEdgeMeasurement,
) -> tuple[KnifeEdgeMeasurement, KnifeEdgeMeasurement]:
    """Split in half for double knife edge; the left half's positions are
    negated + reversed and its traces reversed
    (``data_loader.rs:128-162``). For an ODD number of positions the
    middle row is dropped so both halves have equal length — the
    downstream left/right trace averaging broadcasts the two (B, P/2, T)
    cubes elementwise (the reference panics on this input at its trace
    averaging; equal-length halves are the only usable interpretation)."""
    n_half = len(meas.positions) // 2
    start_r = len(meas.positions) - n_half  # == n_half + 1 when odd
    left = KnifeEdgeMeasurement(
        positions=-meas.positions[:n_half][::-1],
        time_traces=meas.time_traces[:n_half][::-1].copy(),
        times=meas.times,
    )
    right = KnifeEdgeMeasurement(
        positions=meas.positions[start_r:].copy(),
        time_traces=meas.time_traces[start_r:].copy(),
        times=meas.times,
    )
    return left, right


def load_knife_edge_measurements(
    x_path: str, y_path: str
) -> tuple[KnifeEdgeMeasurement, KnifeEdgeMeasurement]:
    return (
        KnifeEdgeMeasurement.from_thz_file(x_path),
        KnifeEdgeMeasurement.from_thz_file(y_path),
    )
