"""Polygon ROI masks and masked-mean reductions.

Port of ``thz_image_explorer_tpu/ops/roi.py`` (reference
``math_tools.rs:574-661``). Each polygon is rasterized once on the host
into a boolean mask with the reference's exact rule (the Rust release
build's wrapping ``u64`` arithmetic, the x/y swap and the vertical flip)
by the C function of ``csrc/roi.c``, built with the system C compiler at
first use (``kernels.load``); :func:`polygon_mask_plain` is the same rule in
Python, for the tests. ROI traces are then a masked mean on the device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from thz_image_explorer_tpu_torch import kernels

_M64 = 1 << 64


def _point_in_polygon_py(x: int, y: int, poly: list[tuple[int, int]]) -> bool:
    """Ray-cast point-in-polygon with u64 wrap-around semantics
    (``math_tools.rs:574-591``)."""
    inside = False
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        if (yi > y) != (yj > y):
            den = (yj - yi) % _M64
            t = (((xj - xi) % _M64) * ((y - yi) % _M64)) % _M64
            val = (t // den + xi) % _M64
            if x < val:
                inside = not inside
        j = i
    return inside


def polygon_mask(polygon: list[tuple[int, int]], shape: tuple[int, int],
                 scaling: int = 1) -> np.ndarray:
    """Boolean mask over the data grid for a polygon ROI, by the C
    rasterizer.

    ``shape`` is ``data.shape[:2]``; ``mask[y_size-1-y, x]`` is set for
    in-polygon pixels, reproducing ``average_polygon_roi``'s swapped and
    flipped indexing (``math_tools.rs:611-648``). Coordinates are first
    wrapped to u64 (a vertex dragged past the image edge wraps to ~2^64 in
    the Rust release build, so the clamp to the grid pins it to size-1) and
    divided by ``scaling`` with integer division (``math_tools.rs:604-609``);
    a ``scaling`` of 0 gives an empty mask."""
    shape0, shape1 = int(shape[0]), int(shape[1])
    mask = np.zeros((shape0, shape1), np.uint8)
    n = len(polygon)
    if n:
        px = np.array([int(x) % _M64 for x, _ in polygon], np.uint64)
        py = np.array([int(y) % _M64 for _, y in polygon], np.uint64)
        u64 = ctypes.POINTER(ctypes.c_uint64)
        count = kernels.load("roi").thz_roi_polygon_mask(
            px.ctypes.data_as(u64), py.ctypes.data_as(u64), n, shape0, shape1,
            int(scaling) % _M64, mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if count < 0:
            raise MemoryError("the ROI rasterizer could not allocate its vertex arrays")
    return mask.view(bool)


def polygon_mask_plain(polygon: list[tuple[int, int]], shape: tuple[int, int],
                       scaling: int = 1) -> np.ndarray:
    """:func:`polygon_mask` in Python: the plain version of the C
    rasterizer, for the tests."""
    shape0, shape1 = int(shape[0]), int(shape[1])
    mask = np.zeros((shape0, shape1), bool)
    if not polygon or shape0 == 0 or shape1 == 0 or int(scaling) == 0:
        return mask
    poly = [
        ((int(x) % _M64) // int(scaling), (int(y) % _M64) // int(scaling))
        for x, y in polygon
    ]
    x_size, y_size = shape1, shape0
    xs = [p[0] for p in poly]
    ys = [p[1] for p in poly]
    x_min = min(min(xs), x_size - 1)
    y_min = min(min(ys), y_size - 1)
    x_max = min(max(xs), x_size - 1)
    y_max = min(max(ys), y_size - 1)
    for y in range(y_min, y_max + 1):
        for x in range(x_min, x_max + 1):
            if _point_in_polygon_py(x, y, poly):
                mask[y_size - y - 1, x] = True
    return mask


def masked_sum_stack(arr: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Batched ROI sums: ``(R, X, Y)`` masks x ``(X, Y, T)`` array ->
    ``(R, T)``, one f32 matrix product (TF32 is off package-wide). Sums over
    disjoint pixel blocks add up to the whole grid's: a rank of a mesh
    passes its block and its slice of the masks, and the publish joins the
    ranks' sums before dividing by the whole masks' counts."""
    x, y, t = arr.shape
    return masks.reshape(masks.shape[0], x * y).to(arr.dtype) @ arr.reshape(x * y, t)


def masked_mean_trace(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One ROI's mean trace: ``(X, Y)`` mask x ``(X, Y, T)`` array ->
    ``(T,)``, the one-mask case of :func:`masked_mean_stack` (zeros for an
    empty mask)."""
    return masked_mean_stack(data, mask[None])[0]


def masked_mean_stack(arr: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Batched ROI means: ``(R, X, Y)`` masks x ``(X, Y, T)`` array ->
    ``(R, T)``; empty masks yield zeros (the reference's untouched zero
    result, ``math_tools.rs:640-659``)."""
    counts = masks.reshape(masks.shape[0], arr.shape[0] * arr.shape[1]).to(arr.dtype).sum(dim=1)
    totals = masked_sum_stack(arr, masks)
    return torch.where(
        counts[:, None] > 0, totals / torch.clamp(counts, min=1.0)[:, None], 0.0
    )
