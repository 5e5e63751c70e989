"""Spatial downscaling of the scan cube by block averaging.

Port of ``thz_image_explorer_tpu/ops/scaling.py`` (reference ``scaling()``,
``math_tools.rs:242-310``): crop to a multiple of the factor, reshape
``(X/s, s, Y/s, s, T)`` and average axes 1 and 3.
"""

from __future__ import annotations

from typing import Optional

import torch

from thz_image_explorer_tpu_torch.data import ScanCube


def _block_mean(arr: torch.Tensor, s: int) -> torch.Tensor:
    x, y, t = arr.shape
    nx, ny = x // s, y // s
    blocks = arr[: nx * s, : ny * s, :].reshape(nx, s, ny, s, t)
    return blocks.sum(dim=(1, 3)) / (s * s)


def scale_cube(cube: ScanCube, scale: int,
               valid_wh: Optional[tuple[int, int]] = None) -> ScanCube:
    """Downscale ``data``, ``amplitudes``, ``phases`` and ``fft`` by
    ``scale``. Returns the same object for ``scale <= 1`` or when the
    grid (or the valid region ``valid_wh``) would collapse to nothing
    (``math_tools.rs:244-256``)."""
    if scale <= 1:
        return cube
    if cube.width // scale == 0 or cube.height // scale == 0:
        return cube
    if valid_wh is not None and (valid_wh[0] // scale == 0 or valid_wh[1] // scale == 0):
        return cube
    vw, vh = cube.valid_wh
    return cube.replace(
        data=_block_mean(cube.data, scale),
        amplitudes=_block_mean(cube.amplitudes, scale),
        phases=_block_mean(cube.phases, scale),
        fft=_block_mean(cube.fft, scale),
        valid_wh=(max(vw // scale, 1), max(vh // scale, 1)),
        dx=cube.dx * scale if cube.dx is not None else None,
        dy=cube.dy * scale if cube.dy is not None else None,
        scaling=scale,
        # a block of a sharded cube starts on a multiple of the factor
        origin=(cube.origin[0] // scale, cube.origin[1] // scale),
        grid=None if cube.grid is None else (cube.grid[0] // scale, cube.grid[1] // scale),
    )
