"""Spatial downscaling of the scan cube by block averaging.

Port of ``thz_image_explorer_tpu/ops/scaling.py`` (reference ``scaling()``,
``math_tools.rs:242-310``): crop to a multiple of the factor, reshape
``(X/s, s, Y/s, s, T)`` and average axes 1 and 3. The s x s values of a
downscaled pixel are added in one fixed order by elementwise additions, so
a pixel's mean does not depend on the size of the tensor it is computed in.

On a mesh (``parallel.mesh``), a rank's block of the downscaled grid is the
mesh's :meth:`~thz_image_explorer_tpu_torch.parallel.mesh.Mesh.block` of
that grid, whatever the factor: the layout of every slot of a sharded
pipeline is then the mesh's blocks of the slot's grid. A downscaled pixel
whose source square straddles two ranks' blocks needs source rows or
columns from a neighbour; exactly those move, in one zero-filled
``all_sum`` (an exact copy), and every rank then averages in the
single-device order, so the values equal the whole cube's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.parallel.mesh import Mesh, all_sum

#: the fields a downscale averages
FIELDS = ("data", "amplitudes", "phases", "fft")

Rect = tuple[int, int, int, int]


def _block_mean(arr: torch.Tensor, s: int) -> torch.Tensor:
    """Mean of each s x s pixel square of the (X, Y, ...) ``arr`` (rows and
    columns past a multiple of ``s`` dropped): the values of a square added
    column by column within each row, then the rows, then divided."""
    nx, ny = arr.shape[0] // s, arr.shape[1] // s
    blocks = arr[: nx * s, : ny * s].reshape(nx, s, ny, s, *arr.shape[2:])
    rows = blocks[:, :, :, 0]
    for b in range(1, s):
        rows = rows + blocks[:, :, :, b]
    acc = rows[:, 0]
    for a in range(1, s):
        acc = acc + rows[:, a]
    return acc / (s * s)


def scale_cube(cube: ScanCube, scale: int, valid_wh: Optional[tuple[int, int]] = None,
               mesh: Optional[Mesh] = None) -> ScanCube:
    """Downscale ``data``, ``amplitudes``, ``phases`` and ``fft`` by
    ``scale``. Returns the same object for ``scale <= 1`` or when the
    grid (or the valid region ``valid_wh``) would collapse to nothing
    (``math_tools.rs:244-256``).

    With a ``mesh``, ``cube`` is this rank's :meth:`Mesh.block` of its grid
    and the result is its block of the downscaled grid (module docstring);
    a block of a sharded cube without its mesh raises ``ValueError``."""
    if scale <= 1:
        return cube
    if mesh is None and cube.grid is not None:
        raise ValueError("a block of a sharded cube is downscaled with its mesh: "
                         "scale_cube(..., mesh=)")
    gx, gy = cube.grid_wh
    if gx // scale == 0 or gy // scale == 0:
        return cube
    if valid_wh is not None and (valid_wh[0] // scale == 0 or valid_wh[1] // scale == 0):
        return cube
    vw, vh = cube.valid_wh
    out_grid = (gx // scale, gy // scale)
    if mesh is None:
        fields = {name: _block_mean(getattr(cube, name), scale) for name in FIELDS}
        origin, grid = (0, 0), None
    else:
        sources, (ox0, _, oy0, _) = _sources(cube, scale, mesh, out_grid)
        fields = {name: _block_mean(src, scale) for name, src in sources.items()}
        origin, grid = (ox0, oy0), out_grid
    return cube.replace(
        **fields,
        valid_wh=(max(vw // scale, 1), max(vh // scale, 1)),
        dx=cube.dx * scale if cube.dx is not None else None,
        dy=cube.dy * scale if cube.dy is not None else None,
        scaling=scale,
        origin=origin,
        grid=grid,
    )


def _outside(need: Rect, have: Rect) -> list[Rect]:
    """The parts of the rectangle ``need`` outside ``have``, as at most four
    disjoint rectangles ``(x0, x1, y0, y1)``."""
    nx0, nx1, ny0, ny1 = need
    hx0, hx1, hy0, hy1 = have
    out = [(a, b, ny0, ny1) for a, b in ((nx0, min(nx1, hx0)), (max(nx0, hx1), nx1)) if a < b]
    ix0, ix1 = max(nx0, hx0), min(nx1, hx1)
    if ix0 < ix1:
        out += [(ix0, ix1, a, b) for a, b in ((ny0, min(ny1, hy0)), (max(ny0, hy1), ny1))
                if a < b]
    return out


def _overlap(a: Rect, b: Rect) -> Optional[Rect]:
    x0, x1, y0, y1 = max(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), min(a[3], b[3])
    return (x0, x1, y0, y1) if x0 < x1 and y0 < y1 else None


def _channels(cube: ScanCube) -> dict[str, tuple[int, int]]:
    """Each field's range of real channels in an exchanged pixel (the
    complex spectrum as its real and imaginary parts)."""
    out, pos = {}, 0
    for name in FIELDS:
        t = getattr(cube, name)
        n = t.shape[2] * (2 if t.is_complex() else 1)
        out[name], pos = (pos, pos + n), pos + n
    return out


def _sources(cube: ScanCube, s: int, mesh: Mesh, out_grid: tuple[int, int]):
    """This rank's source rectangle of each field (``(bx * s, by * s, ...)``
    for its output block of ``(bx, by)``) and the output block.

    Every rank derives the whole exchange from the layout alone: for each
    rank r, the source rectangle of its output block and the parts of it
    outside r's own block. One zero-filled buffer holds those parts of all
    ranks in rank order; each rank writes what it holds of each, one
    ``all_sum`` joins them (each value is written by exactly one rank), and
    each rank reads its own parts back. No rank needs anything on a mesh of
    one rank, and then no collective is made."""
    grid = cube.grid_wh
    plans = []
    for r in range(mesh.world):
        have = mesh.block(r, grid)
        ox0, ox1, oy0, oy1 = mesh.block(r, out_grid)
        need = (ox0 * s, ox1 * s, oy0 * s, oy1 * s)
        plans.append((have, need, _outside(need, have), (ox0, ox1, oy0, oy1)))
    have, need, mine, out_block = plans[mesh.rank]
    x0, y0 = cube.origin
    if have != (x0, x0 + cube.width, y0, y0 + cube.height):
        raise ValueError(f"a block at {cube.origin} of {cube.width}x{cube.height} is not rank "
                         f"{mesh.rank}'s block of the {grid[0]}x{grid[1]} grid")
    chans = _channels(cube)
    n_ch = max(b for _, b in chans.values())
    parts = [rect for _, _, rects, _ in plans for rect in rects]

    def local(name: str, rect: Rect) -> torch.Tensor:
        """``rect`` (grid coordinates, inside this block) of field ``name``."""
        t = getattr(cube, name)
        return t[rect[0] - x0: rect[1] - x0, rect[2] - y0: rect[3] - y0]

    received = []
    if parts:
        sizes = [(r[1] - r[0]) * (r[3] - r[2]) * n_ch for r in parts]
        buf = cube.data.new_zeros(sum(sizes))
        offs = [sum(sizes[:i]) for i in range(len(sizes))]
        for rect, off, size in zip(parts, offs, sizes):
            part = _overlap(rect, have)
            if part is None:
                continue
            view = buf[off: off + size].view(rect[1] - rect[0], rect[3] - rect[2], n_ch)
            sub = view[part[0] - rect[0]: part[1] - rect[0], part[2] - rect[2]: part[3] - rect[2]]
            for name, (c0, c1) in chans.items():
                t = local(name, part)
                sub[..., c0:c1] = torch.view_as_real(t).flatten(2) if t.is_complex() else t
        buf = all_sum(buf, mesh)
        first = sum(len(rects) for _, _, rects, _ in plans[: mesh.rank])
        for rect, off, size in zip(parts[first: first + len(mine)], offs[first:], sizes[first:]):
            received.append((rect, buf[off: off + size].view(rect[1] - rect[0],
                                                             rect[3] - rect[2], n_ch)))
    inner = _overlap(need, have)
    sources = {}
    for name, (c0, c1) in chans.items():
        t = getattr(cube, name)
        if not received:
            sources[name] = local(name, need)
            continue
        src = t.new_empty((need[1] - need[0], need[3] - need[2], *t.shape[2:]))
        for rect, vals in [(inner, None)] + received:
            if rect is None:
                continue
            dst = src[rect[0] - need[0]: rect[1] - need[0], rect[2] - need[2]: rect[3] - need[2]]
            if vals is None:
                dst.copy_(local(name, rect))
            elif t.is_complex():
                pairs = vals[..., c0:c1].reshape(*vals.shape[:2], -1, 2).contiguous()
                dst.copy_(torch.view_as_complex(pairs))
            else:
                dst.copy_(vals[..., c0:c1])
        sources[name] = src
    return sources, out_block
