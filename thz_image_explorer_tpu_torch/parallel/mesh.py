"""The pixel-grid mesh over the ranks of a ``torch.distributed`` group.

Port of ``thz_image_explorer_tpu/parallel/mesh.py``. The reference's only
parallelism is over pixels (SURVEY.md §2.7), so the ranks are laid out as a
2-D grid over the scan's ``(x, y)`` pixel grid, with the time / frequency
axis whole on every rank. Each rank holds one block of pixels and runs the
port's per-pixel stages and kernels on it; the ranks exchange only what
crosses pixels (the pixel-mean and ROI sums, the deconvolution's energy
images and estimates, the live view's candidates).

Where XLA's partitioner inserted the collectives in the JAX package, the
port calls them itself, and only two: :func:`all_sum` and
:func:`grid_gather`, both built on ``all_reduce``. NCCL takes any
collective; gloo takes CUDA tensors in ``all_reduce`` and ``broadcast`` but
not in ``all_gather``, so the same code runs on NCCL (the card's default),
on gloo with several ranks sharing one card, and on gloo on the CPU.

Blocks need not divide the grid: the port never pads it (the JAX package's
loader pads to multiples of 16 because ``device_put`` needs divisible
dimensions).
"""

from __future__ import annotations

import dataclasses
import math
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from thz_image_explorer_tpu_torch.data import ScanCube, resolve_device

#: ScanCube fields split over the pixel grid; the others are replicated
SPLIT_FIELDS = ("data", "fft", "amplitudes", "phases")


def grid_shape(n: int) -> tuple[int, int]:
    """``(a, n // a)`` with ``a`` the largest divisor of ``n`` at or below
    ``sqrt(n)``: the JAX package's ``make_mesh`` layout of ``n`` devices."""
    if n < 1:
        raise ValueError(f"no mesh of {n} ranks")
    a = math.isqrt(n)
    while n % a:
        a -= 1
    return a, n // a


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` ranks laid out row-major over the pixel grid: rank ``r``
    sits at ``(r // shape[1], r % shape[1])``. ``rank`` is this process's
    rank and ``group`` the process group the collectives run on (None: no
    group, for a mesh of one rank or one that only computes blocks)."""

    shape: tuple[int, int]
    rank: int = 0
    group: Optional[dist.ProcessGroup] = None

    @property
    def world(self) -> int:
        return self.shape[0] * self.shape[1]

    def coords(self, rank: Optional[int] = None) -> tuple[int, int]:
        r = self.rank if rank is None else rank
        if not 0 <= r < self.world:
            raise ValueError(f"rank {r} outside a mesh of {self.world}")
        return r // self.shape[1], r % self.shape[1]

    def block(self, rank: Optional[int], grid: tuple[int, int]) -> tuple[int, int, int, int]:
        """The pixels ``[x0, x1) x [y0, y1)`` of ``rank`` (this one for
        None) on an ``(X, Y)`` grid: blocks of ``ceil(X / a)`` rows, the
        last one shorter. Every grid of a sharded cube, a downscaled one
        too, is laid out this way (``ops/scaling``). Raises where a rank
        would get no rows or columns."""
        i, j = self.coords(rank)
        x0, x1 = _span(grid[0], self.shape[0], i)
        y0, y1 = _span(grid[1], self.shape[1], j)
        if x1 <= x0 or y1 <= y0:
            raise ValueError(f"a {grid[0]}x{grid[1]} grid leaves rank {self.coords(rank)} of a "
                             f"{self.shape[0]}x{self.shape[1]} mesh no rows or columns")
        return x0, x1, y0, y1

    def owner(self, pixel, grid: tuple[int, int]) -> int:
        """The rank whose :meth:`block` of ``grid`` holds the global
        ``pixel`` (x, y); raises for a pixel outside the grid."""
        x, y = int(pixel[0]), int(pixel[1])
        if not (0 <= x < grid[0] and 0 <= y < grid[1]):
            raise ValueError(f"pixel {(x, y)} outside a {grid[0]}x{grid[1]} grid")
        for r in range(self.world):
            x0, x1, y0, y1 = self.block(r, grid)
            if x0 <= x < x1 and y0 <= y < y1:
                return r
        raise AssertionError("the blocks do not tile the grid")


def _span(n: int, parts: int, k: int) -> tuple[int, int]:
    size = -(-n // parts)
    return min(k * size, n), min((k + 1) * size, n)


def make_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of the ranks of ``group`` (the default group for None),
    laid out by :func:`grid_shape`."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call parallel.mesh.init first")
    group = dist.group.WORLD if group is None else group
    return Mesh(grid_shape(dist.get_world_size(group)), dist.get_rank(group), group)


def init(device=None, backend: Optional[str] = None, *, init_method: str, rank: int,
         world_size: int, timeout_s: float = 300.0) -> Mesh:
    """Start the default process group and return its mesh.

    ``device`` None means the card (and raises where there is none). The
    backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU unless
    ``backend`` names one (gloo for several ranks sharing one card: NCCL
    refuses two ranks on one GPU). A backend that fails to start raises;
    nothing switches to another one. ``init_method`` is the rendezvous
    (``tcp://host:port`` or ``file:///path``)."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s),
                            **kwargs)
    return make_mesh()


def cube_sharding() -> dict[str, str]:
    """Each ScanCube array's placement, as the JAX ``cube_sharding``
    names them: ``"split"`` over the pixel grid or ``"replicated"``."""
    names = ("time", "data", "freq", "fft", "amplitudes", "phases", "avg_data", "avg_fft",
             "avg_signal_fft", "avg_phase_fft", "valid_wh")
    return {n: "split" if n in SPLIT_FIELDS else "replicated" for n in names}


def shard_cube(cube: ScanCube, mesh: Mesh, rank: Optional[int] = None) -> ScanCube:
    """``rank``'s block (this process's for None) of a whole cube: the
    split fields cut to :meth:`Mesh.block`, the others shared, the global
    ``valid_wh`` kept, and the block's ``origin`` and ``grid`` recorded."""
    grid = cube.grid_wh
    x0, x1, y0, y1 = mesh.block(rank, grid)
    ox, oy = cube.origin
    return cube.replace(
        **{name: getattr(cube, name)[x0:x1, y0:y1].contiguous() for name in SPLIT_FIELDS},
        origin=(ox + x0, oy + y0), grid=grid)


def check_rank_block(cube: ScanCube, mesh: Mesh) -> None:
    """Raise ``ValueError`` unless ``cube`` is this rank's :meth:`Mesh.block`
    of its grid (``origin`` and extent), as :func:`shard_cube` and the
    sharded opens cut it. A whole cube
    (``grid`` None) passes only on a mesh of one rank."""
    if cube.grid is None and mesh.world > 1:
        raise ValueError(f"a whole cube on a mesh of {mesh.world} ranks: give this rank's block "
                         "(parallel.shard_cube, open_scan_sharded or open_arrays_sharded)")
    x0, x1, y0, y1 = mesh.block(None, cube.grid_wh)
    have = (cube.origin[0], cube.origin[0] + cube.width, cube.origin[1],
            cube.origin[1] + cube.height)
    if have != (x0, x1, y0, y1):
        raise ValueError(f"the block [{have[0]}, {have[1]}) x [{have[2]}, {have[3]}) of a "
                         f"{cube.grid_wh[0]}x{cube.grid_wh[1]} grid is not rank {mesh.rank}'s "
                         f"[{x0}, {x1}) x [{y0}, {y1})")


def block_slice(arr: torch.Tensor, cube: ScanCube) -> torch.Tensor:
    """The (..., X, Y) whole-grid array's part over the block's pixels."""
    x0, y0 = cube.origin
    return arr[..., x0: x0 + cube.width, y0: y0 + cube.height]


def valid_mask(cube: ScanCube) -> Optional[torch.Tensor]:
    """(bx, by) 0/1 of the block's pixels inside the valid region; None
    where all of them are."""
    x0, y0 = cube.origin
    vw, vh = cube.valid_wh
    if x0 + cube.width <= vw and y0 + cube.height <= vh:
        return None
    xs = torch.arange(x0, x0 + cube.width, device=cube.device) < vw
    ys = torch.arange(y0, y0 + cube.height, device=cube.device) < vh
    return (xs[:, None] & ys[None, :]).to(torch.float32)


def all_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, on every rank (a new
    tensor; ``t`` itself for ``mesh`` None)."""
    if mesh is None:
        return t
    out = t.clone().contiguous()
    _all_reduce(out, mesh)
    return out


def all_sum_parts(parts: list[torch.Tensor], mesh: Optional[Mesh]) -> list[torch.Tensor]:
    """The sum over the mesh's ranks of each tensor of ``parts`` (one
    dtype), joined in ONE collective of their flattened concatenation;
    ``parts`` themselves for ``mesh`` None, with no copy."""
    if mesh is None:
        return list(parts)
    flat = all_sum(torch.cat([p.reshape(-1) for p in parts]), mesh)
    out, pos = [], 0
    for p in parts:
        out.append(flat[pos: pos + p.numel()].reshape(p.shape))
        pos += p.numel()
    return out


def grid_gather(local: torch.Tensor, mesh: Optional[Mesh], grid: tuple[int, int],
                origin: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """The whole ``(X, Y, ...)`` tensor on every rank from each rank's
    ``(bx, by, ...)`` block at ``origin`` (this rank's :meth:`Mesh.block`
    for None): each rank writes its block into zeros and the ranks sum.
    A sum of one value and zeros is exact, so the result equals the blocks
    bit for bit."""
    if mesh is None:
        return local
    if origin is None:
        x0, _, y0, _ = mesh.block(None, grid)
        origin = (x0, y0)
    full = grid_place(local, grid, origin)
    _all_reduce(full, mesh)
    return full


def grid_place(local: torch.Tensor, grid: tuple[int, int],
               origin: tuple[int, int]) -> torch.Tensor:
    """The ``(bx, by, ...)`` block ``local`` at ``origin`` of a zero-filled
    ``(X, Y, ...)`` whole grid: one rank's part of :func:`grid_gather`, for a
    caller that joins it with other sums in one ``all_sum``."""
    x0, y0 = origin
    full = local.new_zeros((grid[0], grid[1], *local.shape[2:]))
    full[x0: x0 + local.shape[0], y0: y0 + local.shape[1]] = local
    return full


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> None:
    """In-place sum over the mesh's group; a mesh without a group must
    have one rank, whose sum is ``t``."""
    if mesh.group is None:
        if mesh.world != 1:
            raise RuntimeError(f"a mesh of {mesh.world} ranks without a process group")
        return
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)


def any_rank(flag: bool, mesh: Optional[Mesh], device) -> bool:
    """True on every rank when ``flag`` is True on any (one 4-byte
    ``all_reduce`` on ``device``; a CUDA device waits for its stream)."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    return bool(all_sum(t, mesh).item() > 0)
