"""3-D voxel view: opacities, the dynamic threshold and the instance
extraction.

Port of ``thz_image_explorer_tpu/ops/voxel.py`` (the reference's
``instance_from_data``, ``threed_plot.rs:132-270``): square the traces,
correlate each with a 1-D Gaussian envelope raised to a contrast exponent,
min-max normalize each surviving trace (``ops/envelope.py``: on a CUDA
tensor one launch of ``csrc/envelope.cu``), then either

* the live view (:func:`extract_instances_topk`): the ``max_points``
  brightest voxels by exact ``torch.topk`` on the device, one small
  transfer to the host; or
* the dense extraction (:func:`extract_instances`, the VTU export): the
  threshold that caps the view at :data:`MAX_INSTANCES` instances, the whole
  opacity volume to the host, ``np.nonzero``.

The JAX package's ``approx_max_k`` becomes exact ``torch.topk`` (on the
CPU the JAX function is exact ``top_k`` too). Geometry, colours and the
packed fetch format are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from thz_image_explorer_tpu_torch.ops.envelope import envelope
from thz_image_explorer_tpu_torch.parallel.mesh import all_sum

MAX_INSTANCES = 2_000_000  # threed_plot.rs:207
C_M_PER_S = 300_000_000.0  # threed_plot.rs:153
BASE_CUBE_SIZE = 0.25  # threed_plot.rs:149

#: alpha quantization of the packed fetch: 6 bits leave 26 for the flat
#: voxel index
_PACK_ALPHA_BITS = 6
_PACK_ALPHA_MAX = (1 << _PACK_ALPHA_BITS) - 1
_PACK_IDX_LIMIT = 1 << (32 - _PACK_ALPHA_BITS)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """Normalized Gaussian taps (``threed_plot.rs:82-102``)."""
    x = np.arange(2 * radius + 1, dtype=np.float32) - radius
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def jet_colormap(value: np.ndarray) -> np.ndarray:
    """(N,) opacity -> (N, 3) rgb (``threed_plot.rs:123-130``)."""
    v4 = 4.0 * np.asarray(value)
    r = np.clip(v4 - 1.5, 0.0, 1.0)
    g = np.clip(v4 - 0.5, 0.0, 1.0) - np.clip(v4 - 2.5, 0.0, 1.0)
    b = 1.0 - np.clip(v4 - 1.5, 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def _dynamic_threshold(flat: torch.Tensor, mesh=None) -> torch.Tensor:
    """Opacity of the ~:data:`MAX_INSTANCES`-th largest voxel, by a
    two-level search over 65 edges.

    The first level spans [0, 1]; the second refines between the chosen edge
    and the one below it. At each level the smallest edge whose count
    ``#(x >= edge)`` is at most :data:`MAX_INSTANCES` wins, or the top edge
    if none is (the cap is then exceeded only by ties at the maximum; the
    reference's ``select_nth_unstable`` cap, ``threed_plot.rs:207-214``).
    The tie-spike guard prefers the edge below when the chosen one keeps
    under a quarter of the cap while the one below keeps more than it. The
    edges are built in the JAX package's f32 order, so the threshold equals
    its one bit for bit. The counts come from one pass per level
    (``bucketize`` + ``bincount`` + a reversed cumsum), never a 65 x N
    comparison.

    With a ``mesh``, ``flat`` is one rank's block: each level's 66-bin
    histogram is joined with ``all_sum`` before the counts are read. The
    edges are the same on every rank and the counts are integers, so the
    threshold equals the whole volume's bit for bit."""
    flat = flat.reshape(-1)
    steps = torch.arange(65, dtype=torch.float32, device=flat.device)

    def refine(lo, hi):
        edges = lo + (hi - lo) * steps / 64.0
        # bucket b = number of edges <= x, so x >= edges[j] iff b > j
        bucket = torch.bucketize(flat, edges, out_int32=True, right=True)
        hist = all_sum(torch.bincount(bucket, minlength=66), mesh)
        c = hist.flip(0).cumsum(0).flip(0)[1:].cpu().numpy()
        ok = c <= MAX_INSTANCES
        idx = int(np.argmax(ok)) if ok.any() else 64
        below = max(idx, 1) - 1
        return edges[idx], edges[below], int(c[idx]), int(c[below])

    zero = torch.zeros((), dtype=torch.float32, device=flat.device)
    e1, lo1, _, _ = refine(zero, zero + 1.0)
    e2, lo2, n2, nb2 = refine(lo1, e1)
    cliff = n2 < MAX_INSTANCES // 4 and nb2 > MAX_INSTANCES
    return lo2 if cliff else e2


def _normalized_opacities(data: torch.Tensor, taps, contrast, opacity_threshold,
                          radius: int) -> torch.Tensor:
    """Envelope + per-trace min-max normalization of the (X, Y, T) cube (no
    cap threshold); ``taps`` are the (2 radius + 1,) correlation taps."""
    if np.shape(taps) != (2 * radius + 1,):
        raise ValueError(f"taps of shape {np.shape(taps)} do not match radius {radius}")
    x, y, t = data.shape
    return envelope(data.reshape(x * y, t).contiguous(), taps, float(np.float32(contrast)),
                    float(np.float32(opacity_threshold))).reshape(x, y, t)


def voxel_opacities(data: torch.Tensor, kernel, contrast, opacity_threshold,
                    radius: int, mesh=None,
                    grid: tuple[int, int] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Opacity volume + dynamic threshold.

    Per trace (``threed_plot.rs:166-218``): ``v -> v²``, envelope =
    zero-boundary correlation of ``(v²)^contrast`` with ``kernel`` (the
    (2 radius + 1,) taps), zero the trace if its max is below
    ``opacity_threshold`` else min-max normalize; then the threshold that
    keeps at most :data:`MAX_INSTANCES` instances (0 when the cube has no
    more voxels than that). Returns ``(opacities (X, Y, T) f32, threshold
    () f32)`` on ``data``'s device. With a ``mesh``, ``data`` is one rank's
    block of the (X, Y) ``grid``: the opacities are the block's and the
    threshold the whole grid's."""
    normalized = _normalized_opacities(data, kernel, contrast, opacity_threshold, radius)
    voxels = normalized.numel() if mesh is None else grid[0] * grid[1] * data.shape[2]
    if voxels > MAX_INSTANCES:
        threshold = _dynamic_threshold(normalized, mesh)
    else:
        threshold = torch.zeros((), dtype=torch.float32, device=data.device)
    return normalized, threshold


# ------------------------------------------------------------ the live view
def _topk_core(data, taps, contrast, opacity_threshold, radius: int, k: int):
    """Opacities -> the ``k`` largest (values, flat indices), descending:
    the one body behind both fetch formats."""
    flat = _normalized_opacities(data, taps, contrast, opacity_threshold, radius).reshape(-1)
    return torch.topk(flat, min(k, flat.numel()))


def _voxel_topk_impl(data, taps, contrast, opacity_threshold, radius: int, k: int):
    """``(values f16, flat indices i32, threshold f32)`` of the ``k``
    brightest voxels, on the device."""
    return _as_f16(*_topk_core(data, taps, contrast, opacity_threshold, radius, k))


def _as_f16(vals, idx):
    """Top-k ``(vals, idx)`` as the unpacked fetch sends them. The view's
    cap threshold is the k-th largest opacity (the reference's cap
    semantics applied at N = k), taken in the f16 space the values are
    fetched in: f16 rounding is monotonic, so ``vals >= threshold`` keeps
    exactly the points an exact comparison would, the k-th included."""
    vals = vals.to(torch.float16)
    threshold = torch.clamp(vals[-1].float(), min=0.0)
    return vals, idx.to(torch.int32), threshold


def _voxel_topk_packed(data, taps, contrast, opacity_threshold, radius: int, k: int):
    """:func:`_voxel_topk_impl` with each (value, index) pair packed into one
    32-bit word ``idx << 6 | round(opacity * 63)``, held in int64 on the
    device (the host makes it ``np.uint32``). Needs ``data.numel() <
    2**26``. Returns ``(packed, threshold f32)``."""
    return _pack(*_topk_core(data, taps, contrast, opacity_threshold, radius, k))


def _pack(vals, idx):
    threshold = torch.clamp(vals[-1], min=0.0)
    q = torch.clamp(torch.round(vals * _PACK_ALPHA_MAX), 0, _PACK_ALPHA_MAX).to(torch.int64)
    return (idx << _PACK_ALPHA_BITS) | q, threshold


def _fetch_packed(data, taps, contrast, opacity_threshold, radius: int, k: int):
    """The packed fetch, decoded on the host: ``(flat indices int64,
    opacities f32, keep mask, threshold)``."""
    return _decode_packed(*_voxel_topk_packed(data, taps, contrast, opacity_threshold, radius, k))


def _decode_packed(packed, thr):
    """The keep mask is taken in the quantized space, so the k-th point
    (== threshold) is not dropped by its own rounding; q == 0 (alpha <
    1/126) is never drawn."""
    packed = packed.cpu().numpy().astype(np.uint32)
    thr = float(thr)
    idx = (packed >> _PACK_ALPHA_BITS).astype(np.int64)
    q = (packed & _PACK_ALPHA_MAX).astype(np.float32)
    keep = q >= max(np.floor(thr * _PACK_ALPHA_MAX), 1.0)
    return idx, q / _PACK_ALPHA_MAX, keep, thr


def _fetch_unpacked(data, taps, contrast, opacity_threshold, radius: int, k: int):
    """The f16 + i32 fetch (any cube size), as :func:`_fetch_packed`
    returns it."""
    return _decode_unpacked(*_voxel_topk_impl(data, taps, contrast, opacity_threshold, radius, k))


def _decode_unpacked(vals, idx, thr):
    vals = vals.cpu().numpy().astype(np.float32)
    idx = idx.cpu().numpy()
    thr = float(thr)
    keep = (vals >= max(thr, 1e-30)) & (vals > 0.0)
    return idx, vals, keep, thr


def _sharded_topk(data, taps, contrast, opacity_threshold, radius: int, k: int, mesh,
                  origin, grid):
    """The ``k`` brightest voxels of the whole grid, on every rank: each
    rank's top ``k`` of its block with global flat indices written into
    its ``k`` of ``world * k`` zero-filled (value, index) slots, one
    ``all_sum`` (float64: indices below 2**53 and f32 values are exact),
    then the top ``k`` of the candidates. Every voxel of the global top
    ``k`` is in its own rank's top ``k``."""
    bx, by, t = data.shape
    vals, idx = _topk_core(data, taps, contrast, opacity_threshold, radius, k)
    lx = idx // (by * t)
    ly = (idx - lx * (by * t)) // t
    gidx = ((lx + origin[0]) * grid[1] + ly + origin[1]) * t + idx % t
    slots = torch.zeros((2, mesh.world * k), dtype=torch.float64, device=data.device)
    slots[0, mesh.rank * k: mesh.rank * k + vals.numel()] = vals.double()
    slots[1, mesh.rank * k: mesh.rank * k + vals.numel()] = gidx.double()
    slots = all_sum(slots, mesh)
    # a stable sort keeps each rank's tie order (one rank: its own top k)
    top, pos = torch.sort(slots[0], descending=True, stable=True)
    n = min(k, grid[0] * grid[1] * t)
    return top[:n].float(), slots[1][pos[:n]].long()


def _view_geometry(gx, gy, gz, time_span: float, original_dims):
    """Cube dims, spacings and half extents: spacing from the *original*
    dims so downscaled data keeps the plot size (``threed_plot.rs:
    156-162``); z depth scaled by the round-trip time of flight
    (``threed_plot.rs:153-154``)."""
    ox, oy, oz = original_dims
    cube_width = cube_height = BASE_CUBE_SIZE
    cube_depth = BASE_CUBE_SIZE / (time_span * C_M_PER_S / 1.0e9 * 2.0)
    spacing = ((ox * cube_width) / gx, (oy * cube_height) / gy, (oz * cube_depth) / gz)
    half = (ox * BASE_CUBE_SIZE / 2.0, oy * BASE_CUBE_SIZE / 2.0, oz * cube_depth / 2.0)
    return (cube_width, cube_height, cube_depth), spacing, half


def _instances(xs, ys, zs, opacity, rgb, dims, spacing, half, scaling):
    positions = np.stack(
        [ys * spacing[1] - half[1], half[0] - xs * spacing[0], half[2] - zs * spacing[2]],
        axis=-1,
    ).astype(np.float32)
    rgba = np.concatenate([rgb, opacity[:, None]], axis=-1).astype(np.float32)
    # the reference stamps scale = scaling on every instance
    # (threed_plot.rs:239,262); with one scalar per extraction it folds into
    # the returned rendered-voxel dims
    s = float(scaling)
    return positions, rgba, dims[0] * s, dims[1] * s, dims[2] * s


def extract_instances_topk(
    data: torch.Tensor,
    time_span: float,
    scaling: int,
    original_dims: tuple[int, int, int],
    *,
    max_points: int,
    valid_grid: tuple[int, int] | None = None,
    opacity_threshold: float = 0.1,
    contrast: float = 2.0,
    kernel_sigma: float = 3.0,
    kernel_radius: int = 9,
    mesh=None,
    origin: tuple[int, int] = (0, 0),
    grid: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, float, float, float, float]:
    """The live 3-D view: ``(positions (N, 3), rgba (N, 4), cube_width,
    cube_height, cube_depth, threshold)`` of the ``max_points`` brightest
    voxels of the (X, Y, T) cube ``data``.

    Same geometry and colours as :func:`extract_instances`; selection is
    top-N by opacity (the reference's cap semantics, ``threed_plot.rs:
    207-214``). Cubes under 2**26 voxels take the packed fetch (4 bytes a
    point, 6-bit alpha), larger ones the f16 + i32 fetch. ``valid_grid``
    restricts the view to the valid (w, h) region of the grid.

    With a ``mesh`` (``parallel.mesh``), ``data`` is this rank's block at
    ``origin`` of the (X, Y) ``grid``: the envelope runs on the block and
    the candidates are joined (:func:`_sharded_topk`), so every rank
    returns the view of the whole grid."""
    taps = gaussian_kernel1d(kernel_sigma, kernel_radius)
    k = int(max_points)
    if mesh is None:
        shape = tuple(data.shape)
        fetch = _fetch_packed if data.numel() < _PACK_IDX_LIMIT else _fetch_unpacked
        idx, vals, keep, thr = fetch(data, taps, contrast, opacity_threshold, kernel_radius, k)
    else:
        grid = tuple(data.shape[:2]) if grid is None else tuple(grid)
        shape = (*grid, data.shape[2])
        top = _sharded_topk(data, taps, contrast, opacity_threshold, kernel_radius, k, mesh,
                            origin, grid)
        if int(np.prod(shape)) < _PACK_IDX_LIMIT:
            idx, vals, keep, thr = _decode_packed(*_pack(*top))
        else:
            idx, vals, keep, thr = _decode_unpacked(*_as_f16(*top))
    return _topk_instances(idx, vals, keep, thr, shape, time_span, scaling,
                           original_dims, valid_grid)


def _topk_instances(idx, vals, keep, thr, shape, time_span, scaling, original_dims,
                    valid_grid):
    """The view's instances from a decoded fetch of a cube of ``shape``."""
    gx, gy, gz = shape
    xs = idx // (gy * gz)
    rem = idx - xs * (gy * gz)
    ys = rem // gz
    zs = rem - ys * gz
    # keep: above the cap threshold, nonzero, and inside the valid grid
    if valid_grid is not None:
        keep = keep & (xs < valid_grid[0]) & (ys < valid_grid[1])
        gx, gy = min(gx, valid_grid[0]), min(gy, valid_grid[1])
    xs, ys, zs, opacity = xs[keep], ys[keep], zs[keep], vals[keep]
    dims, spacing, half = _view_geometry(gx, gy, gz, time_span, original_dims)
    rgb = jet_colormap((opacity - thr) / (1.0 - thr)) if thr < 1.0 else (
        jet_colormap(np.zeros_like(opacity))
    )
    return (*_instances(xs, ys, zs, opacity, rgb, dims, spacing, half, scaling), thr)


# ------------------------------------------------------------ dense (VTU)
def extract_instances(
    data: torch.Tensor,
    time_span: float,
    scaling: int,
    original_dims: tuple[int, int, int],
    *,
    valid_grid: tuple[int, int] | None = None,
    opacity_threshold: float = 0.1,
    contrast: float = 2.0,
    kernel_sigma: float = 3.0,
    kernel_radius: int = 9,
    mesh=None,
    origin: tuple[int, int] = (0, 0),
    grid: tuple[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray, float, float, float, float]:
    """Full voxel extraction: ``(positions (N, 3), rgba (N, 4), cube_width,
    cube_height, cube_depth, threshold)``, every voxel at or above the
    dynamic threshold.

    Jet colours with the opacity re-normalized above the threshold.
    ``valid_grid`` restricts the harvest to the valid region of the grid
    (``original_dims`` are then the true pre-scaling scan dims). The whole
    opacity volume moves to the host, as in the JAX package.

    With a ``mesh`` (``parallel.mesh``), ``data`` is this rank's block at
    ``origin`` of the (X, Y) ``grid``: the envelope runs on the block, the
    threshold joins the ranks' histograms (:func:`_dynamic_threshold`) and
    the harvest joins the ranks' points (:func:`_sharded_harvest`), so every
    rank returns the whole extraction, the same points in the same order
    as the single-device call."""
    grid = tuple(data.shape[:2]) if grid is None else tuple(grid)
    opac, thr = voxel_opacities(
        data, gaussian_kernel1d(kernel_sigma, kernel_radius), contrast, opacity_threshold,
        kernel_radius, mesh, grid,
    )
    gx, gy, gz = (*grid, data.shape[2])
    if valid_grid is not None:
        gx, gy = min(gx, valid_grid[0]), min(gy, valid_grid[1])
    if mesh is None:
        opac = opac.cpu().numpy()
        thr = float(thr)
        opac = opac[:gx, :gy]
        xs, ys, zs = np.nonzero(opac >= thr)
        opacity = opac[xs, ys, zs]
    else:
        xs, ys, zs, opacity = _sharded_harvest(opac, thr, mesh, origin, (gx, gy))
        thr = float(thr)
    dims, spacing, half = _view_geometry(gx, gy, gz, time_span, original_dims)
    rgb = jet_colormap((opacity - thr) / (1.0 - thr))
    return (*_instances(xs, ys, zs, opacity, rgb, dims, spacing, half, scaling), thr)


def _sharded_harvest(opac: torch.Tensor, thr: torch.Tensor, mesh, origin, valid_grid):
    """Every voxel of the whole grid at or above ``thr`` inside the
    ``(gx, gy)`` valid region, on every rank, in ``np.nonzero``'s order:
    ``(xs, ys, zs, opacities)`` as host numpy.

    Each rank finds its block's voxels and their global flat indices; the
    ranks' counts are joined first (one ``all_sum``), then one zero-filled
    float64 ``(2, total)`` array where each rank writes its (index,
    opacity) pairs at its offset (one ``all_sum``: indices below 2**53 and
    f32 opacities are exact in float64). A stable sort by index gives the
    whole volume's row-major order. At 200x200x1024 the threshold caps the
    points at about :data:`MAX_INSTANCES`, 2 M, so the array takes up to
    32 MB."""
    bx, by, t = opac.shape
    gx, gy = valid_grid
    x0, y0 = origin
    keep = opac[: max(min(bx, gx - x0), 0), : max(min(by, gy - y0), 0)] >= thr
    lx, ly, lz = torch.nonzero(keep, as_tuple=True)
    vals = opac[lx, ly, lz]
    gidx = ((lx + x0) * gy + ly + y0) * t + lz
    counts = torch.zeros(mesh.world, dtype=torch.int64, device=opac.device)
    counts[mesh.rank] = gidx.numel()
    counts = all_sum(counts, mesh).cpu().tolist()
    off = sum(counts[: mesh.rank])
    slots = torch.zeros((2, sum(counts)), dtype=torch.float64, device=opac.device)
    slots[0, off: off + gidx.numel()] = gidx.double()
    slots[1, off: off + gidx.numel()] = vals.double()
    slots = all_sum(slots, mesh)
    order = torch.sort(slots[0], stable=True).indices
    idx = slots[0][order].long().cpu().numpy()
    opacity = slots[1][order].float().cpu().numpy()
    xs = idx // (gy * t)
    ys = (idx // t) % gy
    return xs, ys, idx % t, opacity
