"""Frequency-resolved Richardson-Lucy deconvolution (the Apply path).

Port of ``thz_image_explorer_tpu/ops/deconvolution.py`` (the reference's
``filters/deconvolution.rs``; IEEE TTHZ.2025.3546756): split the scan into
frequency bands with a Kaiser FIR bank, deconvolve each band's energy
image with the band's Gaussian PSF by Richardson-Lucy, turn the result
into per-pixel gains and re-sum the bands.

The host planning (:func:`plan_bands`, the energy matrices, the profile
pre-flip) is the JAX package's, so the band data are equal bit for bit.
The device work is three phases:

a. one ``torch.fft.rfft`` of every trace at ``fft_len`` (cuFFT on the
   card), its power, and the head/tail input segments;
b. each band's energy image as ``E_full - E_head - E_tail`` clamped at 0
   (the windowed-convolution energy identity, see
   :func:`_energy_matrices`), a reflect pad by index gather, every band's
   Richardson-Lucy iterations in one kernel (``ops/rlsep.py``);
c. the gains ``sqrt(max(u, 0) / img)`` of the cropped estimates (0/0 gives
   NaN, as in the reference) and the weighted spectrum
   ``spec * sum_b g_b T_b``, written over ``spec`` in one pass
   (``ops/bandsum.py``: a kernel on the card), and one ``torch.fft.irfft``,
   keeping the centre window.

The JAX package's TPU workarounds are not carried over: its DFT matmuls
are cuFFT here, its 0/1 reflect-pad matrices an index gather, its dense
banded correlation matrices the kernel's direct taps. Plain products
(``power @ w2``, the head/tail einsums) are f32 ``torch.matmul``/``einsum``;
TF32 is off (the package sets it at import).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.models.psf import PSF, create_psf_axes, gaussian
from thz_image_explorer_tpu_torch.ops.bandsum import weighted_spectrum
from thz_image_explorer_tpu_torch.ops.firdesign import create_filter_bank
from thz_image_explorer_tpu_torch.ops import rlsep
from thz_image_explorer_tpu_torch.ops.rlsep import rl_bands_separable
from thz_image_explorer_tpu_torch.parallel.mesh import all_sum, any_rank, grid_gather
from thz_image_explorer_tpu_torch.utils import spans

MIN_IMAGE_SIZE = 16  # deconvolution.rs:802
DIRECT_CONV_MAX_ELEMS = 256  # convolve2d's direct-path threshold (:485)
#: relative eigenvalue cutoff of the energy Gram factorization (the JAX
#: package's value; see :func:`_factor_gram`)
_GRAM_EIG_RTOL = 1e-10


@dataclasses.dataclass
class DeconvolutionParams:
    """User parameters (defaults: ``deconvolution.rs:725-734``)."""

    n_iterations: int = 500
    n_filters: int = 25
    start_freq: float = 0.1
    end_freq: float = 10.0
    win_width: float = 0.5


@dataclasses.dataclass
class BandGeometry:
    """Host-computed geometry of all bands."""

    taps: np.ndarray  # (B, ntaps) f64
    centers: np.ndarray  # (B,)
    psfs: np.ndarray  # (B, kr_max, kc_max) f32, centred in the canvas
    px: np.ndarray  # (B, kr_max) f32 axis profiles; psfs[b] = outer(px, py)
    py: np.ndarray  # (B, kc_max) f32
    pad_r: np.ndarray  # (B,) int32 reflect pad along axis 0
    pad_c: np.ndarray  # (B,) int32
    n_iter: np.ndarray  # (B,) int32
    use_fft_conv: np.ndarray  # (B,) bool: which convolution semantics a band takes
    #: band data on a device, keyed by (device, data shape): built once per
    #: geometry, so a rerun of the Apply sends nothing to the device again
    _device_data: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


def _conv_len(n: int) -> int:
    """Linear-convolution transform length: the JAX package's (``n``
    rounded up to a multiple of 256), so the host matrices built at this
    length are its own. 1536 at T = 1024, which cuFFT takes as 2^9 * 3."""
    return ((n + 255) // 256) * 256


def plan_bands(
    params: DeconvolutionParams,
    psf_model: PSF,
    time: np.ndarray,
    shape: tuple[int, int],
    dx: float,
    dy: float,
) -> Optional[BandGeometry]:
    """Host-side planning: filter bank, per-band PSF profiles, iteration
    counts. Returns None when a guard fails (the stage then passes the
    cube through, ``deconvolution.rs:780-885``)."""
    img_rows, img_cols = shape
    if img_rows < MIN_IMAGE_SIZE or img_cols < MIN_IMAGE_SIZE:
        return None
    if not psf_model.is_loaded:
        return None

    taps, centers = create_filter_bank(
        params.n_filters, params.start_freq, params.end_freq, params.win_width, time,
    )
    centers32 = centers.astype(np.float32)

    wx = psf_model.wx_fit.eval(centers32)
    wy = psf_model.wy_fit.eval(centers32)
    w_min = float(min(wx.min(), wy.min()))
    w_max = float(max(wx.max(), wy.max()))

    # PSF-too-large guard (deconvolution.rs:872-885; the reference compares
    # the x-extent against img_cols, reproduced as it is)
    max_psf_width_x = max(int(np.ceil(wx.max() / dx)) * 2 + 1, 3)
    max_psf_width_y = max(int(np.ceil(wy.max() / dy)) * 2 + 1, 3)
    if max_psf_width_x >= img_cols or max_psf_width_y >= img_rows:
        return None

    x0s = psf_model.x0_spline.eval_const_extrap(centers32)
    y0s = psf_model.y0_spline.eval_const_extrap(centers32)

    px_list: list[np.ndarray] = []
    py_list: list[np.ndarray] = []
    n_iter = np.zeros(len(centers), np.int32)
    for i in range(len(centers32)):
        # PSF spatial range (deconvolution.rs:920-951)
        range_x = max((wx[i] + abs(x0s[i])) * 3.0, 2.5)
        range_y = max((wy[i] + abs(y0s[i])) * 3.0, 2.5)
        range_x = np.float32(np.floor(range_x / dx) * dx + dx)
        range_y = np.float32(np.floor(range_y / dy) * dy + dy)
        max_allowed_x = (img_cols - 2.0) * dx / 2.0
        max_allowed_y = (img_rows - 2.0) * dy / 2.0
        cr_x = min(float(range_x), max_allowed_x)
        cr_y = min(float(range_y), max_allowed_y)

        nx = int(np.floor(cr_x / dx))
        ny = int(np.floor(cr_y / dy))
        x = np.arange(-nx, nx + 1, dtype=np.float32) * np.float32(dx)
        y = np.arange(-ny, ny + 1, dtype=np.float32) * np.float32(dy)
        gx = gaussian(x, float(x0s[i]), float(wx[i]))
        gy = gaussian(y, float(y0s[i]), float(wy[i]))
        axis_x, axis_y = create_psf_axes(gx, gy, x, y, dx, dy)
        px_list.append(axis_x)
        py_list.append(axis_y)

        # data-derived iteration count (deconvolution.rs:969-971)
        if w_max == w_min:
            n_iter[i] = 0  # Rust: NaN as usize saturates to 0
        else:
            n_iter[i] = int(np.floor(
                (wx[i] - w_min) / (w_max - w_min) * (params.n_iterations - 1.0) + 1.0
            ))

    kr = np.array([len(p) for p in px_list], np.int32)
    kc = np.array([len(p) for p in py_list], np.int32)
    # a band's reflect pad (k // 2) must stay below the axis it pads: the
    # reference panics out of bounds there (deconvolution.rs:646-648); the
    # stage passes the cube through instead
    if int(kr.max()) // 2 >= img_rows or int(kc.max()) // 2 >= img_cols:
        return None
    # odd canvases keep the centred embedding's centre
    kr_max = int(kr.max()) | 1
    kc_max = int(kc.max()) | 1

    px = np.zeros((len(px_list), kr_max), np.float32)
    py = np.zeros((len(py_list), kc_max), np.float32)
    for i, (ax, ay) in enumerate(zip(px_list, py_list)):
        r0 = (kr_max - len(ax)) // 2
        c0 = (kc_max - len(ay)) // 2
        px[i, r0: r0 + len(ax)] = ax
        py[i, c0: c0 + len(ay)] = ay

    return BandGeometry(
        taps=taps,
        centers=centers,
        psfs=(px[:, :, None] * py[:, None, :]).astype(np.float32),
        px=px,
        py=py,
        pad_r=(kr // 2).astype(np.int32),
        pad_c=(kc // 2).astype(np.int32),
        n_iter=n_iter,
        use_fft_conv=(kr.astype(np.int64) * kc.astype(np.int64)) > DIRECT_CONV_MAX_ELEMS,
    )


# ----------------------------------------------------------------------
# Host band matrices
# ----------------------------------------------------------------------


def _factor_gram(g: np.ndarray) -> np.ndarray:
    """(B, s, s) PSD Gram matrices -> truncated eigenfactors (B, s, r) with
    ``L_b @ L_b.T ~= G_b``, so the per-trace quadratic form is a sum of
    squares ``x^T G_b x = ||L_b^T x||^2``. A narrow-band FIR's head/tail
    Grams are numerically low-rank; ``r`` is the largest rank over bands
    at the relative cutoff, rounded up to a multiple of 8."""
    b, s = g.shape[0], g.shape[-1]
    if s == 0:
        return np.zeros((b, 0, 1), np.float32)
    evals, evecs = np.linalg.eigh(g)  # ascending, f64
    lam = np.maximum(evals, 0.0)
    lmax = lam[:, -1:]
    rank = int((lam > _GRAM_EIG_RTOL * np.maximum(lmax, 1e-300)).sum(1).max())
    r = min(max(-(-max(rank, 1) // 8) * 8, 8), s)
    return (evecs[:, :, -r:] * np.sqrt(lam[:, None, -r:])).astype(np.float32)


def _energy_matrices(taps: np.ndarray, fft_len: int, n_time: int):
    """Host (f64) matrices of the windowed-convolution energy identity
    ``E_window = E_full - E_head - E_tail``; the centre window of the
    linear convolution is ``full[shift : shift + T]``, ``shift = (L-1)//2``
    (``deconvolution.rs:266-317``).

    Returns ``w2`` (m, B), the Parseval-weighted tap power with
    ``E_full(n, b) = sum_f w2[f, b] |X_nf|^2``; ``lh`` (B, hseg, r), the
    truncated eigenfactor of the head samples' Gram matrix, with
    ``E_head(n, b) = ||lh_b^T x_n[:hseg]||^2``; and ``lt`` likewise for the
    tail samples over the last ``tseg`` inputs."""
    b, l = taps.shape
    shift = (l - 1) // 2
    ltail = l - 1 - shift

    spec = np.fft.rfft(taps, n=fft_len, axis=-1)  # (B, m)
    m = spec.shape[-1]
    w = np.full(m, 2.0)
    w[0] = 1.0
    if fft_len % 2 == 0:
        w[-1] = 1.0
    w2 = (w[:, None] / fft_len * (np.abs(spec) ** 2).T).astype(np.float32)

    hseg = min(shift, n_time)
    idx = np.arange(shift)[:, None] - np.arange(hseg)[None, :]  # k - t
    mh = np.where((idx >= 0) & (idx < l), taps[:, np.clip(idx, 0, l - 1)], 0.0)
    gh = np.einsum("bkt,bks->bts", mh, mh)

    tseg = min(ltail, n_time)
    idx_t = shift + tseg + np.arange(ltail)[:, None] - np.arange(tseg)[None, :]
    mt = np.where((idx_t >= 0) & (idx_t < l), taps[:, np.clip(idx_t, 0, l - 1)], 0.0)
    gt = np.einsum("bkt,bks->bts", mt, mt)

    return w2, _factor_gram(gh), _factor_gram(gt)


def _reflect_index(h: int, pad: int, pad_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Source row of each of the ``h + 2 pad_max`` canvas rows for a band
    with reflect pad ``pad`` centred in a margin of ``pad_max``, and which
    rows lie inside the band's own padded region (the others are zero).
    The gather form of the JAX package's ``_reflect_pad_matrix``."""
    rr = np.arange(h + 2 * pad_max) - (pad_max - pad)
    src = np.abs(rr - pad)
    src = np.where(src >= h, 2 * h - 2 - src, src)
    valid = (rr >= 0) & (rr < h + 2 * pad)
    return np.clip(src, 0, h - 1), valid


def _flipped_profiles(geometry: BandGeometry) -> tuple[np.ndarray, np.ndarray]:
    """The bands' axis profiles with each band's convolution semantics
    folded in: a band the reference would FFT-convolve gets reversed
    profiles, which turns the kernel's correlation into its convolution
    (the JAX package's ``_plan_dispatch``)."""
    flip = geometry.use_fft_conv[:, None]
    pxs = np.where(flip, geometry.px[:, ::-1], geometry.px).astype(np.float32)
    pys = np.where(flip, geometry.py[:, ::-1], geometry.py).astype(np.float32)
    return pxs, pys


def _band_data(geometry: BandGeometry, shape: tuple[int, int, int], device) -> dict:
    """The geometry's band data on ``device`` for a cube of ``shape``,
    built and sent once per (device, shape)."""
    key = (str(device), tuple(shape))
    data = geometry._device_data.get(key)
    if data is not None:
        return data
    x, y, n_time = shape
    n_bands, ntaps = geometry.taps.shape
    fft_len = _conv_len(n_time + ntaps - 1)
    pad_r_max = int(geometry.pad_r.max())
    pad_c_max = int(geometry.pad_c.max())
    w2, lh, lt = _energy_matrices(geometry.taps, fft_len, n_time)
    pxs, pys = _flipped_profiles(geometry)
    rows = [_reflect_index(x, int(p), pad_r_max) for p in geometry.pad_r]
    cols = [_reflect_index(y, int(p), pad_c_max) for p in geometry.pad_c]
    taps_spec = np.fft.rfft(geometry.taps, n=fft_len, axis=-1)

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    data = dict(
        fft_len=fft_len, shift=(ntaps - 1) // 2,
        hseg=min((ntaps - 1) // 2, n_time), tseg=min(ntaps - 1 - (ntaps - 1) // 2, n_time),
        pad_r_max=pad_r_max, pad_c_max=pad_c_max,
        w2=dev(w2), lh=dev(lh), lt=dev(lt), px=dev(pxs), py=dev(pys),
        row_src=dev(np.stack([s for s, _ in rows]), torch.int64),
        row_valid=dev(np.stack([v for _, v in rows])),
        col_src=dev(np.stack([s for s, _ in cols]), torch.int64),
        col_valid=dev(np.stack([v for _, v in cols])),
        taps=dev(taps_spec.astype(np.complex64)),
        n_iter=np.asarray(geometry.n_iter, np.int64),
    )
    geometry._device_data[key] = data
    return data


# ----------------------------------------------------------------------
# Device phases
# ----------------------------------------------------------------------


def _prepare_spectra(data: torch.Tensor, bd: dict):
    """Phase a: the padded r2c spectrum of every trace (reused by the
    reconstruction), its power, and the head/tail input segments."""
    n_time = data.shape[-1]
    flat = data.reshape(-1, n_time)
    spec = torch.fft.rfft(flat, n=bd["fft_len"])  # (N, m) complex64
    power = spec.real * spec.real + spec.imag * spec.imag
    return spec, power, flat[:, : bd["hseg"]], flat[:, n_time - bd["tseg"]:]


def _energy_images(power, xh, xt, bd: dict) -> torch.Tensor:
    """Phase b, first half: the (N, B) band energies, pixel-major (the band
    sum's layout; ``energy.T.reshape(B, X, Y)`` is the images'). The clamp
    at 0 stays: f32 cancellation can round ``E_full - E_head - E_tail``
    below 0 where nearly all of a trace's band energy sits in the head/tail
    windows, and a negative energy would NaN the whole pixel."""
    e_full = power @ bd["w2"]  # (N, B)
    yh = torch.einsum("nt,btr->nbr", xh, bd["lh"])
    yt = torch.einsum("nt,btr->nbr", xt, bd["lt"])
    return torch.clamp(e_full - (yh * yh).sum(-1) - (yt * yt).sum(-1), min=0.0)


def _reflect_pad(imgs: torch.Tensor, bd: dict) -> torch.Tensor:
    """(B, X, Y) -> (B, X + 2 pad_r_max, Y + 2 pad_c_max): each band
    reflect-padded by its own pad, centred, zero outside its region."""
    b, _, y = imgs.shape
    rows = torch.gather(imgs, 1, bd["row_src"][:, :, None].expand(b, -1, y))
    h2, w2 = rows.shape[1], bd["col_src"].shape[1]
    padded = torch.gather(rows, 2, bd["col_src"][:, None, :].expand(b, h2, w2))
    valid = bd["row_valid"][:, :, None] & bd["col_valid"][:, None, :]
    return torch.where(valid, padded, 0.0).contiguous()


def _rl_operands(data: torch.Tensor, geometry: BandGeometry):
    """Phases a and b up to the Richardson-Lucy kernel: ``(bd, spec, energy,
    padded)``, the band data, the traces' spectra, the (N, B) band energies
    and the energy images' reflect-padded canvases."""
    bd = _band_data(geometry, tuple(data.shape), data.device)
    spec, power, xh, xt = _prepare_spectra(data, bd)
    energy = _energy_images(power, xh, xt, bd)
    return bd, spec, energy, _reflect_pad(energy.T.reshape(-1, *data.shape[:2]), bd)


def rl_inputs(data: torch.Tensor, geometry: BandGeometry):
    """What the Apply hands the Richardson-Lucy kernel for ``data``:
    ``(padded, px, py, n_iter)``. For checks of the kernel at the Apply's
    own shapes."""
    bd, _spec, _energy, padded = _rl_operands(data, geometry)
    return padded, bd["px"], bd["py"], bd["n_iter"]


def _band_sum(spec, u, energy, bd: dict, shape, origin) -> torch.Tensor:
    """Phase c: ``sum_b g_b * irfft(spec * T_b)`` as
    ``irfft(spec * sum_b g_b T_b)`` (the band sum's linearity,
    ``deconvolution.rs:986-1013``), keeping the centre window. The gains
    come from the estimates ``u`` cropped at the block's place on the canvas;
    ``spec`` is overwritten."""
    x, y, n_time = shape
    offset = (bd["pad_r_max"] + origin[0], bd["pad_c_max"] + origin[1])
    out = torch.fft.irfft(weighted_spectrum(spec, u, energy, bd["taps"], offset, y),
                          n=bd["fft_len"])
    return out[:, bd["shift"]: bd["shift"] + n_time].reshape(x, y, n_time)


def band_split(n_iter, world: int) -> list[np.ndarray]:
    """Each rank's bands for a sharded Apply: round-robin over the bands in
    descending-``n_iter`` order (stable), so the ranks' Σ``n_iter`` differ
    by at most one band's and each rank's subset keeps the ragged
    trip-count order the Richardson-Lucy kernel relies on."""
    order = np.argsort(-np.asarray(n_iter), kind="stable")
    return [order[r::world] for r in range(world)]


def deconvolve_cube(
    data: torch.Tensor,
    geometry: BandGeometry,
    progress: Callable[[float], None] = lambda _f: None,
    cancelled: Callable[[], bool] = lambda: False,
    *,
    mesh=None,
    origin: tuple[int, int] = (0, 0),
    grid: Optional[tuple[int, int]] = None,
) -> Optional[torch.Tensor]:
    """The banked deconvolution of the (X, Y, T) cube ``data``; returns the
    band-summed cube, or None when cancelled.

    The host checks ``cancelled()`` and reports ``progress`` before each
    group of ``rlsep.GROUP`` Richardson-Lucy iterations (the JAX
    package checks between band chunks): with ``k`` groups, progress goes
    ``0, 1/(k+1), ..., k/(k+1)`` and 1.0 at the end.

    With a ``mesh`` (``parallel.mesh``), ``data`` is this rank's block at
    ``origin`` of the (X, Y) ``grid`` (the geometry is planned for the
    grid): the spectra, energy images, gains and band sum run on the block;
    one ``grid_gather`` gives every rank the whole energy images, each rank
    runs the RL kernel on its bands (:func:`band_split`), and one
    ``all_sum`` of the zero-filled estimates gives every rank all bands.
    At each checkpoint the ranks join their cancel flags (one 4-byte
    ``all_reduce``, which waits for the device), so all stop together; a
    rank whose bands need fewer checkpoints joins the rest after its run."""
    shape = tuple(data.shape)
    grid = shape[:2] if grid is None else tuple(grid)
    dev = data.device
    with spans.span("deconv.spectra", dev):
        bd = _band_data(geometry, (*grid, shape[2]), dev)
        spec, power, xh, xt = _prepare_spectra(data, bd)
    with spans.span("deconv.energy", dev):
        energy = _energy_images(power, xh, xt, bd)
        if mesh is None:
            padded = _reflect_pad(energy.T.reshape(-1, shape[0], shape[1]), bd)
        else:
            whole = grid_gather(energy.reshape(shape[0], shape[1], -1), mesh, grid, origin)
            padded = _reflect_pad(whole.permute(2, 0, 1).contiguous(), bd)
    if mesh is None:
        u = _rl_checkpointed(padded, bd["px"], bd["py"], bd["n_iter"], progress, cancelled,
                             None)
    else:
        bands = band_split(bd["n_iter"], mesh.world)[mesh.rank]
        mine = torch.as_tensor(bands, device=data.device)
        sub = [t.index_select(0, mine).contiguous() for t in (padded, bd["px"], bd["py"])]
        u_sub = _rl_checkpointed(*sub, bd["n_iter"][bands], progress, cancelled, mesh,
                                 int(bd["n_iter"].max(initial=0)))
        if u_sub is None:
            return None
        u = all_sum(torch.zeros_like(padded).index_copy_(0, mine, u_sub), mesh)
    if u is None:
        return None
    with spans.span("deconv.band_sum", dev):
        out = _band_sum(spec, u, energy, bd, shape, origin)
    progress(1.0)
    return out


def _rl_checkpointed(padded, px, py, n_iter, progress, cancelled, mesh,
                     max_iter: Optional[int] = None) -> Optional[torch.Tensor]:
    """``rl_bands_separable`` with the checkpoints of ``max_iter`` (the
    bands' own maximum for None): ``progress`` before each, and ``cancelled``
    joined over the mesh's ranks, every rank at every checkpoint."""
    max_iter = int(np.max(n_iter, initial=0)) if max_iter is None else max_iter
    total = len(rlsep._groups(max_iter))
    done = 0

    def checkpoint() -> bool:
        nonlocal done
        stop = any_rank(cancelled(), mesh, padded.device)
        if not stop:
            progress(done / (total + 1))
        done += 1
        return stop

    # the wrapper's own counters, whatever stands in for it here
    counted = rlsep.rl_bands_separable
    with spans.span("deconv.rl", padded.device) as span:
        wide = counted.launches_wide
        u = rl_bands_separable(padded, px, py, n_iter, between=lambda _d, _t: checkpoint())
        wide = counted.launches_wide - wide
        span.annotate(wide_launches=wide, sms_per_band=list(counted.wide_blocks) if wide else [])
        while u is not None and done < total:
            if checkpoint():
                return None
        if u is not None:
            progress(total / (total + 1))
        return u
