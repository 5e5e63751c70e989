"""The fused interactive update over a whole cube or one rank's block.

Port of ``thz_image_explorer_tpu/parallel/step.py``: the non-deconvolution
chain in ``_step``'s order (scale -> time band-pass -> window + rFFT ->
frequency band-pass -> water notch -> iRFFT -> time band-pass ->
intensity) as one call, for batch processing and the multi-device path.
:func:`interactive_update` returns the chain's cube; :func:`lean_update`
returns only what an interactive update publishes, with the spectral means
from one pass of the spectral-reduction kernel (``ops/specred``) over the
raw spectrum.

With a ``mesh`` (``parallel.mesh``), ``cube`` is this rank's
:meth:`~thz_image_explorer_tpu_torch.parallel.mesh.Mesh.block`: every
per-pixel output stays on the rank, on the mesh's block of the output grid
(after a downscale, the layout of ``Pipeline(mesh=)``: ``ops/scaling``
brings the source rows a downscaled block lacks), and the cross-pixel sums
are joined with one :func:`~thz_image_explorer_tpu_torch.parallel.mesh.all_sum`
before they are divided by the global valid-pixel count (the phase unwrap is
finished after the sum: it is linear). The FFTs go through
``ops/fourier.batch_fft``, as the ``Pipeline``'s do. Without a mesh it is
the single-device function; a mesh of one rank gives the same values.

Not ported: the XLA variants of the JAX ``StepConfig`` (``lean_phases``,
``specred``, ``fold_fd``, ``wide_spec``), their ``_resolve_cfg`` and
``THZ_*`` environment reads, the kernel latch-and-retry and
``lean_update_lowered``: the port always takes the specred route and has
no compiled-program cache to describe.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.assets.water_lines import WATER_LINES_THZ
from thz_image_explorer_tpu_torch.data import ScanCube
from thz_image_explorer_tpu_torch.ops import bandpass as bp
from thz_image_explorer_tpu_torch.ops.fourier import batch_fft, forward_fft, inverse_fft, unwrap
from thz_image_explorer_tpu_torch.ops.intensity import intensity_image
from thz_image_explorer_tpu_torch.ops.scaling import scale_cube
from thz_image_explorer_tpu_torch.ops.specred import lean_spectral_finish, lean_spectral_sums
from thz_image_explorer_tpu_torch.ops.windows import WindowType, window_array
from thz_image_explorer_tpu_torch.parallel.mesh import Mesh, all_sum, block_slice, valid_mask


class StepConfig(NamedTuple):
    """The choices that change the result: window type, downscale factor,
    the four stages' on/off flags and averaging in Fourier space."""

    window_type: WindowType = WindowType.ADAPTED_BLACKMAN
    scale: int = 1
    td_before_active: bool = False
    fd_active: bool = False
    notch_active: bool = False
    td_after_active: bool = False
    avg_in_fourier_space: bool = False


@dataclasses.dataclass(frozen=True)
class StepParams:
    """The sliders' values (the JAX ``StepParams`` defaults)."""

    window_low: float = 1.0
    window_high: float = 7.0
    td_before_low: float = 0.0
    td_before_high: float = 1e9
    td_before_width: float = 2.0
    fd_low: float = 0.2
    fd_high: float = 5.0
    fd_width: float = 0.1
    notch_width: float = 0.05
    notch_depth: float = 1.0
    td_after_low: float = 0.0
    td_after_high: float = 1e9
    td_after_width: float = 0.1
    water_lines: np.ndarray = dataclasses.field(
        default_factory=lambda: np.asarray(WATER_LINES_THZ, np.float32))

    @staticmethod
    def defaults() -> "StepParams":
        """The default values (the JAX package's; its water-lines table
        placed on the device there, moved where it is used here)."""
        return StepParams()

    @staticmethod
    def defaults_np() -> "StepParams":
        """The default values with host leaves: the same as
        :meth:`defaults` in the port."""
        return StepParams()


def _spectrum(cube: ScanCube, params: StepParams, cfg: StepConfig,
              mesh: Optional[Mesh] = None) -> tuple[ScanCube, torch.Tensor]:
    """Scale, TD band-pass, window: ``(cube, window)`` with the windowed
    traces not yet multiplied in."""
    c = scale_cube(cube, cfg.scale, valid_wh=cube.valid_wh, mesh=mesh)
    if cfg.td_before_active:
        c = c.replace(data=bp.td_bandpass(c.data, c.time, params.td_before_low,
                                          params.td_before_high, params.td_before_width))
    return c, window_array(c.time, cfg.window_type, params.window_low, params.window_high)


def _fd_weights(freq: torch.Tensor, params: StepParams, cfg: StepConfig) -> torch.Tensor:
    """The product of the active FD stages' per-frequency weights."""
    w = torch.ones_like(freq)
    if cfg.fd_active:
        w = w * bp.fd_bandpass_weights(freq, params.fd_low, params.fd_high, params.fd_width)
    if cfg.notch_active:
        w = w * bp.water_notch_weights(freq, _lines(params, freq), params.notch_width,
                                       params.notch_depth)
    return w


def _lines(params: StepParams, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(params.water_lines, np.float32), device=like.device)


def _finish_data(data: torch.Tensor, time: torch.Tensor, params: StepParams,
                 cfg: StepConfig) -> torch.Tensor:
    if cfg.td_after_active:
        data = bp.td_bandpass(data, time, params.td_after_low, params.td_after_high,
                              params.td_after_width)
    return data


def interactive_update(cube: ScanCube, params: StepParams, cfg: StepConfig,
                       mesh: Optional[Mesh] = None) -> tuple[ScanCube, torch.Tensor]:
    """One update of the whole chain: ``(cube_out, intensity image)``.
    ``cube_out`` holds the filtered traces, spectra, amplitudes and
    unwrapped phases (of this rank's block with a mesh) and the pixel
    means over the whole grid."""
    c, _ = _spectrum(cube, params, cfg, mesh)
    c = forward_fft(c, cfg.window_type, params.window_low, params.window_high)
    if cfg.fd_active:
        fft, amps = bp.fd_bandpass(c.fft, c.amplitudes, c.freq, params.fd_low, params.fd_high,
                                   params.fd_width)
        c = c.replace(fft=fft, amplitudes=amps)
    if cfg.notch_active:
        fft, amps = bp.water_notch(c.fft, c.amplitudes, c.freq, _lines(params, c.freq),
                                   params.notch_width, params.notch_depth)
        c = c.replace(fft=fft, amplitudes=amps)
    # the block's sums over the global valid count, joined over the ranks
    c = inverse_fft(c, cfg.avg_in_fourier_space, mesh)
    c = c.replace(data=_finish_data(c.data, c.time, params, cfg))
    return c, intensity_image(c.data)


def lean_update(cube: ScanCube, params: StepParams, cfg: StepConfig, masks: torch.Tensor,
                pix, mesh: Optional[Mesh] = None) -> dict[str, torch.Tensor]:
    """The publish-shaped update: the chain plus the publish reductions.

    ``masks``: (R, X', Y') f32 ROI stack and ``pix`` the selected pixel,
    both on the whole output grid (after the downscale). Returns ``data``
    and ``img`` (the block's with a mesh), ``avg_signal`` and ``roi_trace``
    (time-domain means), ``pix_sig``, ``pix_amp``, ``pix_ph`` (the selected
    pixel's trace, amplitude and unwrapped phase), ``avg_fft``,
    ``avg_amp``, ``avg_ph``, ``roi_amp``, ``roi_ph`` (spectral means from
    the raw spectrum, the FD weights factored out), as the JAX
    ``lean_update``. One ``all_sum`` joins every cross-pixel sum."""
    c, window = _spectrum(cube, params, cfg, mesh)
    spec = batch_fft(torch.fft.rfft, c.data * window, c)
    wvec = _fd_weights(c.freq, params, cfg)
    data = _finish_data(batch_fft(torch.fft.irfft, spec * wvec, c, n=c.n_time), c.time, params,
                        cfg)

    block_masks = block_slice(masks, c).to(torch.float32).contiguous()
    r, t, nf = masks.shape[0], c.n_time, c.n_freq
    sums = lean_spectral_sums(spec, block_masks, valid_mask(c), with_complex=True)
    # the selected pixel's rows: its owner writes them, the others zeros
    gx, gy = c.grid_wh
    px = min(max(int(pix[0]), 0), gx - 1)
    py = min(max(int(pix[1]), 0), gy - 1)
    lx, ly = px - c.origin[0], py - c.origin[1]
    if 0 <= lx < c.width and 0 <= ly < c.height:
        z = spec[lx, ly]
        pix_rows = torch.cat([data[lx, ly], torch.abs(z) * wvec, unwrap(torch.angle(z))])
    else:
        pix_rows = data.new_zeros(t + 2 * nf)
    flat = block_masks.reshape(r, -1)
    joined = all_sum(torch.cat([
        torch.stack(sums).reshape(-1), (flat @ data.reshape(-1, t)).reshape(-1),
        data.sum(dim=(0, 1)), pix_rows]), mesh)

    n_sum = 4 * (1 + r) * nf
    amp_s, inc_s, re_s, im_s = joined[:n_sum].reshape(4, 1 + r, nf)
    roi_sum = joined[n_sum: n_sum + r * t].reshape(r, t)
    data_sum = joined[n_sum + r * t: n_sum + r * t + t]
    pix_rows = joined[n_sum + r * t + t:]
    counts = masks.to(torch.float32).sum(dim=(1, 2))
    vcnt = max(int(c.valid_wh[0]) * int(c.valid_wh[1]), 1)
    spectral = lean_spectral_finish((amp_s, inc_s, re_s, im_s), wvec, counts, vcnt)
    return dict(
        data=data,
        img=intensity_image(data),
        avg_signal=data_sum / vcnt,
        roi_trace=torch.where(counts[:, None] > 0,
                              roi_sum / torch.clamp(counts, min=1.0)[:, None], 0.0),
        pix_sig=pix_rows[:t],
        pix_amp=pix_rows[t: t + nf],
        pix_ph=pix_rows[t + nf:],
        avg_fft=spectral["avg_fft"],
        avg_amp=spectral["avg_amp"],
        avg_ph=spectral["avg_ph"],
        roi_amp=spectral["roi_amp"],
        roi_ph=spectral["roi_ph"],
    )
