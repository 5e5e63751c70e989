"""Plot publication over the materialized pipeline slots.

Port of ``thz_image_explorer_tpu/pipeline/publish.py`` (reference
``data_thread.rs:1336-1560``) as ONE publish function with the keys of the
JAX ``_publish_program``. It has two parts:

* the reductions, which depend only on the slots and the ROI set: the
  pixel-mean and ROI spectral means from one pass of the spectral
  reduction kernel (``ops/specred``, one launch per 16 masks) over the FFT
  stage's raw spectrum, the ROI and pixel-mean time traces, and the
  intensity image. They are cached on the pipeline's run epoch and the ROI
  set;
* the selection, which a pixel click or an optical-selection change
  recomputes alone: gathers of the selected pixel from the cached slots
  and the (F,)-sized optical-property math. No chain recompute and no
  kernel launch.

The same code serves a single device and a mesh (a pipeline built with
``mesh=``, ``parallel.mesh``), where each rank publishes from its blocks
and gets the whole series: the masks stay ``(R, X', Y')`` on the whole
output grid and each rank reduces its slice; the reductions make one
``all_sum`` of every cross-pixel sum (the specred sums, the ROI and mean
time traces) and of the image (each rank's block placed in a zero-filled
whole grid, as ``grid_gather`` does), and divide by the whole grid's counts
after the join. The selection is written by the rank that holds the pixel
in each slot, zeros elsewhere, and rides in the same ``all_sum``; a click
makes one ``all_sum`` of the selection alone and nothing else. On a single
device the sums are used as they are, with no copy and no collective
(``parallel.mesh.all_sum_parts``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube, masked_pixel_mean, masked_pixel_sum
from thz_image_explorer_tpu_torch.ops.fourier import polar_irfft
from thz_image_explorer_tpu_torch.ops.intensity import intensity_image, upscale_image
from thz_image_explorer_tpu_torch.ops.optical import calculate_optical_properties
from thz_image_explorer_tpu_torch.ops.roi import masked_mean_stack, masked_sum_stack
from thz_image_explorer_tpu_torch.ops.specred import lean_spectral_finish, lean_spectral_sums
from thz_image_explorer_tpu_torch.parallel.mesh import (
    all_sum_parts,
    block_slice,
    grid_place,
    valid_mask,
)


def _to_host(tensors: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Copy a dict of f32 tensors to numpy in ONE device->host transfer."""
    if not tensors:
        return {}
    flat = torch.cat([t.reshape(-1) for t in tensors.values()]).cpu().numpy()
    out, pos = {}, 0
    for key, t in tensors.items():
        out[key] = flat[pos: pos + t.numel()].reshape(tuple(t.shape))
        pos += t.numel()
    return out


def reduce_slots(pipeline, masks: torch.Tensor, extra: list[torch.Tensor] = ()):
    """The cross-pixel part of a publish: spectral means (one kernel pass
    over the raw spectrum, FD weights factored out), ROI/mean time traces,
    intensity image. ``masks``: (R, X, Y) f32 ROI stack on the final slot's
    whole grid; ``extra``: f32 tensors of this rank's part of other sums
    (the selection). Returns ``(reductions, extra joined)``.

    The slots' pixel sums over their slice of the masks and the image
    placed in a zero-filled whole grid are joined with ``extra`` in ONE
    ``all_sum`` (none on a single device); the divisions by the whole
    grid's counts come after it, so every rank of a mesh gets the single
    device's values."""
    final = pipeline.output
    spec_slot, wvec = pipeline.spectral_source()
    block_masks = block_slice(masks, final).to(torch.float32).contiguous()
    valid = valid_mask(final)
    r, t = masks.shape[0], final.n_time
    amp_s, inc_s, _, _ = lean_spectral_sums(spec_slot.fft, block_masks, valid)
    fourier = pipeline.config.avg_in_fourier_space
    parts = [amp_s, inc_s, grid_place(intensity_image(final.data), final.grid_wh, final.origin)]
    if not fourier:
        parts += [masked_sum_stack(final.data, block_masks), masked_pixel_sum(final.data, valid)]
    joined = all_sum_parts(parts + list(extra), pipeline.mesh)
    amp_s, inc_s, image = joined[:3]
    counts = masks.to(torch.float32).sum(dim=(1, 2))
    vcnt = max(int(final.valid_wh[0]) * int(final.valid_wh[1]), 1)
    sr = lean_spectral_finish((amp_s, inc_s, None, None), wvec, counts, vcnt)
    if fourier:
        # ROI traces from polar means (math_tools.rs:496-529); with no ROI
        # the batch is empty, which the FFT libraries refuse
        roi_trace = (polar_irfft(sr["roi_amp"], sr["roi_ph"], t)
                     if r else sr["roi_amp"].new_zeros((0, t)))
        avg_signal = final.avg_data
    else:
        roi_sum, data_sum = joined[3:5]
        roi_trace = torch.where(counts[:, None] > 0,
                                roi_sum / torch.clamp(counts, min=1.0)[:, None], 0.0)
        avg_signal = data_sum / vcnt
    if final.scaling > 1:
        image = upscale_image(image, final.scaling)
    return dict(
        avg_signal=avg_signal,
        avg_signal_fft=sr["avg_amp"],
        avg_phase_fft=sr["avg_ph"],
        roi_amp=sr["roi_amp"],
        roi_ph=sr["roi_ph"],
        roi_trace=roi_trace,
        image=image,
    ), joined[len(parts):]


def _pixel(cube: ScanCube, pixel) -> tuple[int, int]:
    """The selected pixel (native resolution) on ``cube``'s grid, clamped
    to the grid."""
    px, py = pixel
    gx, gy = cube.grid_wh
    return (min(max(px // cube.scaling, 0), gx - 1),
            min(max(py // cube.scaling, 0), gy - 1))


#: the selection's rows: (slot, field, published key)
_SELECTION = (("raw", "data", "signal"), ("raw_fd", "amplitudes", "signal_fft"),
              ("raw_fd", "phases", "phase_fft"), ("final", "data", "filtered_signal"),
              ("final", "amplitudes", "filtered_signal_fft"),
              ("final", "phases", "filtered_phase_fft"))


def _selection(slots: dict[str, ScanCube], pixel, mesh) -> dict[str, torch.Tensor]:
    """This rank's part of the selected pixel's six rows: each row as its
    owner (``Mesh.owner``: every slot is the mesh's block of its grid; this
    process on a single device) has it, zeros on the other ranks, so that a
    sum over the ranks is an exact copy."""
    rows = {}
    for slot, field, key in _SELECTION:
        cube = slots[slot]
        gx, gy = _pixel(cube, pixel)
        t = getattr(cube, field)
        if mesh is None or mesh.owner((gx, gy), cube.grid_wh) == mesh.rank:
            rows[key] = t[gx - cube.origin[0], gy - cube.origin[1]]
        else:
            rows[key] = t.new_zeros(t.shape[2])
    return rows


class Publisher:
    """Publishes plot series from a pipeline's slots, caching the
    reductions between publishes that share the run epoch and ROI set."""

    def __init__(self):
        self._key = None
        self._reduced: Optional[dict[str, torch.Tensor]] = None
        self._reduced_host: dict[str, np.ndarray] = {}

    def publish(self, pipeline, masks: torch.Tensor, roi_key, pixel,
                optical: Optional[dict] = None) -> dict[str, np.ndarray]:
        """Every published series as host numpy.

        ``masks``: (R, X, Y) f32 ROI stack on the final slot's grid and
        ``roi_key`` a hashable that changes whenever it does; ``pixel``
        the selected pixel at native resolution. ``optical`` (optional):
        ``ref_mode`` ("roi" or "pseudo"), ``ref_idx`` (ROI index of the
        reference), ``ref_pseudo`` ((2, F) host amplitude and phase of a
        loaded pulse), ``samp_mode`` ("roi", "pixel" or "pseudo"),
        ``samp_idx``, ``samp_pseudo`` and ``thickness`` (m)."""
        raw, raw_fd, final = pipeline.input, pipeline.raw_fd_view(), pipeline.output
        mesh = pipeline.mesh
        rows = _selection(dict(raw=raw, raw_fd=raw_fd, final=final), pixel, mesh)
        # on a mesh every rank runs the same commands, so the run epoch and
        # the ROI key are equal on every rank and all ranks take (or skip)
        # the reductions' collective together; the selection rides in it,
        # or makes the one collective of a click
        key = (pipeline.run_epoch, roi_key)
        if key != self._key:
            self._reduced, joined = reduce_slots(pipeline, masks, list(rows.values()))
            self._reduced_host = _to_host(dict(
                self._reduced,
                time=raw.time,
                frequencies=raw_fd.freq,
                filtered_time=final.time,
                filtered_frequencies=final.freq,
            ))
            self._key = key
        else:
            joined = all_sum_parts(list(rows.values()), mesh)
        sel = dict(zip(rows, joined))
        if optical is not None:
            sel.update(_optical(optical, self._reduced, sel, final))
        return dict(self._reduced_host, **_to_host(sel))


def _optical(optical: dict, reduced: dict, sel: dict, final: ScanCube) -> dict:
    """n, alpha and kappa of the optical selection (``data_thread.rs:
    1489-1559``): the reference and the sample each an ROI's mean spectrum
    (``reduced``), a loaded pulse ("pseudo") or, for the sample, the
    selected pixel's spectrum (``sel``)."""
    def pick(side):
        mode = optical[f"{side}_mode"]
        if mode == "roi":
            i = optical[f"{side}_idx"]
            return reduced["roi_amp"][i], reduced["roi_ph"][i]
        if mode == "pseudo":
            pseudo = torch.as_tensor(optical[f"{side}_pseudo"], device=final.device)
            return pseudo[0], pseudo[1]
        return sel["filtered_signal_fft"], sel["filtered_phase_fft"]

    (ref_amp, ref_ph), (samp_amp, samp_ph) = pick("ref"), pick("samp")
    n, alpha, kappa = calculate_optical_properties(
        samp_amp, samp_ph, ref_amp, ref_ph, final.freq, float(optical["thickness"]))
    return dict(refractive_index=n, absorption_coefficient=alpha, extinction_coefficient=kappa)


#: :func:`gather_publish`'s optical selection where the caller names none
_GATHER_OPTICAL = dict(ref_mode="none", samp_mode="pixel", ref_idx=0, samp_idx=0, thickness=1.0)


def gather_publish(raw: ScanCube, raw_fd: ScanCube, filtered: ScanCube, masks, pixel,
                   avg_fourier: bool, optical: Optional[dict] = None) -> dict[str, np.ndarray]:
    """Every published series of three whole, materialized slots (the raw
    one, the raw spectrum's, the final one) without a pipeline, in one
    device-to-host transfer: the JAX package's standalone publish. Unlike
    :meth:`Publisher.publish`, the ROI spectra are masked means of the
    final slot's own amplitudes and phases, and the pixel-mean spectra are
    the final slot's. ``masks``: (R, X, Y) f32 on the final slot's grid,
    host numpy or a tensor (R may be 0); ``pixel`` at native resolution;
    ``optical`` as :meth:`Publisher.publish`'s, with ``ref_mode`` "none"
    (the default) for no n/alpha/kappa."""
    masks = torch.as_tensor(masks, dtype=torch.float32, device=filtered.device)
    roi_amp = masked_mean_stack(filtered.amplitudes, masks)
    roi_ph = masked_mean_stack(filtered.phases, masks)
    n_time = filtered.n_time
    if avg_fourier:
        # ROI traces from polar means (math_tools.rs:496-529)
        roi_trace = (polar_irfft(roi_amp, roi_ph, n_time) if masks.shape[0]
                     else roi_amp.new_zeros((0, n_time)))
        avg_signal = filtered.avg_data
    else:
        roi_trace = masked_mean_stack(filtered.data, masks)
        avg_signal = masked_pixel_mean(filtered.data, filtered.valid_wh)
    image = intensity_image(filtered.data)
    if filtered.scaling > 1:
        image = upscale_image(image, filtered.scaling)
    sel = _selection(dict(raw=raw, raw_fd=raw_fd, final=filtered), pixel, None)
    reduced = dict(roi_amp=roi_amp, roi_ph=roi_ph)
    out = dict(time=raw.time, frequencies=raw_fd.freq, filtered_time=filtered.time,
               filtered_frequencies=filtered.freq, **sel, avg_signal=avg_signal,
               avg_signal_fft=filtered.avg_signal_fft, avg_phase_fft=filtered.avg_phase_fft,
               roi_trace=roi_trace, image=image, **reduced)
    opt = {**_GATHER_OPTICAL, **(optical or {})}
    if opt["ref_mode"] != "none":
        out.update(_optical(opt, reduced, sel, filtered))
    return _to_host(out)
