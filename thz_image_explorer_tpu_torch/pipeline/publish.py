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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from thz_image_explorer_tpu_torch.data import ScanCube, masked_pixel_mean
from thz_image_explorer_tpu_torch.ops.fourier import polar_irfft
from thz_image_explorer_tpu_torch.ops.intensity import (
    intensity_image,
    upscaled_intensity_image,
)
from thz_image_explorer_tpu_torch.ops.optical import calculate_optical_properties
from thz_image_explorer_tpu_torch.ops.roi import masked_mean_stack
from thz_image_explorer_tpu_torch.ops.specred import lean_spectral_outputs


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


def reduce_slots(pipeline, masks: torch.Tensor) -> dict[str, torch.Tensor]:
    """The cross-pixel part of a publish: spectral means (one kernel pass
    over the raw spectrum, FD weights factored out), ROI/mean time traces,
    intensity image. ``masks``: (R, X, Y) f32 ROI stack on the final grid."""
    final = pipeline.output
    spec_slot, wvec = pipeline.spectral_source()
    sr = lean_spectral_outputs(spec_slot.fft, wvec, masks, final.valid_wh)
    if pipeline.config.avg_in_fourier_space:
        # ROI traces from polar means (math_tools.rs:496-529)
        roi_trace = polar_irfft(sr["roi_amp"], sr["roi_ph"], final.n_time)
        avg_signal = final.avg_data
    else:
        roi_trace = masked_mean_stack(final.data, masks)
        avg_signal = masked_pixel_mean(final.data, final.valid_wh)
    if final.scaling > 1:
        image = upscaled_intensity_image(final.data, final.scaling)
    else:
        image = intensity_image(final.data)
    return dict(
        avg_signal=avg_signal,
        avg_signal_fft=sr["avg_amp"],
        avg_phase_fft=sr["avg_ph"],
        roi_amp=sr["roi_amp"],
        roi_ph=sr["roi_ph"],
        roi_trace=roi_trace,
        image=image,
    )


def _pixel(cube: ScanCube, pixel) -> tuple[int, int]:
    px, py = pixel
    return (min(px // cube.scaling, cube.width - 1),
            min(py // cube.scaling, cube.height - 1))


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
        key = (pipeline.run_epoch, roi_key)
        if key != self._key:
            self._reduced = reduce_slots(pipeline, masks)
            self._reduced_host = _to_host(dict(
                self._reduced,
                time=raw.time,
                frequencies=raw_fd.freq,
                filtered_time=final.time,
                filtered_frequencies=final.freq,
            ))
            self._key = key
        red = self._reduced

        rx, ry = _pixel(raw, pixel)
        fx, fy = _pixel(raw_fd, pixel)
        gx, gy = _pixel(final, pixel)
        sel = dict(
            signal=raw.data[rx, ry],
            signal_fft=raw_fd.amplitudes[fx, fy],
            phase_fft=raw_fd.phases[fx, fy],
            filtered_signal=final.data[gx, gy],
            filtered_signal_fft=final.amplitudes[gx, gy],
            filtered_phase_fft=final.phases[gx, gy],
        )
        # optical properties (data_thread.rs:1489-1559)
        if optical is not None:
            def pick(side):
                mode = optical[f"{side}_mode"]
                if mode == "roi":
                    i = optical[f"{side}_idx"]
                    return red["roi_amp"][i], red["roi_ph"][i]
                if mode == "pseudo":
                    pseudo = torch.as_tensor(optical[f"{side}_pseudo"], device=final.device)
                    return pseudo[0], pseudo[1]
                return sel["filtered_signal_fft"], sel["filtered_phase_fft"]

            (ref_amp, ref_ph), (samp_amp, samp_ph) = pick("ref"), pick("samp")
            n, alpha, kappa = calculate_optical_properties(
                samp_amp, samp_ph, ref_amp, ref_ph, final.freq,
                float(optical["thickness"]),
            )
            sel.update(
                refractive_index=n,
                absorption_coefficient=alpha,
                extinction_coefficient=kappa,
            )
        return dict(self._reduced_host, **_to_host(sel))
