"""The filter chain and the publish, written from their definitions.

Given the raw cube and a session state (the FFT window's low edge, the tilt,
whether an Apply has run), :func:`published` gives every series the
Explorer publishes: the selected pixel's traces and spectra from the raw,
raw-spectrum and final stages, the pixel-mean and ROI means, the intensity
image and the optical constants. Stage by stage, as the reference
application composes them (``data_thread.rs:1080-1228``, the numpy oracle
``tests/oracle_chain.py``):

DC offset (sample 0) -> tilt -> time band-pass -> adapted-Blackman window
(written into the data) + real DFT, amplitudes, unwrapped phases ->
frequency band-pass -> water-vapour notch (complex spectrum and amplitudes
weighted, phases kept) -> inverse DFT -> deconvolution (an Apply).

Every transform is a DFT matrix product (``numerics.Numerics``), float64 in
the reference and TF32 in the control. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import deconv, geometry
from portbench.reference.numerics import Numerics

#: f32 pi, the threshold of the reference application's f32 unwrap
PI_F32 = float(np.float32(math.pi))
TWO_PI_F32 = float(np.float32(2.0 * math.pi))
C_M_PER_S = 2.99792458e8

#: rotational H2O lines, THz (the reference application's
#: ``assets/water_lines.csv``), as f32 values
WATER_LINES_THZ = np.asarray((
    0.562, 0.757, 0.993, 1.102, 1.118, 1.168, 1.213, 1.234, 1.416, 1.607,
    1.666, 1.675, 1.722, 1.8, 1.802, 1.873, 1.924, 2.045, 2.079, 2.169,
    2.201, 2.227, 2.269, 2.349, 2.371, 2.397, 2.468, 2.636, 2.645, 2.67,
    2.691, 2.779, 2.885, 2.889, 2.89, 2.974, 2.976, 3.004, 3.018, 3.049,
    3.132, 3.14, 3.171, 3.173, 3.187, 3.215, 3.235, 3.336, 3.5, 3.542,
    3.605, 3.618, 3.66, 3.696, 3.803, 3.812, 3.86, 3.954, 3.958, 3.982,
    4.005, 4.172, 4.196, 4.223, 4.245, 4.474, 4.517, 4.541, 4.605, 4.729,
    4.739, 4.769, 4.988, 5.003, 5.112, 5.2, 5.206, 5.282, 5.286, 5.328,
    5.443, 5.505, 5.634, 5.647, 5.676, 5.805, 5.831, 5.832, 5.875, 5.926,
    5.999, 6.075, 6.081, 6.088, 6.138, 6.238, 6.254, 6.327, 6.377, 6.378,
    6.38, 6.418, 6.437, 6.651, 6.712, 6.788, 6.835, 6.922, 6.937, 7.0,
    7.326, 7.36, 7.373, 7.437, 7.614, 7.618, 7.619, 7.985, 8.284, 8.347,
    8.355, 8.41, 8.457, 8.467, 8.682, 8.721, 8.951, 9.055, 9.088, 9.092,
    9.451, 9.707, 9.716, 9.825, 9.826,
), np.float32)


# ------------------------------------------------------------ weight vectors
def blackman(n, m):
    """Blackman value with the reference's NaN -> 1 and [0, 1] clamp."""
    with np.errstate(invalid="ignore", divide="ignore"):
        res = 0.42 - 0.5 * np.cos(2.0 * np.pi * n / m) + 0.08 * np.cos(4.0 * np.pi * n / m)
    return np.where(np.isnan(res), 1.0, np.clip(res, 0.0, 1.0))


def adapted_blackman(axis, lower, upper):
    """Taper the first ``lower`` and last ``upper`` axis units; the head
    taper wins where both apply. Which samples lie in the head and the tail
    is decided in f32, the reference application's type for axes and
    bounds; the taper's values are float64."""
    a32 = np.asarray(axis, np.float32)
    head = a32 <= np.float32(lower) + a32[0]
    tail = a32 >= a32[-1] - np.float32(upper)
    axis = a32.astype(np.float64)
    t0, t_end = axis[0], axis[-1]
    return np.where(head, blackman(axis - t0, 2.0 * lower),
                    np.where(tail, blackman(axis - (t_end - 2.0 * upper), 2.0 * upper), 1.0))


def td_bandpass_weights(time, low, high, width):
    """Zero outside ``[lower, upper)``, an adapted-Blackman slice inside:
    ``lower`` the first sample at or after ``low``, ``upper`` the first at
    or after ``high`` (the last when none), at least ``lower + 1``."""
    time = np.asarray(time, np.float32)
    n = len(time)
    low, high = max(np.float32(low), time[0]), min(np.float32(high), time[-1])
    ge_low = np.nonzero(time >= low)[0]
    lower = int(ge_low[0]) if len(ge_low) else 0
    ge_high = np.nonzero(time >= high)[0]
    upper = int(ge_high[0]) if len(ge_high) else n - 1
    upper = min(max(upper, lower + 1), n)
    w = np.zeros(n)
    w[lower:upper] = adapted_blackman(time[lower:upper], width, width)
    return w


def frequency_axis(time) -> np.ndarray:
    """``i / (time[-1] - time[0])`` THz for ``i`` up to ``T // 2``, in f32
    as the reference application computes it (``io.rs:614-621``)."""
    time = np.asarray(time, np.float32)
    return np.arange(len(time) // 2 + 1, dtype=np.float32) / (time[-1] - time[0])


def fd_bandpass_weights(freq, low, high, width):
    """Zero outside ``[lower, upper)``: ``lower`` the first bin at or above
    ``low``, ``upper`` one past the last bin at or below ``high``."""
    freq = np.asarray(freq, np.float32)
    n = len(freq)
    ge = np.nonzero(freq >= max(np.float32(low), np.float32(0.0)))[0]
    lower = int(ge[0]) if len(ge) else 0
    le = np.nonzero(freq <= min(np.float32(high), freq[-1]))[0]
    upper = int(le[-1]) + 1 if len(le) else n
    w = np.zeros(n)
    w[lower:upper] = adapted_blackman(freq[lower:upper], width, width)
    return w


def notch_weights(freq, lines, width, depth):
    """Product over the lines of ``1 - depth * blackman`` within ``width``
    (which bins lie within, decided in f32)."""
    f32 = np.asarray(freq, np.float32)
    freq = f32.astype(np.float64)
    w = np.ones_like(freq)
    depth = min(max(depth, 0.0), 1.0)
    for c in np.asarray(lines, np.float32):
        inside = np.abs(f32 - c) <= np.float32(width)
        w *= np.where(inside, 1.0 - depth * blackman(freq - (float(c) - width), 2.0 * width), 1.0)
    return w


def unwrap(phase: torch.Tensor) -> torch.Tensor:
    """Unwrap along the last axis: each step outside ``[-pi, pi]`` (f32 pi,
    strict comparisons) corrected once by 2 pi, then summed."""
    d = phase[..., 1:] - phase[..., :-1]
    d = d - TWO_PI_F32 * (d > PI_F32).to(d.dtype) + TWO_PI_F32 * (d < -PI_F32).to(d.dtype)
    return torch.cumsum(torch.cat([phase[..., :1], d], dim=-1), dim=-1)


# ------------------------------------------------------------------ chain
def session_filters(cfg: dict) -> dict:
    """The parameters of the configuration's active filters (the program's
    defaults where the configuration names none)."""
    f = cfg["filters"]
    return dict(td_before=f.get("time_band_pass_before_fft", False),
                fd=f.get("frequency_band_pass", False),
                notch=f.get("water_vapor_notch", False),
                td_width=2.0, fd_low=0.2, fd_high=5.0, fd_width=0.1,
                notch_width=0.02, notch_depth=1.0)


def chain(raw: torch.Tensor, time: np.ndarray, cfg: dict, state: dict, num: Numerics) -> dict:
    """The slots the publish reads, for ``state`` (``fft_window_low``,
    ``fft_window_high``, ``tilt`` (None or (x, y) degrees))."""
    flt = session_filters(cfg)
    time0 = np.asarray(time, np.float32)
    data0 = raw.to(num.dtype)
    data0 = data0 - data0[:, :, :1]
    x_n, y_n, n_time0 = data0.shape
    data, t_axis = data0, time0
    if state.get("tilt") is not None:
        data, t_axis = tilt(data0, time0, cfg, state["tilt"], num)
    n_time = len(t_axis)
    if flt["td_before"]:
        # the stage's bounds are the opened scan's whole range, clamped to
        # the axis it filters
        w = td_bandpass_weights(t_axis, float(time0[0]), float(time0[-1]), flt["td_width"])
        data = data * num.tensor(w)
    win = adapted_blackman(t_axis, state["fft_window_low"], state.get("fft_window_high", 7.0))
    data = data * num.tensor(win)
    re, im = num.rfft(data)
    amp_raw = torch.sqrt(re * re + im * im)
    phases = unwrap(torch.atan2(im, re))
    freq = frequency_axis(t_axis)
    w_fd = fd_bandpass_weights(freq, flt["fd_low"], flt["fd_high"], flt["fd_width"]) \
        if flt["fd"] else np.ones_like(freq)
    w_notch = notch_weights(freq, WATER_LINES_THZ, flt["notch_width"], flt["notch_depth"]) \
        if flt["notch"] else np.ones_like(freq)
    w_all = num.tensor(w_fd * w_notch)
    final = num.irfft(re * w_all, im * w_all, n_time)
    return dict(time0=time0, data0=data0, time=t_axis, freq=freq, amp_raw=amp_raw,
                phases=phases, w_fd=num.tensor(w_fd), w_all=w_all, final=final,
                shape=(x_n, y_n))


def tilt(data: torch.Tensor, time: np.ndarray, cfg: dict, angles, num: Numerics):
    """Each pixel's trace, windowed over [0, 7] ps, inserted at its own
    offset in the extended axis; the head holds the pixel's first sample,
    the tail zeros."""
    s = cfg["scan"]
    x_n, y_n, n_time = data.shape
    steps = geometry.extension_steps(x_n, y_n, s["dx_mm"], s["dy_mm"], *angles)
    new_time = geometry.extended_time(time, steps)
    insert = torch.as_tensor(geometry.pixel_shifts(x_n, y_n, s["dx_mm"], s["dy_mm"],
                                                   *angles, steps), device=num.device)
    win = num.tensor(adapted_blackman(time, 0.0, 7.0))
    k = torch.arange(len(new_time), device=num.device)
    idx = k[None, None, :] - insert[:, :, None]
    src = torch.gather(data * win, 2, idx.clamp(0, n_time - 1))
    out = torch.where(idx < 0, data[:, :, :1], torch.where(idx < n_time, src, 0.0))
    return out, new_time


# ---------------------------------------------------------------- publish
def masks_of(cfg: dict) -> np.ndarray:
    """(R, X, Y) bool masks of the configuration's ROIs."""
    s = cfg["scan"]
    return np.stack([geometry.polygon_mask(p, (s["width"], s["height"])) for p in cfg["rois"]])


def published(raw, time, cfg, state, pixel, num: Numerics, slots=None) -> dict:
    """Every published series (host float64 numpy) for ``state``; with
    ``state["deconvolved"]`` the final traces are the deconvolution's.
    ``slots``: :func:`chain`'s result for this state, if already made."""
    sl = slots if slots is not None else chain(raw, time, cfg, state, num)
    x_n, y_n = sl["shape"]
    px, py = pixel
    masks = torch.as_tensor(masks_of(cfg), device=num.device).to(num.dtype)
    flat_masks = masks.reshape(len(masks), -1)
    counts = flat_masks.sum(1)
    n_pix = x_n * y_n
    final = sl["final"]
    if state.get("deconvolved"):
        final = deconv.deconvolve(final, sl["time"], cfg, num)
    nf = final.shape[-1]
    amp_w = sl["amp_raw"] * sl["w_all"]

    def roi_mean(x):
        sums = num.mm(flat_masks, x.reshape(n_pix, -1))
        return torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], 0.0)

    out = dict(
        time=sl["time0"], signal=sl["data0"][px, py],
        frequencies=sl["freq"], signal_fft=(sl["amp_raw"] * sl["w_fd"])[px, py],
        phase_fft=sl["phases"][px, py],
        filtered_time=sl["time"], filtered_frequencies=sl["freq"],
        filtered_signal=final[px, py], filtered_signal_fft=amp_w[px, py],
        filtered_phase_fft=sl["phases"][px, py],
        avg_signal=final.reshape(n_pix, nf).sum(0) / n_pix,
        avg_signal_fft=amp_w.reshape(n_pix, -1).sum(0) / n_pix,
        avg_phase_fft=sl["phases"].reshape(n_pix, -1).sum(0) / n_pix,
        roi_trace=roi_mean(final), roi_amp=roi_mean(amp_w), roi_ph=roi_mean(sl["phases"]),
        image=(final * final).sum(-1),
    )
    n, alpha, kappa = optical(out["filtered_signal_fft"], out["filtered_phase_fft"],
                              out["roi_amp"][cfg["reference_roi"]],
                              out["roi_ph"][cfg["reference_roi"]], sl["freq"],
                              cfg.get("sample_thickness_m", 1.0))
    out.update(refractive_index=n, absorption_coefficient=alpha, extinction_coefficient=kappa)
    return {k: (v.double().cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.float64))
            for k, v in out.items()}


def optical(samp_amp, samp_ph, ref_amp, ref_ph, freq, thickness):
    """n, alpha, kappa (``math_tools.rs:665-701``): amplitudes clamped at
    1e-12, n at 1e-6; the DC bin divides by zero."""
    f_hz = torch.as_tensor(np.asarray(freq) * 1.0e12, dtype=samp_amp.dtype,
                           device=samp_amp.device)
    omega = 2.0 * math.pi * f_hz
    n = 1.0 + C_M_PER_S * (samp_ph - ref_ph) / (omega * thickness)
    n_safe = n.clamp(min=1e-6)
    ratio = samp_amp.clamp(min=1e-12) / ref_amp.clamp(min=1e-12)
    alpha = -2.0 / thickness * torch.log((n_safe + 1.0) ** 2 / (4.0 * n_safe) * ratio)
    kappa = alpha * C_M_PER_S / (4.0 * math.pi * f_hz)
    return n, alpha, kappa
