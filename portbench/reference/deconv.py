"""The Apply: frequency-resolved Richardson-Lucy deconvolution, plainly.

For each band of a Kaiser FIR bank: filter every trace (the centre window of
the linear convolution with the band's taps), take each pixel's energy in
the band, deconvolve that energy image with the band's Gaussian PSF by
Richardson-Lucy on its reflect-padded canvas, and weight the band's filtered
traces by ``sqrt(max(u, 0) / energy)``; the result is the sum over the bands
(``deconvolution.rs``, IEEE TTHZ.2025.3546756; the scipy oracle
``tests/oracle_deconv.py``).

The plan (filter bank, per-band PSF profiles, pads and iteration counts) is
worked out here again from the configuration's PSF parameters. Its integer
decisions must be the program's, so it is a frozen copy of the host
planning (``ops/firdesign.py``, ``models/psf.py``, ``ops/deconvolution.
plan_bands``: the reference application's f32 and f64 arithmetic). The
computation is not: the FIR filter is a Toeplitz matrix product over every
trace, each band's energy a sum of squares of its own filtered traces, the
Richardson-Lucy correlations banded matrix products (zero boundary), and the
band sum adds the weighted filtered traces, with no energy identity, no
gathers and no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.numerics import Numerics

NTAPS = 499
MIN_IMAGE_SIZE = 16
DIRECT_CONV_MAX_ELEMS = 256
RL_EPS = 1e-12


# ------------------------------------------------- the filter bank (copy)
def _kaiser_atten(ntaps, width_ratio):
    return max(2.285 * (ntaps - 1) * np.pi * width_ratio + 7.95, 0.0)


def _kaiser_beta(atten):
    if atten > 50.0:
        return 0.1102 * (atten - 8.7)
    if atten >= 21.0:
        return 0.5842 * (atten - 21.0) ** 0.4 + 0.07886 * (atten - 21.0)
    return 0.0


def _bessel_i0(x):
    x = np.asarray(x, np.float64)
    x_half_sq = (x / 2.0) ** 2
    total = np.ones_like(x)
    term = np.ones_like(x)
    for k in range(1, 50):
        term = term * x_half_sq / (k * k)
        total = total + term
    return total


def _sinc(x):
    out = np.ones_like(x)
    nz = np.abs(x) >= 1e-10
    out[nz] = np.sin(x[nz]) / x[nz]
    return out


def _kaiser_window(n_taps, beta):
    n = np.arange(n_taps, dtype=np.float64)
    arg = 2.0 * n / (n_taps - 1.0) - 1.0
    w = _bessel_i0(beta * np.sqrt(np.maximum(1.0 - arg * arg, 0.0))) / _bessel_i0(
        np.float64(beta))
    w[0] = 0.0
    w[-1] = 0.0
    return w


def _lowpass(n_taps, cutoff_hz, beta, fs):
    adjusted = n_taps - 1 if n_taps % 2 == 0 else n_taps
    mid = (adjusted - 1) / 2.0
    n = np.arange(adjusted, dtype=np.float64)
    taps = _sinc(2.0 * np.pi * (cutoff_hz / fs) * (n - mid)) * _kaiser_window(adjusted, beta)
    s = taps.sum()
    if abs(s) > 1e-10:
        taps = taps / s
    if n_taps % 2 == 0:
        taps = np.append(taps, 0.0)
    return taps


def _highpass(n_taps, cutoff_hz, beta, fs):
    adjusted = n_taps - 1 if n_taps % 2 == 0 else n_taps
    taps = -_lowpass(adjusted, cutoff_hz, beta, fs)
    taps[int((adjusted - 1) / 2.0)] += 1.0
    if n_taps % 2 == 0:
        taps = np.append(taps, 0.0)
    return taps


def _bandpass(ntaps, lowcut, highcut, fs, width):
    beta = _kaiser_beta(_kaiser_atten(ntaps, width / (0.5 * fs)))
    if lowcut <= 0.0:
        return _lowpass(ntaps, highcut, beta, fs)
    if highcut >= 0.5 * fs:
        return _highpass(ntaps, lowcut, beta, fs)
    return _highpass(ntaps, lowcut, beta, fs) - _highpass(ntaps, highcut, beta, fs)


def filter_bank(n_filters, start_freq, end_freq, win_width, time):
    """(B, NTAPS) f64 taps and the (B,) log-spaced centre frequencies; band
    edges at the geometric means of neighbouring centres."""
    time = np.asarray(time, np.float64)
    fs = 1.0 / (time[1] - time[0])
    centers = np.exp(np.linspace(np.log(start_freq), np.log(end_freq), n_filters))
    bank = np.zeros((n_filters, NTAPS))
    for i, fc in enumerate(centers):
        lo = 0.0 if i == 0 else float(np.sqrt(centers[i - 1] * fc))
        hi = 0.5 * fs if i == n_filters - 1 else float(np.sqrt(fc * centers[i + 1]))
        bank[i] = _bandpass(NTAPS, lo, hi, fs, win_width)
    return bank, centers


# ------------------------------------------------------ PSF profiles (copy)
def gaussian(x, x0, w):
    x = np.asarray(x, np.float32)
    return (np.sqrt(2.0 / np.pi) * np.exp(-2.0 * (x - x0) ** 2 / (w * w)) / w).astype(np.float32)


def psf_axes(psf_x, psf_y, x, y, dx, dy):
    """The two axis profiles whose outer product is the 2-D PSF, on the
    reference application's grid (``filters/psf.rs:228-313``)."""
    psf_x = np.asarray(psf_x, np.float64) / np.max(psf_x)
    psf_y = np.asarray(psf_y, np.float64) / np.max(psf_y)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x_max, y_max = int(np.floor(x.max())), int(np.floor(y.max()))

    def extend(axis, prof, new_max):
        step = axis[-1] - axis[-2]
        n_new = int(np.ceil((new_max - axis[-1]) / step))
        if n_new <= 0:
            return axis, prof
        axis = np.concatenate([axis[0] - step * np.arange(n_new, 0, -1), axis,
                               axis[-1] + step * np.arange(1, n_new + 1)])
        return axis, np.concatenate([np.zeros(n_new), prof, np.zeros(n_new)])

    x, psf_x = extend(x, psf_x, np.ceil(2.0 * x_max))
    y, psf_y = extend(y, psf_y, np.ceil(2.0 * y_max))
    xx = np.arange(-x_max, x_max + 1, dtype=np.float64) * dx
    yy = np.arange(-y_max, y_max + 1, dtype=np.float64) * dy
    return (np.interp(xx, x, psf_x).astype(np.float32),
            np.interp(yy, y, psf_y).astype(np.float32))


def _width(a_b, f32_freqs):
    """``a / f + b`` mm in f32, at least 1e-6 (the configuration's PSF has
    no spline correction)."""
    a, b = a_b
    return np.maximum(a / f32_freqs + b, 1e-6)


@dataclasses.dataclass
class Plan:
    taps: np.ndarray  # (B, NTAPS) f64
    px: list  # per band, its own axis-0 profile (f32)
    py: list
    n_iter: np.ndarray  # (B,)
    use_fft_conv: np.ndarray  # (B,) bool


def plan(cfg: dict, time: np.ndarray, shape) -> Plan | None:
    """The band plan for a (X, Y) grid (``deconvolution.rs:780-971``); None
    where the reference application skips the deconvolution."""
    d, p, s = cfg["deconvolution"], cfg["psf"], cfg["scan"]
    rows, cols = shape
    dx, dy = float(s["dx_mm"]), float(s["dy_mm"])
    if rows < MIN_IMAGE_SIZE or cols < MIN_IMAGE_SIZE:
        return None
    taps, centers = filter_bank(d["n_filters"], d["start_freq"], d["end_freq"],
                                d["win_width"], time)
    c32 = centers.astype(np.float32)
    wx, wy = _width(p["wx_a_b"], c32), _width(p["wy_a_b"], c32)
    w_min, w_max = float(min(wx.min(), wy.min())), float(max(wx.max(), wy.max()))
    if (max(int(np.ceil(wx.max() / dx)) * 2 + 1, 3) >= cols
            or max(int(np.ceil(wy.max() / dy)) * 2 + 1, 3) >= rows):
        return None
    x0 = np.full_like(c32, np.float32(p["x0_mm"]))
    y0 = np.full_like(c32, np.float32(p["y0_mm"]))
    px, py = [], []
    n_iter = np.zeros(len(centers), np.int64)
    for i in range(len(c32)):
        range_x = max((wx[i] + abs(x0[i])) * 3.0, 2.5)
        range_y = max((wy[i] + abs(y0[i])) * 3.0, 2.5)
        range_x = np.float32(np.floor(range_x / dx) * dx + dx)
        range_y = np.float32(np.floor(range_y / dy) * dy + dy)
        nx = int(np.floor(min(float(range_x), (cols - 2.0) * dx / 2.0) / dx))
        ny = int(np.floor(min(float(range_y), (rows - 2.0) * dy / 2.0) / dy))
        x = np.arange(-nx, nx + 1, dtype=np.float32) * np.float32(dx)
        y = np.arange(-ny, ny + 1, dtype=np.float32) * np.float32(dy)
        ax, ay = psf_axes(gaussian(x, float(x0[i]), float(wx[i])),
                          gaussian(y, float(y0[i]), float(wy[i])), x, y, dx, dy)
        px.append(ax)
        py.append(ay)
        if w_max != w_min:
            n_iter[i] = int(np.floor((wx[i] - w_min) / (w_max - w_min)
                                     * (d["n_iterations"] - 1.0) + 1.0))
    kr = np.array([len(a) for a in px])
    kc = np.array([len(a) for a in py])
    if int(kr.max()) // 2 >= rows or int(kc.max()) // 2 >= cols:
        return None
    return Plan(taps=taps, px=px, py=py, n_iter=n_iter,
                use_fft_conv=kr * kc > DIRECT_CONV_MAX_ELEMS)


# ------------------------------------------------------------ computation
def fir_matrix(taps: np.ndarray, n_time: int) -> np.ndarray:
    """(T, T) ``M`` with ``(x @ M)[t] = sum_k taps[k] x[t + shift - k]``:
    the centre window of the linear convolution, ``shift = (L - 1) // 2``."""
    shift = (len(taps) - 1) // 2
    src = np.arange(n_time)[:, None]
    dst = np.arange(n_time)[None, :]
    k = dst + shift - src
    return np.where((k >= 0) & (k < len(taps)), taps[np.clip(k, 0, len(taps) - 1)], 0.0)


def banded(prof: np.ndarray, size: int) -> np.ndarray:
    """(size, size) ``R`` with ``(R @ a)[i] = sum_j prof[j] a[i + j - k//2]``,
    zero outside the axis: a 'same' correlation with zero boundary."""
    k = len(prof)
    i = np.arange(size)[:, None]
    j = np.arange(size)[None, :]
    idx = j - i + k // 2
    return np.where((idx >= 0) & (idx < k), prof[np.clip(idx, 0, k - 1)], 0.0)


def richardson_lucy(img: torch.Tensor, px, py, n_iter: int, fft_semantics: bool,
                    num: Numerics) -> torch.Tensor:
    """RL of the (X, Y) ``img`` with the PSF ``outer(px, py)`` on its
    reflect-padded canvas: ``u <- u * corr(p / (conv(u) + eps), mirror)``;
    a band the reference application FFT-convolves takes the flipped PSF
    (a convolution), the others the PSF as a correlation."""
    pad_r, pad_c = len(px) // 2, len(py) // 2
    rows = np.abs(np.arange(img.shape[0] + 2 * pad_r) - pad_r)
    rows = np.where(rows >= img.shape[0], 2 * img.shape[0] - 2 - rows, rows)
    cols = np.abs(np.arange(img.shape[1] + 2 * pad_c) - pad_c)
    cols = np.where(cols >= img.shape[1], 2 * img.shape[1] - 2 - cols, cols)
    dev = img.device
    padded = img[torch.as_tensor(rows, device=dev)][:, torch.as_tensor(cols, device=dev)]
    prx, pry = (px[::-1], py[::-1]) if fft_semantics else (px, py)
    r = num.tensor(banded(np.asarray(prx, np.float64), padded.shape[0]))
    c = num.tensor(banded(np.asarray(pry, np.float64), padded.shape[1]))
    u = padded.clone()
    for _ in range(int(n_iter)):
        rel = padded / (num.mm(num.mm(r, u), c.T) + RL_EPS)
        u = u * num.mm(num.mm(r.T, rel), c)
    return u[pad_r: pad_r + img.shape[0], pad_c: pad_c + img.shape[1]]


def deconvolve(data: torch.Tensor, time: np.ndarray, cfg: dict, num: Numerics,
               rows_per_block: int = 16384) -> torch.Tensor:
    """The band-summed cube of the (X, Y, T) ``data``; ``data`` itself where
    the plan skips the deconvolution."""
    x_n, y_n, n_time = data.shape
    pl = plan(cfg, time, (x_n, y_n))
    if pl is None:
        return data
    flat = data.reshape(-1, n_time)
    mats = [num.tensor(fir_matrix(t, n_time)) for t in pl.taps]
    energy = torch.stack([
        torch.cat([num.mm(flat[i: i + rows_per_block], m).square().sum(-1)
                   for i in range(0, flat.shape[0], rows_per_block)])
        for m in mats]).reshape(-1, x_n, y_n)
    gains = []
    for b, img in enumerate(energy):
        u = richardson_lucy(img, pl.px[b], pl.py[b], pl.n_iter[b], bool(pl.use_fft_conv[b]), num)
        gains.append(torch.sqrt(u.clamp(min=0.0) / img).reshape(-1))
    out = torch.zeros_like(flat)
    for i in range(0, flat.shape[0], rows_per_block):
        blk = flat[i: i + rows_per_block]
        for m, g in zip(mats, gains):
            out[i: i + rows_per_block] += num.mm(blk, m) * g[i: i + rows_per_block, None]
    return out.reshape(x_n, y_n, n_time)
