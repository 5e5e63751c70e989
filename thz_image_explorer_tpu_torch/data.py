"""Scan-cube data model: one pipeline stage's dataset as tensors.

Port of ``thz_image_explorer_tpu/data.py``. The cube is a plain dataclass
of tensors on one device; stages return new cubes and share the tensors
they do not change (an inactive stage returns its input object itself).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ScanCube:
    """One pipeline stage's dataset: time- and frequency-domain views.

    Axis convention follows the reference: ``data[x, y, t]``.

    time            (T,)    f32  time axis in ps
    data            (X,Y,T) f32  time-domain traces
    freq            (F,)    f32  frequency axis in THz, F = T//2 + 1
    fft             (X,Y,F) c64  complex spectra (``rfft`` of ``data``)
    amplitudes      (X,Y,F) f32  |fft|
    phases          (X,Y,F) f32  unwrapped angle(fft)
    avg_data        (T,)    f32  mean time trace (only when avg-in-Fourier)
    avg_fft         (F,)    c64  pixel-mean complex spectrum
    avg_signal_fft  (F,)    f32  pixel-mean amplitude
    avg_phase_fft   (F,)    f32  pixel-mean unwrapped phase
    valid_wh        (w, h)       valid pixel region; the port never pads
                                 the grid, so it equals ``(X, Y)`` (a
                                 smaller region is honoured by
                                 :func:`masked_pixel_mean`)

    dx, dy          spatial steps in mm (None when unknown)
    x_min, y_min    scan origin in mm (None when unknown)
    scaling         current spatial downscale factor (1 = native)
    """

    time: torch.Tensor
    data: torch.Tensor
    freq: torch.Tensor
    fft: torch.Tensor
    amplitudes: torch.Tensor
    phases: torch.Tensor
    avg_data: torch.Tensor
    avg_fft: torch.Tensor
    avg_signal_fft: torch.Tensor
    avg_phase_fft: torch.Tensor
    valid_wh: tuple[int, int]
    dx: Optional[float] = None
    dy: Optional[float] = None
    x_min: Optional[float] = None
    y_min: Optional[float] = None
    scaling: int = 1

    @property
    def width(self) -> int:
        return self.data.shape[0]

    @property
    def height(self) -> int:
        return self.data.shape[1]

    @property
    def n_time(self) -> int:
        return self.data.shape[2]

    @property
    def n_freq(self) -> int:
        return self.freq.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def replace(self, **kwargs) -> "ScanCube":
        return dataclasses.replace(self, **kwargs)


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device gets its index made
    explicit, and CUDA without a card raises: nothing falls back to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def frequency_axis(time: torch.Tensor) -> torch.Tensor:
    """``freq[i] = i / (time[-1] - time[0])`` for ``i in 0..T//2+1``
    (``io.rs:614-621``): bins of ``1/range`` THz, NOT ``i/(T*dt)``."""
    n = time.shape[0]
    rng = time[-1] - time[0]
    return torch.arange(n // 2 + 1, dtype=torch.float32, device=time.device) / rng


def masked_pixel_mean(x: torch.Tensor, valid_wh) -> torch.Tensor:
    """Mean over the pixel axes (0, 1) with the valid-region count as the
    denominator (pixels outside the valid region are zero by
    construction, so the plain sum is the valid-region sum)."""
    count = max(int(valid_wh[0]) * int(valid_wh[1]), 1)
    return torch.sum(x, dim=(0, 1)) / count


def make_cube(
    time,
    data,
    dx: Optional[float] = None,
    dy: Optional[float] = None,
    x_min: Optional[float] = None,
    y_min: Optional[float] = None,
    scaling: int = 1,
    valid_wh: Optional[tuple[int, int]] = None,
    device="cuda",
) -> ScanCube:
    """Build a ScanCube from a time axis and a raw (X, Y, T) array, with
    zero-filled spectral fields at the load-time frequency resolution
    (``io.rs:626-628``)."""
    time = torch.as_tensor(time, dtype=torch.float32, device=device)
    data = torch.as_tensor(data, dtype=torch.float32, device=device)
    if data.ndim != 3:
        raise ValueError(f"data must be (X, Y, T), got shape {tuple(data.shape)}")
    freq = frequency_axis(time)
    x, y, nf = data.shape[0], data.shape[1], freq.shape[0]
    if valid_wh is None:
        valid_wh = (x, y)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return ScanCube(
        time=time,
        data=data,
        freq=freq,
        fft=zeros((x, y, nf), torch.complex64),
        amplitudes=zeros((x, y, nf), torch.float32),
        phases=zeros((x, y, nf), torch.float32),
        avg_data=zeros((time.shape[0],), torch.float32),
        avg_fft=zeros((nf,), torch.complex64),
        avg_signal_fft=zeros((nf,), torch.float32),
        avg_phase_fft=zeros((nf,), torch.float32),
        valid_wh=(int(valid_wh[0]), int(valid_wh[1])),
        dx=dx,
        dy=dy,
        x_min=x_min,
        y_min=y_min,
        scaling=scaling,
    )


def load_preprocess(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel DC-offset subtraction using sample 0, plus the intensity
    image (``io.rs:576-595``). Returns a new tensor; ``data`` is left as
    it is."""
    data = data - data[:, :, :1]
    return data, torch.sum(data * data, dim=-1)
