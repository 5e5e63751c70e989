"""The arithmetic the plain reference computes in.

``Numerics(tf32=False)`` is the reference proper: float64 throughout, every
Fourier transform a DFT written as a matrix product. ``Numerics(tf32=True)``
is the control: the same code in float32 with the operands of every matrix
product rounded to TF32 (10 mantissa bits, round to nearest with ties away
from zero, as the tensor cores' ``cvt.rna.tf32.f32``) and the products
accumulated in float32. The configurations state float32 with TF32 off, so
TF32 is the nearest precision below theirs, and a DFT on the tensor cores is
the step that would tempt a later change. The rounding is done in software,
so the control reads the same on the CPU and on the card.
"""

from __future__ import annotations

import math

import torch

#: int32 mask clearing the 13 mantissa bits that TF32 drops
_TF32_MASK = -(1 << 13)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 precision, kept in float32."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + (1 << 12), _TF32_MASK).view(torch.float32)


class Numerics:
    """Precision and device of a reference computation."""

    def __init__(self, device, tf32: bool = False):
        self.device = torch.device(device)
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        self._dft: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in this precision (operands cast, and TF32-rounded for
        the control)."""
        a, b = a.to(self.dtype), b.to(self.dtype)
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b

    def dft(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(n, n // 2 + 1) cosine and sine tables ``cos(2 pi t k / n)``, the
        argument reduced exactly as the integer ``t k mod n``."""
        tabs = self._dft.get(n)
        if tabs is None:
            t = torch.arange(n, dtype=torch.int64)
            k = torch.arange(n // 2 + 1, dtype=torch.int64)
            m = t[:, None] * k[None, :] % n
            ang = m.to(torch.float64) * (2.0 * math.pi / n)
            # the zeros of sine and cosine exact, as a real input's DC and
            # Nyquist bins have no imaginary part
            cos = torch.where((4 * m == n) | (4 * m == 3 * n), 0.0, torch.cos(ang))
            sin = torch.where((m == 0) | (2 * m == n), 0.0, torch.sin(ang))
            tabs = (self.tensor(cos), self.tensor(sin))
            self._dft[n] = tabs
        return tabs

    def rfft(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(real, imag) of the unnormalized real DFT along the last axis."""
        n = x.shape[-1]
        c, s = self.dft(n)
        flat = x.reshape(-1, n)
        re = self.mm(flat, c).reshape(*x.shape[:-1], -1)
        # 0 - x, not -x: an exact zero stays +0, as in an FFT's output, so
        # the angle of a negative real bin is +pi
        im = (0.0 - self.mm(flat, s)).reshape(*x.shape[:-1], -1)
        return re, im

    def irfft(self, re: torch.Tensor, im: torch.Tensor, n: int) -> torch.Tensor:
        """The inverse real DFT of length ``n`` with 1/n, ignoring the
        imaginary parts of the DC and (even ``n``) Nyquist bins."""
        c, s = self.dft(n)
        f = n // 2 + 1
        w = torch.full((f,), 2.0, dtype=self.dtype, device=self.device)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        rf = (re * w).reshape(-1, f)
        imf = (im * w).reshape(-1, f)
        out = (self.mm(rf, c.T) - self.mm(imf, s.T)) / n
        return out.reshape(*re.shape[:-1], n)
