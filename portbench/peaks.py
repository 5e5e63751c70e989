"""Published peaks of the card and the work of the port's kernels.

A roofline share is the least time the card could take for a call, the
larger of its bytes over the memory rate and its operations over the f32
peak, divided by the call's measured device time. The bytes and operations
come from the problem's shapes and the plan, whatever kernel runs them.
"""

from __future__ import annotations

import numpy as np

#: (name fragment, memory bytes/s, f32 FLOP/s outside the tensor cores) of
#: the card the cells run on: NVIDIA's data sheet, H100 SXM (HBM3)
PEAKS = (("H100 80GB HBM3", 3.35e12, 67e12),)


def peaks(device_name: str) -> tuple[float, float]:
    """(bytes/s, FLOP/s) of the card named ``device_name``."""
    for key, rate, flops in PEAKS:
        if key in device_name:
            return rate, flops
    raise KeyError(f"no published peaks known for {device_name!r}")


def specred_bound_s(n: int, f: int, m: int, device_name: str) -> float:
    """The one-pass spectral reduction of an (N, F) complex64 spectrum over
    M masks: the spectrum and the masks read once, the amplitude and
    increment sums written once; per element 4 operations for the
    amplitude, 2 for the angle and its wrapped step, 2 outputs x M masks x
    one FMA."""
    rate, flops = peaks(device_name)
    n_bytes = n * f * 8 + m * n * 4 + 2 * m * f * 4
    n_ops = n * f * (4 + 2 + 2 * 2 * m)
    return max(n_bytes / rate, n_ops / flops)


def rl_bound_s(plan, shape, device_name: str) -> float:
    """Every band's Richardson-Lucy iterations of an Apply: per band and
    iteration, on the band's padded region (X + 2 pad_r) x (Y + 2 pad_c), a
    kr-tap and a kc-tap correlation each way (2 operations a tap) plus the
    guard add, the division and the multiply; the canvases read and the
    estimates written once."""
    rate, flops = peaks(device_name)
    kr = np.array([len(p) for p in plan.px], np.int64)
    kc = np.array([len(p) for p in plan.py], np.int64)
    area = (shape[0] + kr - 1) * (shape[1] + kc - 1)
    n_ops = int((np.asarray(plan.n_iter, np.int64) * area * (4 * kr + 4 * kc + 3)).sum())
    h2, w2 = shape[0] + int(kr.max()) - 1, shape[1] + int(kc.max()) - 1
    n_bytes = 2 * len(kr) * h2 * w2 * 4 + int(kr.sum() + kc.sum()) * 4
    return max(n_bytes / rate, n_ops / flops)
