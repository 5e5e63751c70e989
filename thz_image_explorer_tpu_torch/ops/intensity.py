"""Intensity image: ``img[x, y] = sum_t data[x, y, t]^2``.

Port of ``thz_image_explorer_tpu/ops/intensity.py`` (reference
``data_thread.rs:1244-1308``).
"""

from __future__ import annotations

import torch


def intensity_image(data: torch.Tensor) -> torch.Tensor:
    """Sum of squares along the time axis."""
    return torch.sum(data * data, dim=-1)


def upscaled_intensity_image(data: torch.Tensor, scale: int) -> torch.Tensor:
    """Intensity image with each downscaled pixel replicated over its
    ``scale x scale`` block (``data_thread.rs:1244-1285``)."""
    img = intensity_image(data)
    return img.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)
