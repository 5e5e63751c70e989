"""Intensity image: ``img[x, y] = sum_t data[x, y, t]^2``.

Port of ``thz_image_explorer_tpu/ops/intensity.py`` (reference
``data_thread.rs:1244-1308``).
"""

from __future__ import annotations

import torch


def intensity_image(data: torch.Tensor) -> torch.Tensor:
    """Sum of squares along the time axis, each row summed from a 16-byte
    aligned start. A CUDA reduction sums a row in an order that depends on
    the row's 16-byte alignment, and contiguous rows of a length that is
    not a multiple of 4 floats lie at several alignments (four at an odd
    length, two at a length of 2 mod 4), in a rank's block at others than
    in the whole cube (``scripts/torch_fft_batch_probe.py``, ``sumsq``
    against ``sumsq_aligned``: NVIDIA H100, CUDA 12.8, lengths 745, 1023
    and 1606). So at such a length the squares are written at a row stride
    rounded up to 4 floats and summed from there; at a multiple of 4 every
    contiguous row is aligned and the contiguous squares are summed."""
    t = data.shape[-1]
    if t % 4 == 0:
        return torch.sum(data * data, dim=-1)
    squares = data.new_empty((*data.shape[:-1], -(-t // 4) * 4))[..., :t]
    torch.mul(data, data, out=squares)
    return torch.sum(squares, dim=-1)


def upscaled_intensity_image(data: torch.Tensor, scale: int) -> torch.Tensor:
    """Intensity image with each downscaled pixel replicated over its
    ``scale x scale`` block (``data_thread.rs:1244-1285``)."""
    return upscale_image(intensity_image(data), scale)


def upscale_image(img: torch.Tensor, scale: int) -> torch.Tensor:
    """Each pixel of an (X, Y) image replicated over a ``scale x scale``
    block."""
    return img.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)
