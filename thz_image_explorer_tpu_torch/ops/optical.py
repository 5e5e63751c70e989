"""Optical-property extraction (refractive index, absorption, extinction).

Port of ``thz_image_explorer_tpu/ops/optical.py`` (reference
``calculate_optical_properties``, ``math_tools.rs:665-701``; formulas in
the reference's JOSS paper, ``paper/paper.md:81-95``):

    n(f)     = 1 + c * dphi / (omega * d)
    alpha(f) = -(2/d) * ln( ((n+1)^2 / (4 n)) * A_s / A_ref )
    kappa(f) = alpha * c / (4 pi f)

with the reference's clamps: amplitudes >= 1e-12, n >= 1e-6.
"""

from __future__ import annotations

import math

import torch

C = 2.99792458e8  # speed of light, m/s (math_tools.rs:663)


def calculate_optical_properties(
    sample_amplitude: torch.Tensor,
    sample_phase: torch.Tensor,
    reference_amplitude: torch.Tensor,
    reference_phase: torch.Tensor,
    frequencies: torch.Tensor,
    sample_thickness: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-frequency-bin n, alpha, kappa; ``frequencies`` in THz,
    ``sample_thickness`` in metres."""
    frequency_hz = frequencies * 1.0e12
    delta_phi = sample_phase - reference_phase
    omega = 2.0 * math.pi * frequency_hz
    n = 1.0 + C * delta_phi / (omega * sample_thickness)

    amp = torch.clamp(sample_amplitude, min=1e-12)
    amp_ref = torch.clamp(reference_amplitude, min=1e-12)
    n_safe = torch.clamp(n, min=1e-6)

    alpha = (
        -2.0
        / sample_thickness
        * torch.log((n_safe + 1.0) ** 2 / (4.0 * n_safe) * amp / amp_ref)
    )
    kappa = alpha * C / (4.0 * math.pi * frequency_hz)
    return n, alpha, kappa
