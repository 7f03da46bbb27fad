"""Radial basis expansion of distances (counterpart of
``singa_tpu/ops/smearing.py``; reference EF_layers.py:1777-1794)."""
from __future__ import annotations

import torch


def gaussian_smearing(
    dist: torch.Tensor,
    start: float = 0.0,
    stop: float = 10.0,
    num_gaussians: int = 50,
    basis_width_scalar: float = 1.0,
) -> torch.Tensor:
    """Expand distances ``[...]`` into Gaussian RBFs ``[..., num_gaussians]``."""
    offset = torch.linspace(start, stop, num_gaussians, dtype=dist.dtype, device=dist.device)
    width = basis_width_scalar * (stop - start) / (num_gaussians - 1)
    coeff = -0.5 / (width * width)
    diff = dist[..., None] - offset
    return torch.exp(coeff * diff * diff)
