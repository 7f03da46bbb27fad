"""Sphere-grid transform matrices for the S2 activations (numpy constants;
counterpart of ``singa_tpu/equivariant/grid.py``).

Gauss-Legendre latitude and uniform longitude quadrature over our own real
spherical harmonics, 'component' normalisation, and the m-truncation rescale
sqrt((2l+1)/(2mmax+1)) for l > mmax on both directions (reference
EF_layers.py:571-597).
"""
from __future__ import annotations

import functools

import numpy as np

from singa_tpu_torch.equivariant.sh import real_sph_harm


@functools.lru_cache(maxsize=None)
def _grid_mats(lmax: int, mmax: int) -> tuple[np.ndarray, np.ndarray]:
    """(to_grid, from_grid), each float32 ``[lat, long, n_trunc]``."""
    lat = 2 * (lmax + 1)
    long = 2 * (mmax + 1) + 1 if lmax == mmax else 2 * mmax + 1

    ct, w_lat = np.polynomial.legendre.leggauss(lat)
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    phi = 2.0 * np.pi * np.arange(long) / long
    w_long = 2.0 * np.pi / long

    x = st[:, None] * np.cos(phi)[None, :]
    y = st[:, None] * np.sin(phi)[None, :]
    z = np.broadcast_to(ct[:, None], x.shape)
    pts = np.stack([x, y, z], axis=-1)

    Y = real_sph_harm(lmax, pts)  # orthonormal; [lat, long, (lmax+1)^2]
    Y_comp = Y * np.sqrt(4.0 * np.pi)  # 'component' normalisation

    keep = []
    scale = []
    for l in range(lmax + 1):
        mm = min(l, mmax)
        for m in range(-mm, mm + 1):
            keep.append(l * l + (m + l))
            scale.append(
                np.sqrt((2 * l + 1) / (2 * mmax + 1)) if l > mmax else 1.0
            )
    keep = np.asarray(keep)
    scale = np.asarray(scale)

    to_grid = Y_comp[:, :, keep] * scale  # [lat, long, n_trunc]
    w = (w_lat[:, None] * w_long) / (4.0 * np.pi)
    from_grid = Y_comp[:, :, keep] * w[:, :, None] * scale

    return to_grid.astype(np.float32), from_grid.astype(np.float32)
