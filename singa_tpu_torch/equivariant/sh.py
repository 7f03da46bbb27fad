"""Real spherical harmonics (numpy, float64): a copy of
``singa_tpu/equivariant/sh.py`` for the port's constant generation.

Basis: standard real spherical harmonics, z-up, no Condon-Shortley phase;
block ``l`` is ordered ``m = -l..l`` (index ``l^2 + (m + l)``), orthonormal on
the sphere.
"""
from __future__ import annotations

import numpy as np


def num_coeffs(lmax: int) -> int:
    return (lmax + 1) ** 2


def real_sph_harm(lmax: int, xyz: np.ndarray) -> np.ndarray:
    """Evaluate all real SH up to ``lmax`` at unit vectors ``xyz [..., 3]``.

    Returns ``[..., (lmax+1)^2]`` float64. Input need not be normalised.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    shape = xyz.shape[:-1]
    v = xyz.reshape(-1, 3)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.where(norm > 0, norm, 1.0)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]

    ct = z  # cos(theta)
    st = np.sqrt(np.maximum(1.0 - z * z, 0.0))  # sin(theta) >= 0
    phi = np.arctan2(y, x)

    n = v.shape[0]
    # P[l][m] = fully-normalised associated Legendre (no Condon-Shortley)
    P = np.zeros((lmax + 1, lmax + 1, n))
    P[0, 0] = np.sqrt(1.0 / (4.0 * np.pi))
    for m in range(1, lmax + 1):
        P[m, m] = np.sqrt((2 * m + 1) / (2.0 * m)) * st * P[m - 1, m - 1]
    for m in range(0, lmax):
        P[m + 1, m] = np.sqrt(2 * m + 3.0) * ct * P[m, m]
    for m in range(0, lmax + 1):
        for l in range(m + 2, lmax + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[l, m] = a * (ct * P[l - 1, m] - b * P[l - 2, m])

    out = np.zeros((n, num_coeffs(lmax)))
    sqrt2 = np.sqrt(2.0)
    for l in range(lmax + 1):
        base = l * l + l  # index of m = 0
        out[:, base] = P[l, 0]
        for m in range(1, l + 1):
            cm = np.cos(m * phi)
            sm = np.sin(m * phi)
            out[:, base + m] = sqrt2 * P[l, m] * cm
            out[:, base - m] = sqrt2 * P[l, m] * sm
    return out.reshape(*shape, num_coeffs(lmax))
