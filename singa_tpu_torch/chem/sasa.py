"""Solvent-accessible surface area (Shrake-Rupley) and polarity classes
(counterpart of ``singa_tpu/chem/sasa.py``).

Replaces the FreeSASA dependency of the reference
(utils/PLFeature.py:194-198) with a vectorised numpy
Shrake-Rupley implementation, and ``classify_atoms`` reproduces the
polar/apolar + vdW-radius assignment (PLFeature.py:166-191, driven by
config/symbol_radius.json — radii now live in chem/periodic.py).
"""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.chem.periodic import vdw_radius

POLAR_ELEMENTS = {7, 8, 15, 16}  # N, O, P, S


def fibonacci_sphere(n: int) -> np.ndarray:
    """Quasi-uniform unit-sphere points (golden-angle spiral)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
    )


def shrake_rupley(
    pos: np.ndarray,
    radii: np.ndarray,
    probe_radius: float = 1.4,
    n_points: int = 100,
) -> np.ndarray:
    """Per-atom SASA in A^2."""
    pos = np.asarray(pos, np.float64)
    radii = np.asarray(radii, np.float64) + probe_radius
    n = len(pos)
    sphere = fibonacci_sphere(n_points)
    out = np.zeros(n)
    # neighbour prefilter
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    max_r = radii.max()
    for a in range(n):
        neigh = np.nonzero((d2[a] < (radii[a] + max_r) ** 2) & (np.arange(n) != a))[0]
        pts = pos[a] + sphere * radii[a]
        if len(neigh):
            dd = ((pts[:, None, :] - pos[neigh][None]) ** 2).sum(-1)
            buried = (dd < (radii[neigh] ** 2)[None, :]).any(axis=1)
        else:
            buried = np.zeros(n_points, bool)
        frac = 1.0 - buried.mean()
        out[a] = frac * 4.0 * np.pi * radii[a] ** 2
    return out


def classify_atoms(atomic_num: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(polar_mask, vdw_radii) per atom (reference ClassifyAtoms)."""
    z = np.asarray(atomic_num)
    polar = np.isin(z, list(POLAR_ELEMENTS))
    radii = np.array([vdw_radius(int(x)) for x in z])
    return polar, radii


def total_sasa(pos: np.ndarray, atomic_num: np.ndarray, **kw) -> float:
    _, radii = classify_atoms(atomic_num)
    return float(shrake_rupley(pos, radii, **kw).sum())
