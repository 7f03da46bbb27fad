"""SMILES -> 3D: lightweight distance-geometry conformer embedding
(counterpart of ``singa_tpu/chem/embed3d.py``; numpy on the same
``default_rng`` draws, so the coordinates are the JAX package's).

The reference gets 3D ligand coordinates from CrossDocked SDF files
(utils/PLParser.py:378) and never generates conformers; this
module closes the gap where there is no structure corpus: it turns a
topological `Molecule` (e.g. from chem.smiles_parser.parse_smiles) into
plausible 3D coordinates so the native docking engine (dock/) and the
ETL (tools/make_dataset.py) can run on synthesized complexes.

Method (ETKDG-lite, pure NumPy):
  1. target distances: bonds from covalent radii x bond-order factor;
     1-3 distances from ideal hybridization angles (law of cosines);
     rings as regular polygons (exact for aromatic/planar rings, a fair
     approximation for small saturated rings).
  2. init: metric-matrix embedding of a smoothed distance guess
     (classic Crippen/Havel DG: Gram matrix from centered squared
     distances, top-3 eigenvectors).
  3. refine: gradient descent with momentum on a pairwise pseudo-energy —
     harmonic terms on all target distances + one-sided repulsion between
     topologically distant pairs — with several random restarts.

Accuracy bar: bond lengths within a few percent, no nonbonded clashes,
planar aromatics. Not a conformational-search tool; the docking engine's
torsion-space Monte-Carlo does pose refinement downstream.
"""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.chem.mol import Molecule, within_bonds
from singa_tpu_torch.chem.periodic import covalent_radius

# bond length contraction vs single bond (empirical, Pauling-style)
_ORDER_FACTOR = {1: 1.0, 2: 0.87, 3: 0.78}
_AROMATIC_FACTOR = 0.92
# ideal angle by hybridization code (mol.hybridization: 1=sp, 2=sp2, 3=sp3)
_ANGLE = {1: np.pi, 2: 2.0 * np.pi / 3.0, 3: np.deg2rad(109.47), 0: np.deg2rad(109.47)}


def _bond_length(mol: Molecule, i: int, j: int, order: int, aromatic: bool) -> float:
    r = covalent_radius(int(mol.atomic_num[i])) + covalent_radius(int(mol.atomic_num[j]))
    f = _AROMATIC_FACTOR if aromatic else _ORDER_FACTOR.get(int(order), 1.0)
    return r * f


def _target_distances(mol: Molecule) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (pairs [K,2], d0 [K], weight [K]) of harmonic distance targets."""
    n = mol.num_atoms
    blen = {}
    for (i, j), o, ar in zip(mol.bonds, mol.bond_order, mol.bond_aromatic):
        i, j = int(i), int(j)
        blen[(min(i, j), max(i, j))] = _bond_length(mol, i, j, o, ar)

    targets: dict[tuple[int, int], tuple[float, float]] = {}

    def add(i, j, d, w):
        key = (min(i, j), max(i, j))
        old = targets.get(key)
        if old is None or w > old[1]:
            targets[key] = (d, w)

    for (i, j), d in blen.items():
        add(i, j, d, 10.0)

    # 1-3 distances from the ideal angle at the center atom
    hyb = mol.hybridization
    adj = [[] for _ in range(n)]
    for (i, j) in mol.bonds:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    for c in range(n):
        nb = adj[c]
        theta = _ANGLE.get(int(hyb[c]), _ANGLE[3])
        for a_i in range(len(nb)):
            for b_i in range(a_i + 1, len(nb)):
                a, b = nb[a_i], nb[b_i]
                da = blen[(min(a, c), max(a, c))]
                db = blen[(min(b, c), max(b, c))]
                d = np.sqrt(da * da + db * db - 2 * da * db * np.cos(theta))
                add(a, b, d, 5.0)

    # rings as regular polygons: all pairwise in-ring distances (forces the
    # planar polygon shape -- exact for aromatics, approximate for sp3 rings)
    arom = mol.aromatic
    for ring in mol.rings:
        m = len(ring)
        if m < 3 or m > 8:
            continue
        is_arom = all(arom[a] for a in ring)
        if not is_arom and m > 6:
            continue
        d_bond = float(
            np.mean(
                [
                    blen.get((min(ring[k], ring[(k + 1) % m]), max(ring[k], ring[(k + 1) % m])), 1.4)
                    for k in range(m)
                ]
            )
        )
        R = d_bond / (2.0 * np.sin(np.pi / m))
        w = 5.0 if is_arom else 1.5
        for a_i in range(m):
            for b_i in range(a_i + 2, m):
                if a_i == 0 and b_i == m - 1:
                    continue  # that's a bond
                sep = min(b_i - a_i, m - (b_i - a_i))
                d = 2.0 * R * np.sin(np.pi * sep / m)
                add(ring[a_i], ring[b_i], d, w)

    pairs = np.array(sorted(targets), np.int64).reshape(-1, 2)
    d0 = np.array([targets[tuple(p)][0] for p in pairs])
    w = np.array([targets[tuple(p)][1] for p in pairs])
    return pairs, d0, w


def _repulsion_pairs(mol: Molecule, targets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pairs >= 3 bonds apart (and without a distance target): one-sided
    repulsion below a soft lower bound."""
    n = mol.num_atoms
    seen = {tuple(p) for p in targets}
    close = {(min(i, j), max(i, j)) for i in range(n) for j in within_bonds(mol, i, 3) if i != j}
    pairs = [
        (i, j)
        for i in range(n)
        for j in range(i + 1, n)
        if (i, j) not in seen and (i, j) not in close
    ]
    if not pairs:
        return np.zeros((0, 2), np.int64), np.zeros(0)
    pairs = np.array(pairs, np.int64)
    rc = np.array([covalent_radius(int(z)) for z in mol.atomic_num])
    dmin = (rc[pairs[:, 0]] + rc[pairs[:, 1]]) + 1.2  # ~ heavy-atom vdW gap
    return pairs, dmin


def _energy_grad(pos, pairs, d0, w, rep_pairs, rep_dmin):
    g = np.zeros_like(pos)
    e = 0.0
    if len(pairs):
        dv = pos[pairs[:, 0]] - pos[pairs[:, 1]]
        d = np.sqrt((dv * dv).sum(-1) + 1e-12)
        diff = d - d0
        e += float((w * diff * diff).sum())
        coef = (2.0 * w * diff / d)[:, None] * dv
        np.add.at(g, pairs[:, 0], coef)
        np.add.at(g, pairs[:, 1], -coef)
    if len(rep_pairs):
        dv = pos[rep_pairs[:, 0]] - pos[rep_pairs[:, 1]]
        d = np.sqrt((dv * dv).sum(-1) + 1e-12)
        viol = np.maximum(rep_dmin - d, 0.0)
        e += float((viol * viol).sum())
        coef = (-2.0 * viol / d)[:, None] * dv
        np.add.at(g, rep_pairs[:, 0], coef)
        np.add.at(g, rep_pairs[:, 1], -coef)
    return e, g


def _dg_init(n, pairs, d0, rng):
    """Metric-matrix embedding of a crude all-pairs distance guess."""
    D = np.full((n, n), 0.0)
    big = float(d0.max() if len(d0) else 1.5) * max(1.0, np.sqrt(n) / 2.0)
    D[:] = big * (0.7 + 0.6 * rng.random((n, n)))
    D = (D + D.T) / 2.0
    D[pairs[:, 0], pairs[:, 1]] = d0
    D[pairs[:, 1], pairs[:, 0]] = d0
    np.fill_diagonal(D, 0.0)
    D2 = D * D
    J = np.eye(n) - np.full((n, n), 1.0 / n)
    G = -0.5 * J @ D2 @ J
    vals, vecs = np.linalg.eigh(G)
    idx = np.argsort(vals)[::-1][:3]
    lam = np.sqrt(np.maximum(vals[idx], 1e-6))
    return vecs[:, idx] * lam[None, :]


def embed_molecule(
    mol: Molecule, seed: int = 0, n_restarts: int = 4, n_iters: int = 600
) -> np.ndarray:
    """Generate 3D coordinates for a topological molecule. Returns [N, 3]."""
    n = mol.num_atoms
    if n == 1:
        return np.zeros((1, 3), np.float32)
    pairs, d0, w = _target_distances(mol)
    rep_pairs, rep_dmin = _repulsion_pairs(mol, pairs)
    rng = np.random.default_rng(seed)

    best = None
    best_e = np.inf
    for r in range(n_restarts):
        pos = _dg_init(n, pairs, d0, rng) + 0.05 * rng.standard_normal((n, 3))
        vel = np.zeros_like(pos)
        lr = 0.02
        for it in range(n_iters):
            e, g = _energy_grad(pos, pairs, d0, w, rep_pairs, rep_dmin)
            gn = np.linalg.norm(g) + 1e-9
            if gn > 50.0:
                g = g * (50.0 / gn)
            vel = 0.85 * vel - lr * g
            pos = pos + vel
            if it == n_iters * 2 // 3:
                lr *= 0.3
        e, _ = _energy_grad(pos, pairs, d0, w, rep_pairs, rep_dmin)
        if e < best_e:
            best_e, best = e, pos
    best = best - best.mean(axis=0)
    return best.astype(np.float32)


def embed_smiles(smi: str, seed: int = 0) -> Molecule:
    """Parse a SMILES and attach embedded 3D coordinates."""
    from singa_tpu_torch.chem.smiles_parser import parse_smiles

    mol = parse_smiles(smi)
    mol.pos = embed_molecule(mol, seed=seed)
    return mol
