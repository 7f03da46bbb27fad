"""Node/edge featurization: Molecule -> the 59-dim feature contract.

Re-implementation of the reference featurizer
(utils/Data.py:26-169): 44-way element one-hot,
7-way hybridisation one-hot, Gasteiger partial charge and 7 pharmacophoric
flags per atom; [length, aromatic, ring, order1/2/3] per bond, bidirectional.

Counterpart of ``singa_tpu/chem/featurize.py``.
"""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.chem.mol import Molecule

# Element classes of the reference one-hot (Data.py:42-51); index 43 = unknown.
USED_ATOM_NUM = [
    3, 4, 5, 6, 7, 8, 9, 11, 12, 13,
    14, 15, 16, 17, 19, 20, 22, 23, 24, 25,
    26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    40, 46, 47, 48, 49, 50, 51, 53, 78, 79,
    80, 81, 82,
]
_ELEMENT_INDEX = {z: i for i, z in enumerate(USED_ATOM_NUM)}

NODE_FEAT_DIM = 44 + 7 + 1 + 7  # = 59


def atom_features(mol: Molecule) -> np.ndarray:
    """[N, 59] float32 feature matrix (Data.py:123-157 layout)."""
    n = mol.num_atoms
    out = np.zeros((n, NODE_FEAT_DIM), dtype=np.float32)
    for a in range(n):
        z = int(mol.atomic_num[a])
        out[a, _ELEMENT_INDEX.get(z, 43)] = 1.0
    hyb = mol.hybridization
    for a in range(n):
        h = int(hyb[a])
        out[a, 44 + (h if h in (1, 2, 3, 4, 5, 6) else 0)] = 1.0
    out[:, 51] = mol.partial_charge
    out[:, 52] = mol.is_hydrophobe
    out[:, 53] = mol.aromatic
    out[:, 54] = mol.is_acceptor
    out[:, 55] = mol.is_donor
    out[:, 56] = mol.is_donor_h
    out[:, 57] = mol.is_minus
    out[:, 58] = mol.is_plus
    return out


def bond_features(mol: Molecule) -> tuple[np.ndarray, np.ndarray]:
    """Bidirectional (edge_index [2, 2M], edge_attr [2M, 6]) —
    [length, aromatic, ring, order==1, order==2, order==3] (Data.py:99-120)."""
    m = len(mol.bonds)
    if m == 0:
        return np.zeros((2, 0), np.int64), np.zeros((0, 6), np.float32)
    ring = mol.bond_in_ring()
    ei = np.zeros((2, 2 * m), dtype=np.int64)
    attr = np.zeros((2 * m, 6), dtype=np.float32)
    for k, ((i, j), o, ar) in enumerate(
        zip(mol.bonds, mol.bond_order, mol.bond_aromatic)
    ):
        length = float(np.linalg.norm(mol.pos[i] - mol.pos[j]))
        feats = [length, float(ar or (ring[k] and mol.aromatic[i] and mol.aromatic[j])), float(ring[k]), float(o == 1), float(o == 2), float(o == 3)]
        ei[0, 2 * k], ei[1, 2 * k] = i, j
        ei[0, 2 * k + 1], ei[1, 2 * k + 1] = j, i
        attr[2 * k] = feats
        attr[2 * k + 1] = feats
    return ei, attr
