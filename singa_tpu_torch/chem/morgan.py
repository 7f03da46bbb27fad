"""Morgan (ECFP-style) circular atom environments and fragment scoring.

The reference's SA-score fragment term (utils/SAScorer.py:28-64) looks up
RDKit Morgan-fragment hashes in ``fpscores.pkl.gz`` (a 1M-PubChem frequency
table). RDKit's private hash cannot be reproduced without RDKit, so this
module defines its OWN stable circular-environment hash over the in-repo
``Molecule`` perception, plus the Ertl-style frequency scoring used by
``chem.properties.sa_score``. The frequency table is generated by
``tools/gen_sa_db.py`` from an embedded corpus of well-known drug molecules
and shipped as ``chem/data/sa_fragments.json``; fragments outside the table
get the rare-fragment default, exactly as Ertl treats PubChem-rare motifs.

Counterpart of ``singa_tpu/chem/morgan.py``; ``chem/data/sa_fragments.json``
is a copy of the JAX package's table.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache

from singa_tpu_torch.chem.mol import Molecule

_MOD = (1 << 61) - 1  # Mersenne prime; cheap stable mixing field


def _mix(*vals: int) -> int:
    h = 1469598103934665603
    for v in vals:
        h = (h ^ (v % _MOD)) * 1099511628211 % _MOD
    return h


def atom_invariant(mol: Molecule, a: int) -> int:
    """Initial (radius-0) invariant: element, heavy degree, H count, charge,
    aromaticity, ring membership — the ECFP starting tuple."""
    hs = mol._h_count()
    return _mix(
        int(mol.atomic_num[a]),
        int(mol.heavy_degree[a]),
        int(hs[a]),
        int(mol.formal_charge[a]) + 8,
        int(bool(mol.aromatic[a])),
        int(bool(mol.in_ring[a])),
    )


def morgan_environments(mol: Molecule, radius: int = 2) -> dict[int, int]:
    """All circular environments up to ``radius`` -> {hash: count}.

    Neighbour contributions are combined sorted (order-invariant) together
    with the connecting bond order, mirroring the ECFP update rule.
    """
    heavy = [a for a in range(mol.num_atoms) if int(mol.atomic_num[a]) != 1]
    inv = {a: atom_invariant(mol, a) for a in heavy}
    counts: dict[int, int] = {}
    for a in heavy:
        counts[_mix(0, inv[a])] = counts.get(_mix(0, inv[a]), 0) + 1
    for r in range(1, radius + 1):
        new_inv = {}
        for a in heavy:
            contribs = []
            for n in mol.neighbors(a):
                if int(mol.atomic_num[n]) == 1:
                    continue
                data = mol.edge_data(a, n)
                order = 4 if data.get("aromatic") else int(data["order"])
                contribs.append(_mix(order, inv[n]))
            new_inv[a] = _mix(r, inv[a], *sorted(contribs))
        inv = new_inv
        for a in heavy:
            key = _mix(r, inv[a])
            counts[key] = counts.get(key, 0) + 1
    return counts


@lru_cache(maxsize=1)
def _load_db() -> dict[str, float]:
    path = os.path.join(os.path.dirname(__file__), "data", "sa_fragments.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def fragment_score(mol: Molecule, default: float = -4.0) -> float:
    """Ertl fragment term: frequency-weighted mean of per-fragment scores
    (SAScorer.py:40-55 semantics; higher = more common = easier to make).
    Returns ``default`` scaled if no database is shipped."""
    db = _load_db()
    envs = morgan_environments(mol)
    if not envs:
        return 0.0
    total = 0
    score = 0.0
    for h, c in envs.items():
        total += c
        score += c * db.get(str(h), default)
    return score / max(total, 1)
