"""Substituent enumeration: grow the ~150-drug embedded corpus to 400+
unique ligands (counterpart of ``singa_tpu/chem/ligand_expand.py``).

The reference trains on CrossDocked2020 (tens of thousands of distinct
ligands, utils/Data.py); the repository ships none, so the
corpus is synthesized from chem/drug_corpus. With only ~150 base drugs the
uniqueness of the samples is bounded at ~150 and a val split cannot
be ligand-disjoint. This module derives new, chemically plausible ligands by
single-point substituent attachment on the base drugs, entirely through the
in-repo SMILES parser/writer (no RDKit):

  parse_smiles(drug) -> pick a carbon with a free hydrogen -> graft a small
  substituent (F, Cl, OH, NH2, CH3, OCH3, CN, CF3, C2H5, COCH3) ->
  write_smiles -> re-parse to validate valence/kekulisation.

Every variant records its BASE drug, so train/val splits can hold out whole
drug families (base + all variants + all pocket sites) — the ligand-disjoint
analogue of the reference's complex-level split
(utils/Data.py:226-227).
"""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.chem.drug_corpus import CORPUS
from singa_tpu_torch.chem.mol import Molecule
from singa_tpu_torch.chem.smiles_parser import parse_smiles
from singa_tpu_torch.chem.smiles_writer import write_smiles

# (name, atomic numbers, internal bonds (i, j, order), attach index)
SUBSTITUENTS = [
    ("methyl", [6], [], 0),
    ("fluoro", [9], [], 0),
    ("chloro", [17], [], 0),
    ("hydroxy", [8], [], 0),
    ("amino", [7], [], 0),
    ("methoxy", [8, 6], [(0, 1, 1)], 0),
    ("cyano", [6, 7], [(0, 1, 3)], 0),
    ("trifluoromethyl", [6, 9, 9, 9], [(0, 1, 1), (0, 2, 1), (0, 3, 1)], 0),
    ("ethyl", [6, 6], [(0, 1, 1)], 0),
    ("acetyl", [6, 8, 6], [(0, 1, 2), (0, 2, 1)], 0),
]

MAX_ATOMS = 48  # stay well inside the 64-atom ligand bucket (ShapeConfig)


def attachment_sites(mol: Molecule) -> list[int]:
    """Carbon atoms with at least one substitutable hydrogen."""
    hs = mol._h_count()
    return [
        a
        for a in range(mol.num_atoms)
        if int(mol.atomic_num[a]) == 6 and hs[a] >= 1 and int(mol.formal_charge[a]) == 0
    ]


def attach(mol: Molecule, site: int, sub_idx: int) -> Molecule:
    """Graft SUBSTITUENTS[sub_idx] onto ``site`` via a single bond."""
    _, zs, internal, attach_idx = SUBSTITUENTS[sub_idx]
    n0 = mol.num_atoms
    k = len(zs)
    atomic = np.concatenate([mol.atomic_num, np.asarray(zs, np.int64)])
    pos = np.concatenate([mol.pos, np.zeros((k, 3), np.float32)])
    new_bonds = [(site, n0 + attach_idx, 1)] + [
        (n0 + i, n0 + j, o) for i, j, o in internal
    ]
    bonds = np.concatenate([mol.bonds, np.asarray([(a, b) for a, b, _ in new_bonds])])
    order = np.concatenate([mol.bond_order, np.asarray([o for _, _, o in new_bonds])])
    arom = np.concatenate([mol.bond_aromatic, np.zeros(len(new_bonds), bool)])
    charge = np.concatenate([mol.formal_charge, np.zeros(k, np.int64)])
    exp_h = None
    if mol.explicit_h is not None:
        exp_h = np.concatenate([mol.explicit_h, np.full(k, -1, np.int64)])
        # the site loses one H to the new bond; keep explicit counts honest
        if exp_h[site] > 0:
            exp_h = exp_h.copy()
            exp_h[site] -= 1
    return Molecule(
        atomic_num=atomic, pos=pos, bonds=bonds, bond_order=order,
        bond_aromatic=arom, formal_charge=charge, explicit_h=exp_h,
    )


def derive_variant(smi: str, site: int, sub_idx: int) -> str | None:
    """One validated single-substitution variant, or None if invalid."""
    try:
        mol = parse_smiles(smi)
        if mol.num_atoms + len(SUBSTITUENTS[sub_idx][1]) > MAX_ATOMS:
            return None
        sites = attachment_sites(mol)
        if site >= len(sites):
            return None
        out = write_smiles(attach(mol, sites[site], sub_idx))
        if not out or "." in out:
            return None
        parse_smiles(out)  # valence + kekulisation check
        return out
    except Exception:
        return None


def expand_corpus(
    target: int, seed: int = 0, base: list[tuple[str, str]] | None = None
) -> list[tuple[str, str, str]]:
    """Grow ``base`` (default: the embedded drug corpus) to ``target`` unique
    ligands. Returns [(name, smiles, base_drug_name)] — base drugs first,
    then derived variants round-robin across drugs so diversity spreads
    evenly. Deterministic in ``seed``.
    """
    base = list(base if base is not None else CORPUS)
    rng = np.random.default_rng(seed)
    out: list[tuple[str, str, str]] = []
    seen: set[str] = set()
    for name, smi in base:
        if smi not in seen:
            seen.add(smi)
            out.append((name, smi, name))
    # per-drug shuffled candidate (site, substituent) queues
    queues = {}
    for name, smi in base:
        try:
            n_sites = len(attachment_sites(parse_smiles(smi)))
        except Exception:
            n_sites = 0
        cand = [(s, j) for s in range(n_sites) for j in range(len(SUBSTITUENTS))]
        rng.shuffle(cand)
        queues[name] = cand
    drugs = [(n, s) for n, s in base if queues[n]]
    round_i = 0
    while len(out) < target:
        progressed = False
        for name, smi in drugs:
            if len(out) >= target:
                break
            q = queues[name]
            if round_i >= len(q):
                continue
            site, sub_idx = q[round_i]
            var = derive_variant(smi, site, sub_idx)
            progressed = True
            if var is None or var in seen:
                continue
            seen.add(var)
            out.append((f"{name}-{SUBSTITUENTS[sub_idx][0]}{site}", var, name))
        round_i += 1
        if not progressed:
            break  # candidate space exhausted
    return out


def ligand_disjoint_split(
    ligands: list[tuple[str, str, str]], val_frac: float = 0.12, seed: int = 0
) -> dict[str, str]:
    """base_drug -> 'train' | 'val', holding out whole drug FAMILIES: every
    variant and every pocket site of a held-out drug goes to val, so val
    ligands (and their scaffolds) never appear in train."""
    bases = sorted({b for _, _, b in ligands})
    rng = np.random.default_rng(seed)
    n_val = max(1, int(round(len(bases) * val_frac)))
    val = set(rng.choice(np.asarray(bases, object), size=n_val, replace=False))
    return {b: ("val" if b in val else "train") for b in bases}
