"""Molecular property estimators: MW, logP, TPSA, HBA/HBD, rotatable bonds,
QED, synthetic accessibility.

The reference computes these through RDKit (Crippen.MolLogP, Descriptors.qed,
rdMolDescriptors.CalcTPSA, SAScorer — utils/PLParser.py:378-386)
which is unavailable here. These are self-contained re-implementations of the
published methods with documented approximations:

* logP  — Wildman & Crippen (1999) atom-contribution scheme with a reduced
  atom-type table (the full table has ~68 types; we class by element,
  aromaticity and heteroatom attachment). Values track RDKit within ~1 log
  unit on drug-like molecules.
* TPSA  — Ertl (2000) N/O fragment contributions (common environments).
* QED   — Bickerton (2012) weighted desirability product with the published
  ADS parameters; ALERTS uses a reduced structural-alert set.
* SA    — Ertl & Schuffenhauer complexity terms (ring/stereo/macrocycle/size/
  symmetry) plus a real Morgan-fragment frequency term: circular-environment
  hashes (chem/morgan.py) scored against a frequency table generated from an
  embedded corpus of ~150 approved drugs/biomolecules (tools/gen_sa_db.py) —
  the in-repo analogue of the reference's fpscores.pkl.gz. The 1-10 scale,
  ordering and the <4.0 conditioning threshold (model/GAN.py:40) behave like
  the reference's scorer; absolute values differ by hash/corpus (documented).

Counterpart of ``singa_tpu/chem/properties.py``.
"""
from __future__ import annotations

import math

import numpy as np

from singa_tpu_torch.chem.mol import Molecule

# ---------------- logP (reduced Wildman-Crippen) ----------------

# (class predicate order matters; first match wins)
_CRIPPEN = {
    "C_arom": 0.2955,       # aromatic carbon
    "C_arom_het": 0.1581,   # aromatic carbon bonded to heteroatom substituent
    "C_sp3": 0.1441,        # aliphatic sp3 C with only C/H neighbours
    "C_sp3_het": -0.2035,   # sp3 C bonded to heteroatom
    "C_sp2": 0.0000,        # non-aromatic sp2 C
    "C_sp2_het": -0.2783,   # carbonyl-type C
    "N_arom": -0.3239,
    "N_amine": -1.0190,
    "N_amide": -0.6027,
    "N_other": -0.3260,
    "O_hydroxyl": -0.3567,
    "O_ether": -0.2893,
    "O_carbonyl": -0.1526,
    "O_arom": 0.1552,
    "O_anion": -1.3260,
    "F": 0.4202,
    "Cl": 0.6895,
    "Br": 0.8456,
    "I": 0.8857,
    "S": 0.6482,
    "P": 0.8612,
    "H": 0.1230,
    "other": 0.0,
}


def _atom_logp_class(mol: Molecule, a: int) -> str:
    z = int(mol.atomic_num[a])
    arom = mol.aromatic
    hyb = mol.hybridization
    neigh = mol.neighbors(a)
    has_het = any(int(mol.atomic_num[n]) not in (1, 6) for n in neigh)
    if z == 6:
        if arom[a]:
            return "C_arom_het" if has_het else "C_arom"
        if hyb[a] == 3:
            return "C_sp3_het" if has_het else "C_sp3"
        return "C_sp2_het" if has_het else "C_sp2"
    if z == 7:
        if arom[a]:
            return "N_arom"
        # amide: N bonded to carbonyl C
        for n in neigh:
            if int(mol.atomic_num[n]) == 6:
                for nn in mol.neighbors(n):
                    if int(mol.atomic_num[nn]) == 8 and _bond_order(mol, n, nn) == 2:
                        return "N_amide"
        if hyb[a] == 3:
            return "N_amine"
        return "N_other"
    if z == 8:
        if arom[a]:
            return "O_arom"
        if mol.formal_charge[a] < 0:
            return "O_anion"
        for n in neigh:
            if _bond_order(mol, a, n) == 2:
                return "O_carbonyl"
        if mol._h_count()[a] > 0:
            return "O_hydroxyl"
        return "O_ether"
    return {9: "F", 17: "Cl", 35: "Br", 53: "I", 16: "S", 15: "P", 1: "H"}.get(
        z, "other"
    )


def _bond_order(mol: Molecule, i: int, j: int) -> int:
    data = mol.edge_data(i, j)
    return int(data["order"]) if data else 0


def logp(mol: Molecule) -> float:
    """Full Wildman-Crippen logP (chem/crippen.py, all 68 published atom
    types; literature-pinned tests). The reduced table above is kept only as
    the documented fallback for exotic molecules the full typer rejects."""
    from singa_tpu_torch.chem.crippen import crippen_logp

    try:
        return float(crippen_logp(mol))
    except Exception:
        total = sum(_CRIPPEN[_atom_logp_class(mol, a)] for a in range(mol.num_atoms))
        implicit = mol._h_count() - mol._explicit_h()
        total += float(implicit.sum()) * _CRIPPEN["H"]
        return float(total)


# ---------------- TPSA (Ertl 2000, full fragment table) ----------------

# Ertl, Rohde & Selzer, J. Med. Chem. 2000, 43, 3714 (Table 1). Keys:
# (element, aromatic, charge, n_single, n_double, n_triple, n_aromatic_bonds,
#  n_H, in_3_ring). Bond counts are to heavy atoms only; H is counted
# separately (explicit + implicit, matching RDKit's CalcTPSA environment
# perception). Sulfur/phosphorus contributions are the paper's optional set
# (RDKit includeSandP); the reference uses the default N/O-only variant
# (utils/PLParser.py:385 via rdMolDescriptors.CalcTPSA), so include_sp
# defaults to False.
_TPSA = {
    (7, False, 0, 3, 0, 0, 0, 0, False): 3.24,
    (7, False, 0, 3, 0, 0, 0, 0, True): 3.01,
    (7, False, 0, 1, 1, 0, 0, 0, False): 12.36,
    (7, False, 0, 0, 0, 1, 0, 0, False): 23.79,
    (7, False, 0, 1, 2, 0, 0, 0, False): 11.68,
    (7, False, 0, 0, 1, 1, 0, 0, False): 13.60,
    (7, False, 0, 2, 0, 0, 0, 1, False): 12.03,
    (7, False, 0, 2, 0, 0, 0, 1, True): 21.94,
    (7, False, 0, 0, 1, 0, 0, 1, False): 23.85,
    (7, False, 0, 1, 0, 0, 0, 2, False): 26.02,
    (7, False, 1, 4, 0, 0, 0, 0, False): 0.00,
    (7, False, 1, 2, 1, 0, 0, 0, False): 3.01,
    (7, False, 1, 1, 0, 1, 0, 0, False): 4.36,
    (7, False, 1, 3, 0, 0, 0, 1, False): 4.44,
    (7, False, 1, 1, 1, 0, 0, 1, False): 13.97,
    (7, False, 1, 2, 0, 0, 0, 2, False): 16.61,
    (7, False, 1, 0, 1, 0, 0, 2, False): 25.59,
    (7, False, 1, 1, 0, 0, 0, 3, False): 27.64,
    (7, True, 0, 0, 0, 0, 2, 0, False): 12.89,
    (7, True, 0, 0, 0, 0, 3, 0, False): 4.41,
    (7, True, 0, 1, 0, 0, 2, 0, False): 4.93,
    (7, True, 0, 0, 1, 0, 2, 0, False): 8.39,
    (7, True, 0, 0, 0, 0, 2, 1, False): 15.79,
    (7, True, 1, 0, 0, 0, 3, 0, False): 4.10,
    (7, True, 1, 1, 0, 0, 2, 0, False): 3.88,
    (7, True, 1, 0, 0, 0, 2, 1, False): 14.14,
    (8, False, 0, 2, 0, 0, 0, 0, False): 9.23,
    (8, False, 0, 2, 0, 0, 0, 0, True): 12.53,
    (8, False, 0, 0, 1, 0, 0, 0, False): 17.07,
    (8, False, 0, 1, 0, 0, 0, 1, False): 20.23,
    (8, False, -1, 1, 0, 0, 0, 0, False): 23.06,
    (8, True, 0, 0, 0, 0, 2, 0, False): 13.14,
}
_TPSA_SP = {
    (16, False, 0, 2, 0, 0, 0, 0, False): 25.30,
    (16, False, 0, 0, 1, 0, 0, 0, False): 32.09,
    (16, False, 0, 2, 1, 0, 0, 0, False): 19.21,
    (16, False, 0, 2, 2, 0, 0, 0, False): 8.38,
    (16, False, 0, 1, 0, 0, 0, 1, False): 38.80,
    (16, True, 0, 0, 0, 0, 2, 0, False): 28.24,
    (16, True, 0, 0, 1, 0, 2, 0, False): 21.70,
    (15, False, 0, 3, 0, 0, 0, 0, False): 13.59,
    (15, False, 0, 1, 1, 0, 0, 0, False): 34.14,
    (15, False, 0, 3, 1, 0, 0, 0, False): 9.81,
    (15, False, 0, 2, 1, 0, 0, 1, False): 23.47,
}


def _atom_env(mol: Molecule, a: int, hs, arom, ring3) -> tuple:
    """Bond-environment key for the Ertl table (heavy neighbours only)."""
    s = d = t = ar = 0
    in_arom_ring = bool(arom[a])
    for n in mol.neighbors(a):
        if int(mol.atomic_num[n]) == 1:
            continue
        data = mol.edge_data(a, n)
        o = int(data["order"])
        is_ar = bool(data["aromatic"]) or (in_arom_ring and arom[n] and _same_ring(mol, a, n))
        if is_ar:
            ar += 1
        elif o == 1:
            s += 1
        elif o == 2:
            d += 1
        elif o == 3:
            t += 1
    return (
        int(mol.atomic_num[a]), in_arom_ring, int(mol.formal_charge[a]),
        s, d, t, ar, int(hs[a]), a in ring3,
    )


def _same_ring(mol: Molecule, i: int, j: int) -> bool:
    return any(i in r and j in r for r in map(set, mol.rings))


def tpsa(mol: Molecule, include_sp: bool = False) -> float:
    hs = mol._h_count()
    arom = mol.aromatic
    ring3 = {a for r in mol.rings if len(r) == 3 for a in r}
    table = dict(_TPSA)
    if include_sp:
        table.update(_TPSA_SP)
    total = 0.0
    for a in range(mol.num_atoms):
        z = int(mol.atomic_num[a])
        if z not in (7, 8) and not (include_sp and z in (15, 16)):
            continue
        key = _atom_env(mol, a, hs, arom, ring3)
        contrib = table.get(key)
        if contrib is None and key[-1]:  # 3-ring variant absent -> plain
            contrib = table.get(key[:-1] + (False,))
        if contrib is None:
            # RDKit's fallback estimate for unmatched N/O environments
            x = key[3] + key[4] + key[5] + key[6] + key[7]
            if z == 7:
                contrib = max(0.0, 30.5 - x * 8.2 + key[7] * 1.5)
            elif z == 8:
                contrib = max(0.0, 28.5 - x * 8.6 + key[7] * 1.5)
            else:
                contrib = 0.0
        total += contrib
    return float(total)


# ---------------- H-bond counts, rotatable bonds, rings ----------------

def hba(mol: Molecule) -> int:
    return int(mol.is_acceptor.sum())


def hbd(mol: Molecule) -> int:
    return int(mol.is_donor.sum())


def rotatable_bonds(mol: Molecule) -> int:
    ring = mol.bond_in_ring()
    deg = mol.heavy_degree
    n = 0
    for k, ((i, j), o) in enumerate(zip(mol.bonds, mol.bond_order)):
        if o != 1 or ring[k]:
            continue
        if mol.atomic_num[i] == 1 or mol.atomic_num[j] == 1:
            continue
        if deg[i] < 2 or deg[j] < 2:
            continue
        n += 1
    return n


def aromatic_ring_count(mol: Molecule) -> int:
    arom = mol.aromatic
    return sum(1 for r in mol.rings if arom[r].all())


def structural_alerts(mol: Molecule) -> int:
    """Brenk-style alert count over graph predicates (the QED ALERTS
    descriptor; reference gets it from RDKit's curated SMARTS set). Covered
    patterns: nitro, azide/diazo, aldehyde, acyl halide, polyhalogenated
    carbon, peroxide, thiol, free hydrazine, N-halogen, O-halogen, imine,
    isocyanate/isothiocyanate, thiocarbonyl, sulfonyl halide, epoxide/
    aziridine/thiirane, alpha-halo ketone, phosphorus centres, Michael-
    acceptor enone, quaternary nitrogen, crown-ether-like polyether chains.
    SMARTS we cannot express as local predicates (long-range motifs) are the
    documented remaining gap vs RDKit's 116-pattern set."""
    alerts = 0
    hs = mol._h_count()
    hal = (9, 17, 35, 53)
    ring3 = {a for r in mol.rings if len(r) == 3 for a in r}
    for a in range(mol.num_atoms):
        z = int(mol.atomic_num[a])
        neigh = mol.neighbors(a)
        nn = [int(mol.atomic_num[n]) for n in neigh]
        if z == 7:
            n_o_dbl = sum(
                1
                for n in neigh
                if int(mol.atomic_num[n]) == 8 and _bond_order(mol, a, n) == 2
            )
            n_o = nn.count(8)
            if n_o >= 2 and n_o_dbl >= 1:
                alerts += 1  # nitro
            if nn.count(7) >= 2:
                alerts += 1  # azide / diazo chain
            if any(x in hal for x in nn):
                alerts += 1  # N-halogen
            if len(neigh) == 4:
                alerts += 1  # quaternary nitrogen
            if a in ring3:
                alerts += 1  # aziridine
        if z == 6:
            has_dbl_o = any(
                int(mol.atomic_num[n]) == 8 and _bond_order(mol, a, n) == 2
                for n in neigh
            )
            has_dbl_n = any(
                int(mol.atomic_num[n]) == 7
                and _bond_order(mol, a, n) == 2
                and not mol.aromatic[a]
                for n in neigh
            )
            has_dbl_s = any(
                int(mol.atomic_num[n]) == 16 and _bond_order(mol, a, n) == 2
                for n in neigh
            )
            if has_dbl_o and hs[a] > 0:
                alerts += 1  # aldehyde
            if has_dbl_o and any(x in hal for x in nn):
                alerts += 1  # acyl halide
            if has_dbl_s and not mol.aromatic[a]:
                alerts += 1  # thiocarbonyl
            if has_dbl_n and nn.count(8) + nn.count(16) >= 1 and len(neigh) == 2:
                alerts += 1  # isocyanate / isothiocyanate shape N=C=O/S
            if sum(1 for x in nn if x in hal) > 2:
                alerts += 1  # polyhalogenated carbon
            if has_dbl_o and any(
                x in hal and _bond_order(mol, a, n) == 1
                for n, x in zip(neigh, nn)
            ):
                pass  # covered by acyl halide above
            # alpha-halo ketone: sp3 C bearing halogen adjacent to carbonyl C
            if any(x in hal for x in nn) and not has_dbl_o:
                for n in neigh:
                    if int(mol.atomic_num[n]) == 6 and any(
                        int(mol.atomic_num[m]) == 8 and _bond_order(mol, n, m) == 2
                        for m in mol.neighbors(n)
                    ):
                        alerts += 1
                        break
        if z == 16:
            if hs[a] > 0 and len([x for x in nn if x != 1]) == 1:
                alerts += 1  # thiol
            n_o_dbl = sum(
                1
                for n in neigh
                if int(mol.atomic_num[n]) == 8 and _bond_order(mol, a, n) == 2
            )
            if n_o_dbl >= 2 and any(x in hal for x in nn):
                alerts += 1  # sulfonyl halide
        if z == 15:
            alerts += 1  # phosphorus centre (QED alert set flags organo-P)
    # pair-symmetric motifs, counted once per BOND (the per-atom loop would
    # see them from both ends and count a peroxide twice)
    for (i, j), o in zip(mol.bonds, mol.bond_order):
        zi, zj = int(mol.atomic_num[i]), int(mol.atomic_num[j])
        if o != 1:
            continue
        if zi == 8 and zj == 8:
            alerts += 1  # peroxide
        if (zi == 8 and zj in hal) or (zj == 8 and zi in hal):
            alerts += 1  # O-halogen
        if (
            zi == 7
            and zj == 7
            and hs[i] >= 1
            and hs[j] >= 1
            and not mol.aromatic[i]
            and not mol.aromatic[j]
        ):
            alerts += 1  # free hydrazine
    return alerts


# ---------------- QED ----------------

# ADS parameters (a, b, c, d, e, f, dmax) from Bickerton et al. 2012.
_ADS = {
    "MW": (2.817, 392.575, 290.749, 2.420, 49.223, 65.371, 104.981),
    "ALOGP": (3.173, 137.862, 2.535, 4.581, 0.823, 0.576, 131.319),
    "HBA": (2.949, 160.461, 3.615, 4.436, 0.290, 1.301, 148.776),
    "HBD": (1.619, 1010.051, 0.985, 0.000, 0.714, 0.921, 258.163),
    "PSA": (1.877, 125.223, 62.908, 87.834, 12.020, 28.513, 104.569),
    "ROTB": (0.010, 272.412, 2.558, 1.566, 1.272, 2.758, 105.442),
    "AROM": (3.218, 957.737, 2.275, -0.141, 0.342, 0.669, 312.337),
    "ALERTS": (0.010, 1199.094, -0.090, 0.186, 0.875, 0.632, 312.337),
}
_QED_WEIGHTS = {
    "MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61,
    "PSA": 0.06, "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95,
}


def _ads(x: float, p) -> float:
    a, b, c, d, e, f, dmax = p
    val = a + b / (1 + math.exp(-(x - c + d / 2) / e)) * (
        1 - 1 / (1 + math.exp(-(x - c - d / 2) / f))
    )
    return max(val / dmax, 1e-6)


def qed(mol: Molecule) -> float:
    desc = {
        "MW": mol.mol_weight,
        "ALOGP": logp(mol),
        "HBA": hba(mol),
        "HBD": hbd(mol),
        "PSA": tpsa(mol),
        "ROTB": rotatable_bonds(mol),
        "AROM": aromatic_ring_count(mol),
        "ALERTS": structural_alerts(mol),
    }
    num = sum(w * math.log(_ads(desc[k], _ADS[k])) for k, w in _QED_WEIGHTS.items())
    return float(math.exp(num / sum(_QED_WEIGHTS.values())))


# ---------------- SA score (Ertl & Schuffenhauer) ----------------

def sa_score(mol: Molecule) -> float:
    """Ertl & Schuffenhauer synthetic accessibility (reference
    utils/SAScorer.py): Morgan-fragment frequency term (chem/morgan.py; table
    generated by tools/gen_sa_db.py from an embedded drug corpus — the
    in-repo analogue of fpscores.pkl.gz) combined with the published
    complexity penalties (size, fused/macro rings, stereo proxy, symmetry),
    mapped to the 1-10 scale. Absolute parity with RDKit's scorer is bounded
    by the different hash + corpus; the scale, ordering and the <4.0
    conditioning threshold (model/GAN.py:40) behave equivalently (tests pin
    simple drugs <3.5 and complex polycyclics higher)."""
    from singa_tpu_torch.chem.morgan import fragment_score

    n = mol.num_atoms
    if n == 0:
        return 10.0
    hyb = mol.hybridization
    # fragment term in [-4, 0.5]: 0 = ubiquitous drug motifs, -4 = unseen
    frag_penalty = -fragment_score(mol)

    # ring topology, as Ertl classifies it: fused rings (sharing an edge) are
    # unpenalised; spiro atoms (rings sharing exactly one atom) and bridged
    # systems (sharing 3+ atoms, e.g. norbornane/morphinan cores) are hard
    rings = [set(r) for r in mol.rings]
    n_macro = sum(1 for r in rings if len(r) > 8)
    n_spiro = 0
    bridgeheads: set[int] = set()
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            shared = rings[i] & rings[j]
            if len(shared) == 1:
                n_spiro += 1
            elif len(shared) > 2:
                bridgeheads |= shared
    ring_penalty = (
        math.log10(n_spiro + 1)
        + math.log10(len(bridgeheads) + 1)
        + math.log10(n_macro + 1) * 2
    )

    # stereocentre proxy: sp3 ring-junction atoms (cis/trans-defined) plus
    # acyclic sp3 carbons whose neighbourhood is element-asymmetric
    in_n_rings = np.zeros(n, np.int32)
    for r in rings:
        for a in r:
            in_n_rings[a] += 1
    stereo = 0
    for a in range(n):
        if int(mol.atomic_num[a]) != 6 or hyb[a] != 3:
            continue
        if in_n_rings[a] >= 2:
            stereo += 1
        elif len(mol.neighbors(a)) >= 3:
            zs = sorted(int(mol.atomic_num[x]) for x in mol.neighbors(a))
            if len(set(zs)) >= 3:
                stereo += 1
    stereo_penalty = math.log10(stereo + 1)

    size_penalty = n ** 1.005 - n
    # symmetry bonus: repeated environments
    env = {}
    for a in range(n):
        key = (int(mol.atomic_num[a]), int(hyb[a]), len(mol.neighbors(a)))
        env[key] = env.get(key, 0) + 1
    symmetry_bonus = 0.0
    if n > 8:
        frac_unique = len(env) / n
        symmetry_bonus = -0.5 * (1.0 - frac_unique)

    raw = (
        1.8
        + 1.6 * frag_penalty
        + 1.2 * ring_penalty
        + 1.1 * stereo_penalty
        + size_penalty * 0.005
        + symmetry_bonus
    )
    return float(min(max(raw, 1.0), 10.0))


def all_properties(mol: Molecule) -> dict:
    """Property label dict in the batch contract's keys."""
    return {
        "sas": sa_score(mol),
        "logp": logp(mol),
        "qed": qed(mol),
        "weight": mol.mol_weight,
        "tpsa": tpsa(mol),
    }
