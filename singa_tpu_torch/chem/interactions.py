"""Protein-ligand interaction edge extraction.

Vectorised numpy re-design of the reference's ODDT-based detector
(utils/PLInteraction.py:129-260 + utils/PLIExtension.py).
Produces the same contract: for every ligand atom within ``cutoff`` of a
protein atom, bidirectional edges with an 11-dim attribute

    [dist, angle_hbond, angle_xbond, angle_pistack, angle_pication,
     is_hbond, is_xbond, is_hphob, is_sbridge, is_pistack, is_pication]

and ligand atoms with no contact get one edge to the nearest protein atom
(PLInteraction.py:250-258).

Deviations (deliberate): the reference fills the four angle columns from
stale loop counters that drift out of sync with the pair being emitted
(PLInteraction.py:200-242) — here each pair's angles are computed for that
pair. Flags use distance criteria like the reference (the 'strict' angular
H-bond test is computed by ODDT but never applied there).

Counterpart of ``singa_tpu/chem/interactions.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from singa_tpu_torch.chem.mol import Molecule

# Aromatic ring atoms of the four aromatic residues (PLInteraction.py:38-68).
PI_ATOMS = {
    "HIS": {"CG", "CD2", "NE2", "CE1", "ND1"},
    "PHE": {"CG", "CD2", "CE2", "CZ", "CE1", "CD1"},
    "TYR": {"CG", "CD1", "CE1", "CE2", "CD2", "CZ"},
    "TRP": {"CG", "CD1", "NE1", "CE2", "CD2", "CE3", "CZ2", "CZ3", "CH2"},
}

HALOGENS = (9, 17, 35, 53)


@dataclass
class ProteinContext:
    """Per-atom PDB metadata needed for residue-level pi interactions."""

    res_name: np.ndarray  # [N] str
    atom_name: np.ndarray  # [N] str
    res_id: np.ndarray  # [N] int (unique residue index)


def _angle_deg(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    dot = (v1 * v2).sum(axis=-1)
    norm = np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1)
    return np.degrees(np.arccos(np.clip(dot / np.maximum(norm, 1e-12), -1, 1)))


def ring_geometry(mol: Molecule, aromatic_only: bool = True):
    """(centroids [R,3], normals [R,3], ring atom lists) via per-ring SVD."""
    cents, normals, members = [], [], []
    arom = mol.aromatic
    for ring in mol.rings:
        if aromatic_only and not arom[ring].all():
            continue
        coords = mol.pos[ring].astype(np.float64)
        c = coords.mean(axis=0)
        _, _, vt = np.linalg.svd(coords - c)
        cents.append(c)
        normals.append(vt[2])
        members.append(list(ring))
    if not cents:
        return np.zeros((0, 3)), np.zeros((0, 3)), []
    return np.stack(cents), np.stack(normals), members


def protein_rings(ctx: ProteinContext, pos: np.ndarray):
    """Aromatic rings of HIS/PHE/TYR/TRP located by atom names (robust for
    PDB input where bond orders are unknown)."""
    cents, normals, res_ids = [], [], []
    for rid in np.unique(ctx.res_id):
        sel = ctx.res_id == rid
        rname = ctx.res_name[sel][0]
        if rname not in PI_ATOMS:
            continue
        names = ctx.atom_name[sel]
        ring_sel = np.isin(names, list(PI_ATOMS[rname]))
        if ring_sel.sum() < 4:
            continue
        coords = pos[sel][ring_sel].astype(np.float64)
        c = coords.mean(axis=0)
        _, _, vt = np.linalg.svd(coords - c)
        cents.append(c)
        normals.append(vt[2])
        res_ids.append(rid)
    if not cents:
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, np.int64)
    return np.stack(cents), np.stack(normals), np.asarray(res_ids)


def interaction_edges(
    protein: Molecule,
    ligand: Molecule,
    ctx: ProteinContext,
    cutoff: float = 4.0,
):
    """Returns (p2l_index [2, E], l2p_index [2, E], edge_attr [E, 11])."""
    P, L = protein.num_atoms, ligand.num_atoms
    dists = np.linalg.norm(
        protein.pos[:, None, :].astype(np.float64)
        - ligand.pos[None, :, :].astype(np.float64),
        axis=-1,
    )  # [P, L]

    contact = dists <= cutoff

    # --- pairwise flags ---
    p_acc, p_don = protein.is_acceptor, protein.is_donor
    l_acc, l_don = ligand.is_acceptor, ligand.is_donor
    hbond = contact & (
        (p_acc[:, None] & l_don[None, :]) | (p_don[:, None] & l_acc[None, :])
    ) & (dists <= 3.5)

    p_hal = np.isin(protein.atomic_num, HALOGENS) & (protein.heavy_degree == 1)
    l_hal = np.isin(ligand.atomic_num, HALOGENS) & (ligand.heavy_degree == 1)
    xbond = contact & (
        (p_acc[:, None] & l_hal[None, :]) | (p_hal[:, None] & l_acc[None, :])
    )

    hphob = contact & (protein.is_hydrophobe[:, None] & ligand.is_hydrophobe[None, :])
    sbridge = contact & (
        (protein.is_plus[:, None] & ligand.is_minus[None, :])
        | (protein.is_minus[:, None] & ligand.is_plus[None, :])
    )

    # --- ring-level (residue granularity, as in the reference) ---
    p_cent, p_norm, p_ring_res = protein_rings(ctx, protein.pos)
    l_cent, l_norm, l_members = ring_geometry(ligand)

    stack_res: dict[int, float] = {}
    if len(p_cent) and len(l_cent):
        rd = np.linalg.norm(p_cent[:, None] - l_cent[None, :], axis=-1)
        for pi, li in np.argwhere(rd <= max(cutoff, 5.0)):
            ang = float(_angle_deg(p_norm[pi], l_norm[li]))
            stack_res.setdefault(int(p_ring_res[pi]), ang)

    pication_res: dict[int, float] = {}
    if len(p_cent) and ligand.is_plus.any():
        cat_pos = ligand.pos[ligand.is_plus]
        rd = np.linalg.norm(p_cent[:, None] - cat_pos[None, :], axis=-1)
        for pi, ci in np.argwhere(rd <= max(cutoff, 5.0)):
            ang = float(_angle_deg(p_norm[pi], cat_pos[ci] - p_cent[pi]))
            pication_res.setdefault(int(p_ring_res[pi]), ang)
    # reversed: ligand ring vs protein cation
    lig_ring_pication: dict[int, float] = {}
    if len(l_cent) and protein.is_plus.any():
        cat_pos = protein.pos[protein.is_plus]
        rd = np.linalg.norm(l_cent[:, None] - cat_pos[None, :], axis=-1)
        for li, ci in np.argwhere(rd <= max(cutoff, 5.0)):
            ang = float(_angle_deg(l_norm[li], cat_pos[ci] - l_cent[li]))
            lig_ring_pication.setdefault(int(li), ang)

    is_pi_atom = np.zeros(P, dtype=bool)
    for a in range(P):
        rn = ctx.res_name[a]
        if rn in PI_ATOMS and ctx.atom_name[a] in PI_ATOMS[rn]:
            is_pi_atom[a] = True

    # neighbour lookup for H-bond angles
    def first_neighbor(mol: Molecule, a: int) -> int | None:
        ns = mol.neighbors(a)
        return ns[0] if ns else None

    p2l_src, p2l_dst, attrs = [], [], []
    for l_atom in range(L):
        p_contacts = np.nonzero(contact[:, l_atom])[0]
        if len(p_contacts) == 0:
            p_near = int(np.argmin(dists[:, l_atom]))
            p2l_src.append(p_near)
            p2l_dst.append(l_atom)
            attrs.append(
                [float(dists[p_near, l_atom])] + [0.0] * 4 + [0.0] * 6
            )
            continue
        for p_atom in p_contacts:
            d = float(dists[p_atom, l_atom])
            f_hb = bool(hbond[p_atom, l_atom])
            f_xb = bool(xbond[p_atom, l_atom])
            f_hp = bool(hphob[p_atom, l_atom])
            f_sb = bool(sbridge[p_atom, l_atom])
            rid = int(ctx.res_id[p_atom])
            f_ps = bool(is_pi_atom[p_atom] and rid in stack_res)
            f_pc = bool(
                is_pi_atom[p_atom] and (rid in pication_res or lig_ring_pication)
            )

            a_hb = 0.0
            if f_hb:
                # angle at the acceptor between donor and acceptor's neighbour
                if p_acc[p_atom] and l_don[l_atom]:
                    nb = first_neighbor(protein, int(p_atom))
                    if nb is not None:
                        a_hb = float(
                            _angle_deg(
                                ligand.pos[l_atom] - protein.pos[p_atom],
                                protein.pos[nb] - protein.pos[p_atom],
                            )
                        )
                else:
                    nb = first_neighbor(ligand, int(l_atom))
                    if nb is not None:
                        a_hb = float(
                            _angle_deg(
                                protein.pos[p_atom] - ligand.pos[l_atom],
                                ligand.pos[nb] - ligand.pos[l_atom],
                            )
                        )
            a_xb = 0.0
            if f_xb:
                nb = first_neighbor(ligand, int(l_atom)) if l_hal[l_atom] else first_neighbor(protein, int(p_atom))
                if nb is not None:
                    if l_hal[l_atom]:
                        a_xb = float(
                            _angle_deg(
                                protein.pos[p_atom] - ligand.pos[l_atom],
                                ligand.pos[nb] - ligand.pos[l_atom],
                            )
                        )
                    else:
                        a_xb = float(
                            _angle_deg(
                                ligand.pos[l_atom] - protein.pos[p_atom],
                                protein.pos[nb] - protein.pos[p_atom],
                            )
                        )
            a_ps = stack_res.get(rid, 0.0) if f_ps else 0.0
            a_pc = pication_res.get(rid, 0.0) if f_pc else 0.0

            p2l_src.append(int(p_atom))
            p2l_dst.append(l_atom)
            attrs.append(
                [d, a_hb, a_xb, a_ps, a_pc, float(f_hb), float(f_xb), float(f_hp), float(f_sb), float(f_ps), float(f_pc)]
            )

    p2l = np.array([p2l_src, p2l_dst], dtype=np.int64)
    l2p = np.array([p2l_dst, p2l_src], dtype=np.int64)
    attr = np.asarray(attrs, dtype=np.float32)
    return p2l, l2p, attr
