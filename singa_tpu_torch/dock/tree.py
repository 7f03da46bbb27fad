"""Torsion-tree construction for flexible-ligand docking.

Splits the ligand graph at its rotatable bonds into rigid bodies, roots the
resulting body tree at the largest body, and emits, per rotatable bond, the
axis atoms plus the set of atoms that move when that torsion turns (the
entire subtree on the far side of the bond). The C++ search
(cpp/src/vina_dock.cc) applies torsions leaves-first, so this module orders
bonds by decreasing tree depth.

Counterpart of ``singa_tpu/dock/tree.py`` (and of AutoDock's PDBQT
ROOT/BRANCH tree, which the reference gets implicitly from the vendored vina
binary's prepare step), without networkx: the atoms within three bonds come
from ``chem.mol.within_bonds``, a breadth-first walk.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from singa_tpu_torch.chem.mol import Molecule, within_bonds


class TorsionTree(NamedTuple):
    axes: np.ndarray  # [T, 2] int32 (parent-side atom, child-side atom)
    move_offsets: np.ndarray  # [T + 1] int32
    move_atoms: np.ndarray  # int32, concatenated per-bond moving sets
    rigid_body: np.ndarray  # [N] int32 body id per atom


def _rotatable_bond_indices(mol: Molecule) -> list[int]:
    """Indices into mol.bonds of the torsionally active bonds — same
    predicate as chem.properties.rotatable_bonds (single, acyclic, both ends
    heavy-degree >= 2, no hydrogens)."""
    ring = mol.bond_in_ring()
    deg = mol.heavy_degree
    out = []
    for k, ((i, j), o) in enumerate(zip(mol.bonds, mol.bond_order)):
        if o != 1 or ring[k]:
            continue
        if mol.atomic_num[i] == 1 or mol.atomic_num[j] == 1:
            continue
        if deg[i] < 2 or deg[j] < 2:
            continue
        out.append(k)
    return out


def torsion_tree(mol: Molecule) -> TorsionTree:
    n = mol.num_atoms
    rot = _rotatable_bond_indices(mol)
    rot_set = set(rot)

    # rigid bodies: connected components after deleting rotatable bonds
    adj_rigid: list[list[int]] = [[] for _ in range(n)]
    for k, (i, j) in enumerate(mol.bonds):
        if k in rot_set:
            continue
        adj_rigid[int(i)].append(int(j))
        adj_rigid[int(j)].append(int(i))
    body = np.full(n, -1, np.int32)
    nb = 0
    for s in range(n):
        if body[s] >= 0:
            continue
        stack = [s]
        body[s] = nb
        while stack:
            u = stack.pop()
            for v in adj_rigid[u]:
                if body[v] < 0:
                    body[v] = nb
                    stack.append(v)
        nb += 1

    # body tree edges via the rotatable bonds; root = largest body
    body_sizes = np.bincount(body, minlength=nb)
    root = int(np.argmax(body_sizes))
    body_adj: list[list[tuple[int, int]]] = [[] for _ in range(nb)]  # (nbr, bond_k)
    for k in rot:
        i, j = (int(a) for a in mol.bonds[k])
        body_adj[body[i]].append((body[j], k))
        body_adj[body[j]].append((body[i], k))

    # BFS from root: per visited rotatable bond, orient axis parent->child
    # and record depth; moving set = all atoms in the child's subtree
    depth = {root: 0}
    order: list[tuple[int, int, int, int]] = []  # (depth, bond_k, a_par, a_chd)
    parent_body = {root: -1}
    queue = [root]
    while queue:
        b = queue.pop(0)
        for nbr, k in body_adj[b]:
            if nbr in depth:
                continue
            depth[nbr] = depth[b] + 1
            parent_body[nbr] = b
            i, j = (int(a) for a in mol.bonds[k])
            a_par, a_chd = (i, j) if body[i] == b else (j, i)
            order.append((depth[nbr], k, a_par, a_chd))
            queue.append(nbr)

    # moving set per bond: atoms reachable from the child atom without
    # crossing the bond itself
    axes, offs, moves = [], [0], []
    adj_full: list[list[int]] = [[] for _ in range(n)]
    for (i, j) in mol.bonds:
        adj_full[int(i)].append(int(j))
        adj_full[int(j)].append(int(i))
    # leaves first = decreasing depth (stable for determinism)
    for _, k, a_par, a_chd in sorted(order, key=lambda t: -t[0]):
        seen = {a_par, a_chd}
        stack = [a_chd]
        sub = []
        while stack:
            u = stack.pop()
            for v in adj_full[u]:
                if v not in seen:
                    seen.add(v)
                    sub.append(v)
                    stack.append(v)
        axes.append((a_par, a_chd))
        moves.extend(sorted(sub))
        offs.append(len(moves))
    return TorsionTree(
        axes=np.asarray(axes, np.int32).reshape(-1, 2),
        move_offsets=np.asarray(offs, np.int32),
        move_atoms=np.asarray(moves, np.int32),
        rigid_body=body,
    )


def interacting_pairs(mol: Molecule, tree: TorsionTree | None = None) -> np.ndarray:
    """[P, 2] ligand atom pairs whose distance depends on the torsions:
    different rigid bodies AND graph distance >= 4 bonds (1-2/1-3/1-4
    interactions are part of the fixed covalent geometry; Vina excludes
    them the same way)."""
    tree = tree or torsion_tree(mol)
    n = mol.num_atoms
    out = []
    for i in range(n):
        close = within_bonds(mol, i, 3)
        for j in range(i + 1, n):
            if tree.rigid_body[i] == tree.rigid_body[j]:
                continue
            if j in close:
                continue
            out.append((i, j))
    return np.asarray(out, np.int32).reshape(-1, 2)

