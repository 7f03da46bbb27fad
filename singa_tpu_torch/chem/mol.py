"""Self-contained molecular graph with rule-based perception (counterpart of
``singa_tpu/chem/mol.py``, without networkx).

The reference leans on OpenBabel/ODDT for atom typing (hybridisation, partial
charges, pharmacophoric flags, reference utils/Data.py:123-169) and for bond
perception of PDB proteins. This module derives the same per-atom properties
from the bare (element, coordinates, bonds) graph with the JAX package's
documented approximations:

* bond perception (when absent): distance vs covalent-radii criterion
* ring membership: a cycle basis (Paton's algorithm, as networkx's
  ``cycle_basis``: the same rings in the same order)
* aromaticity: planar rings of sp2-capable atoms with Hückel-compatible
  electron counts (simple 4n+2 over {C,N,O,S} contributions)
* hybridisation: from bond orders/degree heuristics
* Gasteiger-Marsili PEOE partial charges (standard published parameters)
* donor/acceptor/hydrophobe/charged flags: ODDT-style rules

The graph is an adjacency of dicts filled in the order of ``bonds``, as
``networkx.Graph.add_edge`` fills its own, so ``neighbors(i)`` lists an atom's
neighbours in the order networkx gives them: the H-bond angle partner
(``interactions.first_neighbor``) and every walk over the graph depend on it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from singa_tpu_torch.chem.periodic import (
    atomic_weight,
    covalent_radius,
)

# Gasteiger-Marsili PEOE parameters: (a, b, c) per (element, hybrid) class.
# Electronegativity chi(Q) = a + b*Q + c*Q^2. Values from the 1980 paper.
_GASTEIGER = {
    ("H", None): (7.17, 6.24, -0.56),
    ("C", 3): (7.98, 9.18, 1.88),
    ("C", 2): (8.79, 9.32, 1.51),
    ("C", 1): (10.39, 9.45, 0.73),
    ("N", 3): (11.54, 10.82, 1.36),
    ("N", 2): (12.87, 11.15, 0.85),
    ("N", 1): (15.68, 11.70, -0.27),
    ("O", 3): (14.18, 12.92, 1.39),
    ("O", 2): (17.07, 13.79, 0.47),
    ("F", None): (14.66, 13.85, 2.31),
    ("Cl", None): (11.00, 9.69, 1.35),
    ("Br", None): (10.08, 8.47, 1.16),
    ("I", None): (9.90, 7.96, 0.96),
    ("S", 3): (10.14, 9.13, 1.38),
    ("P", 3): (8.90, 8.24, 0.96),
}

_SYM = {1: "H", 6: "C", 7: "N", 8: "O", 9: "F", 15: "P", 16: "S", 17: "Cl", 35: "Br", 53: "I"}


@dataclass
class Molecule:
    """Plain-array molecular graph; all perception results are cached fields."""

    atomic_num: np.ndarray  # [N] int
    pos: np.ndarray  # [N, 3] float32
    bonds: np.ndarray  # [M, 2] int (i < j not required)
    bond_order: np.ndarray  # [M] int (1, 2, 3; aromatic marked separately)
    bond_aromatic: np.ndarray  # [M] bool
    formal_charge: np.ndarray | None = None  # [N] int
    # exact H counts where known (SMILES bracket atoms): -1 = infer by valence
    explicit_h: np.ndarray | None = None  # [N] int

    # perception caches
    _adj: dict | None = field(default=None, repr=False)
    _rings: list | None = field(default=None, repr=False)
    _aromatic: np.ndarray | None = field(default=None, repr=False)
    _hyb: np.ndarray | None = field(default=None, repr=False)
    _charges: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self):
        self.atomic_num = np.asarray(self.atomic_num, dtype=np.int64)
        self.pos = np.asarray(self.pos, dtype=np.float32)
        self.bonds = np.asarray(self.bonds, dtype=np.int64).reshape(-1, 2)
        self.bond_order = np.asarray(self.bond_order, dtype=np.int64).reshape(-1)
        self.bond_aromatic = np.asarray(self.bond_aromatic, dtype=bool).reshape(-1)
        if self.formal_charge is None:
            self.formal_charge = np.zeros(len(self.atomic_num), dtype=np.int64)
        if self.explicit_h is not None:
            self.explicit_h = np.asarray(self.explicit_h, dtype=np.int64)

    # ---------- topology ----------

    @property
    def num_atoms(self) -> int:
        return len(self.atomic_num)

    @property
    def adjacency(self) -> dict[int, dict[int, dict]]:
        """{atom: {neighbour: {"order", "aromatic"}}}, both directions sharing
        one data dict; a repeated bond updates its data in place."""
        if self._adj is None:
            adj: dict[int, dict[int, dict]] = {a: {} for a in range(self.num_atoms)}
            for (i, j), o, ar in zip(self.bonds, self.bond_order, self.bond_aromatic):
                i, j = int(i), int(j)
                adj.setdefault(i, {})
                adj.setdefault(j, {})
                data = adj[i].get(j, {})
                data.update(order=int(o), aromatic=bool(ar))
                adj[i][j] = adj[j][i] = data
            self._adj = adj
        return self._adj

    def neighbors(self, i: int) -> list[int]:
        return list(self.adjacency[i])

    def edge_data(self, i: int, j: int) -> dict | None:
        """The bond's {"order", "aromatic"}, or None without a bond."""
        return self.adjacency[i].get(j)

    @property
    def degree(self) -> np.ndarray:
        deg = np.zeros(self.num_atoms, dtype=np.int64)
        for i, j in self.bonds:
            deg[i] += 1
            deg[j] += 1
        return deg

    @property
    def heavy_degree(self) -> np.ndarray:
        deg = np.zeros(self.num_atoms, dtype=np.int64)
        for i, j in self.bonds:
            if self.atomic_num[j] != 1:
                deg[i] += 1
            if self.atomic_num[i] != 1:
                deg[j] += 1
        return deg

    @property
    def rings(self) -> list[list[int]]:
        if self._rings is None:
            self._rings = cycle_basis(self.adjacency)
        return self._rings

    @property
    def in_ring(self) -> np.ndarray:
        mask = np.zeros(self.num_atoms, dtype=bool)
        for ring in self.rings:
            mask[ring] = True
        return mask

    def bond_in_ring(self) -> np.ndarray:
        ring_sets = [set(r) for r in self.rings]
        out = np.zeros(len(self.bonds), dtype=bool)
        for k, (i, j) in enumerate(self.bonds):
            for rs in ring_sets:
                if int(i) in rs and int(j) in rs:
                    out[k] = True
                    break
        return out

    # ---------- perception ----------

    @property
    def aromatic(self) -> np.ndarray:
        """Per-atom aromatic flag.

        An explicit aromatic bond marks its atoms; otherwise rings of size
        5-7 whose atoms are all sp2-capable with a 4n+2 pi-electron count are
        flagged (approximation of OpenBabel's model)."""
        if self._aromatic is not None:
            return self._aromatic
        arom = np.zeros(self.num_atoms, dtype=bool)
        for (i, j), ar in zip(self.bonds, self.bond_aromatic):
            if ar:
                arom[i] = arom[j] = True
        order_lookup = {}
        for (i, j), o in zip(self.bonds, self.bond_order):
            order_lookup[(int(i), int(j))] = int(o)
            order_lookup[(int(j), int(i))] = int(o)
        deg = self.degree
        for ring in self.rings:
            if not 5 <= len(ring) <= 7:
                continue
            if arom[ring].all():
                continue
            pi = 0
            ok = True
            ring_set = set(ring)
            for a in ring:
                z = int(self.atomic_num[a])
                if z not in (6, 7, 8, 16):
                    ok = False
                    break
                has_double = any(
                    order_lookup.get((a, n), 1) >= 2 for n in self.neighbors(a)
                )
                if z == 6:
                    if not has_double:
                        ok = False
                        break
                    pi += 1
                elif z == 7:
                    pi += 1 if has_double else 2
                elif z in (8, 16):
                    if has_double and all(
                        order_lookup.get((a, n), 1) < 2 or n in ring_set
                        for n in self.neighbors(a)
                    ) and deg[a] > 2:
                        ok = False
                        break
                    pi += 2
            if ok and pi % 4 == 2:
                arom[ring] = True
        self._aromatic = arom
        return arom

    @property
    def hybridization(self) -> np.ndarray:
        """0=other, 1=sp, 2=sp2, 3=sp3 (ODDT/OpenBabel convention subset,
        reference utils/Data.py:60-76)."""
        if self._hyb is not None:
            return self._hyb
        hyb = np.zeros(self.num_atoms, dtype=np.int64)
        max_order = np.ones(self.num_atoms, dtype=np.int64)
        n_multi = np.zeros(self.num_atoms, dtype=np.int64)
        for (i, j), o in zip(self.bonds, self.bond_order):
            for a in (int(i), int(j)):
                max_order[a] = max(max_order[a], int(o))
                if int(o) >= 2:
                    n_multi[a] += 1
        arom = self.aromatic
        for a in range(self.num_atoms):
            z = int(self.atomic_num[a])
            if z == 1:
                hyb[a] = 0
                continue
            if max_order[a] >= 3 or n_multi[a] >= 2:
                hyb[a] = 1
            elif max_order[a] == 2 or arom[a]:
                hyb[a] = 2
            else:
                hyb[a] = 3
        self._hyb = hyb
        return hyb

    @property
    def partial_charge(self) -> np.ndarray:
        """Gasteiger-Marsili PEOE charges (6 iterations, damping 0.5^k)."""
        if self._charges is not None:
            return self._charges
        n = self.num_atoms
        hyb = self.hybridization
        params = np.zeros((n, 3))
        for a in range(n):
            z = int(self.atomic_num[a])
            sym = _SYM.get(z)
            key = None
            if sym is not None:
                if (sym, None) in _GASTEIGER:
                    key = (sym, None)
                else:
                    h = int(hyb[a]) if hyb[a] in (1, 2, 3) else 3
                    while h <= 3 and (sym, h) not in _GASTEIGER:
                        h += 1
                    if (sym, h) in _GASTEIGER:
                        key = (sym, h)
            params[a] = _GASTEIGER.get(key, (9.0, 9.0, 1.0))
        q = self.formal_charge.astype(np.float64).copy()
        a_, b_, c_ = params[:, 0], params[:, 1], params[:, 2]
        chi_plus = a_ + b_ + c_  # cation electronegativity (normaliser)
        chi_plus = np.where(self.atomic_num == 1, 20.02, chi_plus)
        for it in range(6):
            chi = a_ + b_ * q + c_ * q * q
            damp = 0.5 ** (it + 1)
            dq = np.zeros(n)
            for (i, j) in self.bonds:
                i, j = int(i), int(j)
                if chi[j] > chi[i]:
                    t = (chi[j] - chi[i]) / chi_plus[i] * damp
                    dq[i] += t
                    dq[j] -= t
                else:
                    t = (chi[i] - chi[j]) / chi_plus[j] * damp
                    dq[j] += t
                    dq[i] -= t
            q += dq
        self._charges = q.astype(np.float32)
        return self._charges

    # ---------- pharmacophoric flags (ODDT-style, Data.py:137-143) ----------

    def _h_count(self) -> np.ndarray:
        """Explicit H neighbours + implicit H estimate for heavy atoms."""
        explicit = np.zeros(self.num_atoms, dtype=np.int64)
        for i, j in self.bonds:
            if self.atomic_num[j] == 1:
                explicit[i] += 1
            if self.atomic_num[i] == 1:
                explicit[j] += 1
        # implicit H from standard valences when no explicit H present.
        # Aromatic bonds count 1.5 regardless of their stored Kekulé order
        # (so c1ccccc1 carbons get exactly one H whether the ring arrived
        # kekulised or flagged aromatic).
        valence = {6: 4, 7: 3, 8: 2, 16: 2}
        arom = self.aromatic
        ring_sets = [set(r) for r in self.rings]

        def _is_arom_bond(i, j, ar):
            if ar:
                return True
            if not (arom[i] and arom[j]):
                return False
            return any(i in rs and j in rs for rs in ring_sets)

        used = np.zeros(self.num_atoms, dtype=np.float64)
        for (i, j), o, ar in zip(self.bonds, self.bond_order, self.bond_aromatic):
            w = 1.5 if _is_arom_bond(int(i), int(j), bool(ar)) else float(o)
            used[i] += w
            used[j] += w
        implicit = np.zeros(self.num_atoms, dtype=np.int64)
        has_h = explicit > 0
        for a in range(self.num_atoms):
            z = int(self.atomic_num[a])
            if z in valence and not has_h[a]:
                v = valence[z] + int(self.formal_charge[a]) * (1 if z == 7 else -1 if z == 8 else 0)
                implicit[a] = max(0, int(np.floor(v - used[a] + 0.5)))
        if self.explicit_h is not None:
            # SMILES bracket atoms carry exact H counts; -1 = infer as above
            specified = self.explicit_h >= 0
            return np.where(specified, self.explicit_h + explicit, explicit + implicit)
        return explicit + implicit

    @property
    def is_donor(self) -> np.ndarray:
        hs = self._h_count()
        return ((self.atomic_num == 7) | (self.atomic_num == 8)) & (hs > 0)

    @property
    def is_donor_h(self) -> np.ndarray:
        """Hydrogens attached to donors."""
        donors = self.is_donor
        out = np.zeros(self.num_atoms, dtype=bool)
        for i, j in self.bonds:
            if self.atomic_num[i] == 1 and donors[j]:
                out[i] = True
            if self.atomic_num[j] == 1 and donors[i]:
                out[j] = True
        return out

    @property
    def is_acceptor(self) -> np.ndarray:
        out = np.zeros(self.num_atoms, dtype=bool)
        hs = self._h_count()
        deg = self.heavy_degree
        for a in range(self.num_atoms):
            z = int(self.atomic_num[a])
            if z == 8 and self.formal_charge[a] <= 0:
                out[a] = True
            elif z == 7:
                # N with available lone pair: not positively charged,
                # not a pyrrole-type N-H in an aromatic ring
                if self.formal_charge[a] > 0:
                    continue
                if self.aromatic[a] and hs[a] > 0:
                    continue
                if deg[a] + hs[a] <= 3:
                    out[a] = True
        return out

    @property
    def is_hydrophobe(self) -> np.ndarray:
        """Carbons bonded only to C/H (plus halogens on such carbons)."""
        out = np.zeros(self.num_atoms, dtype=bool)
        for a in range(self.num_atoms):
            z = int(self.atomic_num[a])
            if z == 6:
                if all(
                    int(self.atomic_num[n]) in (1, 6, 9, 17, 35, 53)
                    for n in self.neighbors(a)
                ):
                    out[a] = True
            elif z in (17, 35, 53):
                if all(int(self.atomic_num[n]) == 6 for n in self.neighbors(a)):
                    out[a] = True
        return out

    @property
    def is_minus(self) -> np.ndarray:
        """Anionic: explicit negative charge, or O in carboxylate/phosphate/
        sulfate-like groups."""
        out = self.formal_charge < 0
        order_lookup = {}
        for (i, j), o in zip(self.bonds, self.bond_order):
            order_lookup[(int(i), int(j))] = int(o)
            order_lookup[(int(j), int(i))] = int(o)
        hs = self._h_count()
        for a in range(self.num_atoms):
            if int(self.atomic_num[a]) != 8 or hs[a] > 0:
                continue
            for c in self.neighbors(a):
                zc = int(self.atomic_num[c])
                if zc in (6, 15, 16):
                    # central atom bonded to another O by a double bond?
                    for o2 in self.neighbors(c):
                        if o2 != a and int(self.atomic_num[o2]) == 8 and order_lookup.get((c, o2), 1) == 2 and order_lookup.get((c, a), 1) == 1:
                            out[a] = True
        return out

    @property
    def is_plus(self) -> np.ndarray:
        """Cationic: explicit positive charge, or guanidinium / primary amine N."""
        out = self.formal_charge > 0
        hs = self._h_count()
        deg = self.heavy_degree
        for a in range(self.num_atoms):
            if int(self.atomic_num[a]) != 7 or self.aromatic[a]:
                continue
            # sp3 N with >= 2 H (likely protonated at physiological pH)
            if self.hybridization[a] == 3 and hs[a] >= 2 and deg[a] <= 2:
                out[a] = True
        return out

    @property
    def mol_weight(self) -> float:
        # explicit hydrogens are counted via atomic_num; add only implicit H
        implicit = self._h_count() - self._explicit_h()
        return float(
            sum(atomic_weight(int(z)) for z in self.atomic_num)
            + implicit[self.atomic_num != 1].sum() * 1.008
        )

    def _explicit_h(self) -> np.ndarray:
        explicit = np.zeros(self.num_atoms, dtype=np.int64)
        for i, j in self.bonds:
            if self.atomic_num[j] == 1:
                explicit[i] += 1
            if self.atomic_num[i] == 1:
                explicit[j] += 1
        return explicit


def perceive_bonds(atomic_num: np.ndarray, pos: np.ndarray, tol: float = 0.45) -> np.ndarray:
    """Distance-based covalent bond perception (i<j pairs).

    Bond iff d(i,j) <= r_cov(i) + r_cov(j) + tol. Replaces OpenBabel's
    perception for PDB input."""
    atomic_num = np.asarray(atomic_num)
    pos = np.asarray(pos, dtype=np.float64)
    n = len(atomic_num)
    radii = np.array([covalent_radius(int(z)) for z in atomic_num])
    bonds = []
    # grid hash for O(N) neighbour search
    cell = (radii.max() * 2 + tol) if n else 1.0
    grid: dict[tuple, list[int]] = {}
    keys = np.floor(pos / cell).astype(np.int64)
    for idx in range(n):
        grid.setdefault(tuple(keys[idx]), []).append(idx)
    for idx in range(n):
        kx, ky, kz = keys[idx]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for jdx in grid.get((kx + dx, ky + dy, kz + dz), ()):
                        if jdx <= idx:
                            continue
                        d = np.linalg.norm(pos[idx] - pos[jdx])
                        if 0.4 < d <= radii[idx] + radii[jdx] + tol:
                            bonds.append((idx, jdx))
    return np.asarray(bonds, dtype=np.int64).reshape(-1, 2)


def cycle_basis(adj: dict[int, dict]) -> list[list[int]]:
    """Fundamental cycles of a spanning forest (Paton 1969, CACM 491), walked
    as networkx 3.x's ``cycle_basis(G)`` walks them: roots taken from the
    end of the node order, a stack of nodes, neighbours in adjacency order.
    The same rings in the same order, each from the same start node."""
    gnodes = dict.fromkeys(adj)
    cycles = []
    while gnodes:
        root = gnodes.popitem()[0]
        stack = [root]
        pred = {root: root}
        used = {root: set()}
        while stack:
            z = stack.pop()
            zused = used[z]
            for nbr in adj[z]:
                if nbr not in used:
                    pred[nbr] = z
                    stack.append(nbr)
                    used[nbr] = {z}
                elif nbr == z:
                    cycles.append([z])
                elif nbr not in zused:
                    pn = used[nbr]
                    cycle = [nbr, z]
                    p = pred[z]
                    while p not in pn:
                        cycle.append(p)
                        p = pred[p]
                    cycle.append(p)
                    cycles.append(cycle)
                    used[nbr].add(z)
        for node in pred:
            gnodes.pop(node, None)
    return cycles


def within_bonds(mol: Molecule, s: int, cutoff: int) -> set[int]:
    """Atoms at most ``cutoff`` bonds from ``s``, ``s`` included (the keys of
    networkx's ``single_source_shortest_path_length(g, s, cutoff)``)."""
    seen = {s}
    frontier = [s]
    for _ in range(cutoff):
        nxt = []
        for u in frontier:
            for v in mol.adjacency[u]:
                if v not in seen:
                    seen.add(v)
                    nxt.append(v)
        frontier = nxt
    return seen
