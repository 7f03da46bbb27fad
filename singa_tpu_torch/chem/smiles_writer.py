"""SMILES generation from a molecular graph.

The reference obtains SMILES via RDKit ``MolToSmiles``
(utils/PLParser.py:385); without RDKit we write our own
emitter. Output is valid (not canonical) SMILES restricted to tokens in the
116-token vocabulary (``config.SMI_VOCAB``): aromatic atoms lowercase,
ring closures with digits (reused after closing; >9 simultaneous open rings
unsupported), charges as bracket atoms with explicit H counts when the vocab
has the token. Stereochemistry is not emitted (deviation; the conditioning
pipeline does not depend on it).

Counterpart of ``singa_tpu/chem/smiles_writer.py``.
"""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.chem.mol import Molecule
from singa_tpu_torch.chem.periodic import SYMBOLS
from singa_tpu_torch.config import SMI_VOCAB

_VOCAB = set(SMI_VOCAB)
_ORGANIC = {5: "B", 6: "C", 7: "N", 8: "O", 9: "F", 15: "P", 16: "S", 17: "Cl", 35: "Br", 53: "I"}
_AROMATIC_OK = {6: "c", 7: "n", 8: "o", 16: "s", 15: "p"}


def _atom_token(mol: Molecule, a: int, arom: np.ndarray, hs: np.ndarray) -> str:
    z = int(mol.atomic_num[a])
    chg = int(mol.formal_charge[a])
    sym = SYMBOLS[z] if z < len(SYMBOLS) else "C"
    if chg == 0:
        if arom[a] and z in _AROMATIC_OK:
            return _AROMATIC_OK[z]
        if z in _ORGANIC:
            return _ORGANIC[z]
        tok = f"[{sym}]"
        return tok if tok in _VOCAB else "C"
    # charged bracket atom: try [XH{n}{+/-}], then [X{+/-}], then fall back
    sign = "+" if chg > 0 else "-"
    base = _AROMATIC_OK[z] if (arom[a] and z in _AROMATIC_OK) else sym
    nh = int(hs[a])
    candidates = []
    if nh == 1:
        candidates.append(f"[{base}H{sign}]")
    elif nh > 1:
        candidates.append(f"[{base}H{nh}{sign}]")
    candidates.append(f"[{base}{sign}]")
    candidates.append(_ORGANIC.get(z, "C"))
    for c in candidates:
        if c in _VOCAB:
            return c
    return "C"


def write_smiles(mol: Molecule) -> str:
    """Graph -> SMILES over the largest connected component first; separate
    components joined with '.'."""
    n = mol.num_atoms
    if n == 0:
        return ""
    arom = mol.aromatic
    hs = mol._h_count()
    g = mol.adjacency

    order_lookup = {}
    for (i, j), o, ar in zip(mol.bonds, mol.bond_order, mol.bond_aromatic):
        order_lookup[(int(i), int(j))] = (int(o), bool(ar))
        order_lookup[(int(j), int(i))] = (int(o), bool(ar))

    def bond_symbol(i, j):
        o, ar = order_lookup[(i, j)]
        if ar or (arom[i] and arom[j] and _ring_bond(i, j)):
            return ""
        return {1: "", 2: "=", 3: "#"}[min(o, 3)]

    ring_bond_set = set()
    ring_sets = [set(r) for r in mol.rings]
    for (i, j) in mol.bonds:
        for rs in ring_sets:
            if int(i) in rs and int(j) in rs:
                ring_bond_set.add((int(i), int(j)))
                ring_bond_set.add((int(j), int(i)))
                break

    def _ring_bond(i, j):
        return (i, j) in ring_bond_set

    visited = np.zeros(n, bool)
    pieces = []

    for start in range(n):
        if visited[start]:
            continue
        # DFS with ring-closure bookkeeping
        closures: dict[tuple[int, int], int] = {}
        digit_in_use: dict[int, bool] = {}
        atom_closures: dict[int, list[tuple[int, str]]] = {}
        parent = {start: -1}
        # first pass: find back edges
        stack = [start]
        seen = {start}
        order = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in g[u]:
                if v not in seen:
                    seen.add(v)
                    parent[v] = u
                    stack.append(v)
        back_edges = []
        tree_children: dict[int, list[int]] = {u: [] for u in seen}
        for u in seen:
            if parent[u] != -1:
                tree_children[parent[u]].append(u)
        added = set()
        for u in seen:
            for v in g[u]:
                if parent.get(v) == u or parent.get(u) == v:
                    continue
                key = (min(u, v), max(u, v))
                if key in added:
                    continue
                added.add(key)
                back_edges.append((u, v))

        next_digit = [1]
        free_digits: list[int] = []

        def assign_digit():
            if free_digits:
                return free_digits.pop()
            d = next_digit[0]
            next_digit[0] += 1
            if d > 9:
                raise ValueError("more than 9 simultaneous ring closures")
            return d

        pending: dict[int, list[tuple[int, str]]] = {}
        for (u, v) in back_edges:
            d = None  # assigned lazily at emit time
            pending.setdefault(u, []).append((v, bond_symbol(u, v)))
            pending.setdefault(v, []).append((u, bond_symbol(u, v)))

        open_digits: dict[tuple[int, int], int] = {}

        out: list[str] = []

        def emit(u: int):
            visited[u] = True
            out.append(_atom_token(mol, u, arom, hs))
            for (v, bsym) in pending.get(u, []):
                key = (min(u, v), max(u, v))
                if key in open_digits:
                    d = open_digits.pop(key)
                    out.append(str(d))
                    free_digits.append(d)
                else:
                    d = assign_digit()
                    open_digits[key] = d
                    out.append(bsym + str(d) if bsym else str(d))
            kids = tree_children[u]
            for idx, v in enumerate(kids):
                bsym = bond_symbol(u, v)
                if idx < len(kids) - 1:
                    out.append("(")
                    out.append(bsym)
                    emit(v)
                    out.append(")")
                else:
                    out.append(bsym)
                    emit(v)

        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * n + 100))
        try:
            emit(start)
        finally:
            sys.setrecursionlimit(old)
        pieces.append("".join(out))

    return ".".join(pieces)
