"""SMILES -> Molecule parser with validity checking (counterpart of
``singa_tpu/chem/smiles_parser.py``, without networkx).

The inverse of ``smiles_writer``. The reference gets parsing for free from
RDKit (``Chem.MolFromSmiles``, reference utils/PLParser.py:378-386); here it
is implemented directly so that generated token sequences can be
validity-checked and property-scored (``chem/properties.py``): the
``--props`` columns of the generation CLI.

Supported: the organic subset + bracket atoms (isotopes, chirality markers
parsed-and-ignored, H counts, charges), branches, ring closures (incl. %nn),
bond symbols ``- = # : / \\``, dot-separated components, aromatic lowercase
atoms with kekulisation (a maximum-cardinality matching on the aromatic atoms
that need a double bond, ``chem/matching.py``: the matching networkx returns,
so the same kekulé bond orders as the JAX package). Rejected (ValueError):
grammar errors, unmatched rings/branches, kekulisation failures, valence
violations. Stereochemistry is accepted but not retained, matching the
writer.

No 3-D coordinates are produced (``pos`` is zeros); topology-based properties
(QED, logP, TPSA, SA score) work directly.
"""
from __future__ import annotations

import re

import numpy as np

from singa_tpu_torch.chem.matching import max_cardinality_matching
from singa_tpu_torch.chem.mol import Molecule
from singa_tpu_torch.chem.periodic import SYMBOLS

_Z_OF = {s: z for z, s in enumerate(SYMBOLS) if s}
_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC = {"b", "c", "n", "o", "p", "s", "se", "as"}
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, "/": 1, "\\": 1, ":": 1}

_BRACKET = re.compile(
    r"^(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?"
    r"(?P<h>H\d*)?(?P<chg>\+{1,3}|-{1,3}|[+-]\d)?(?::(?P<cls>\d+))?$"
)

# (atomic number, formal charge) -> allowed total valences (bond order sum +
# hydrogens). Elements not listed (metals etc.) are not valence-checked.
_VALENCE: dict[tuple[int, int], tuple[int, ...]] = {
    (5, 0): (3,), (5, -1): (4,),
    (6, 0): (4,), (6, -1): (3,), (6, 1): (3,),
    (7, 0): (3,), (7, 1): (4,), (7, -1): (2,),
    (8, 0): (2,), (8, 1): (3,), (8, -1): (1,),
    (9, 0): (1,), (15, 0): (3, 5), (15, 1): (4,),
    (16, 0): (2, 4, 6), (16, 1): (3, 5), (16, -1): (1,),
    (17, 0): (1,), (35, 0): (1,), (53, 0): (1, 3),
    (34, 0): (2, 4, 6), (14, 0): (4,), (1, 0): (1,),
}


class _Atom:
    __slots__ = ("z", "aromatic", "charge", "h", "bracket")

    def __init__(self, z, aromatic, charge=0, h=-1, bracket=False):
        self.z = z
        self.aromatic = aromatic
        self.charge = charge
        self.h = h  # -1: implicit by valence (organic subset)
        self.bracket = bracket


def _parse_bracket(body: str) -> _Atom:
    m = _BRACKET.match(body)
    if not m:
        raise ValueError(f"bad bracket atom [{body}]")
    sym = m.group("sym")
    aromatic = sym[0].islower() and sym != "*"
    z = _Z_OF.get(sym.capitalize() if aromatic else sym)
    if sym == "*":
        z = 6  # wildcard: treat as carbon
    if z is None:
        raise ValueError(f"unknown element {sym!r}")
    h = 0
    if m.group("h"):
        h = int(m.group("h")[1:]) if len(m.group("h")) > 1 else 1
    chg = 0
    c = m.group("chg")
    if c:
        if c[-1].isdigit():
            chg = int(c[1:]) * (1 if c[0] == "+" else -1)
        else:
            chg = len(c) * (1 if c[0] == "+" else -1)
    return _Atom(z, aromatic, chg, h, bracket=True)


def parse_smiles(smi: str) -> Molecule:
    """Parse; raises ValueError on any invalidity."""
    if not smi:
        raise ValueError("empty SMILES")
    atoms: list[_Atom] = []
    bonds: list[tuple[int, int, int, bool]] = []  # i, j, order(0=aromatic), arom

    prev: int | None = None
    stack: list[int | None] = []
    pending: str | None = None
    rings: dict[int, tuple[int, str | None]] = {}
    i, n = 0, len(smi)

    def add_bond(a: int, b: int, sym: str | None):
        if a == b:
            raise ValueError("self bond")
        ar = atoms[a].aromatic and atoms[b].aromatic and sym in (None, ":")
        order = _BOND_ORDER.get(sym, 1) if sym else 1
        bonds.append((a, b, order, ar))

    def new_atom(atom: _Atom):
        nonlocal prev, pending
        atoms.append(atom)
        idx = len(atoms) - 1
        if prev is not None:
            add_bond(prev, idx, pending)
        pending = None
        prev = idx

    while i < n:
        ch = smi[i]
        if ch == "[":
            j = smi.find("]", i)
            if j < 0:
                raise ValueError("unclosed bracket")
            new_atom(_parse_bracket(smi[i + 1 : j]))
            i = j + 1
        elif ch in "BCNOPSFI" or smi[i : i + 2] in ("Cl", "Br"):
            if smi[i : i + 2] in ("Cl", "Br"):
                new_atom(_Atom(_Z_OF[smi[i : i + 2]], False))
                i += 2
            else:
                new_atom(_Atom(_Z_OF[ch], False))
                i += 1
        elif ch in "bcnops":
            new_atom(_Atom(_Z_OF[ch.upper()], True))
            i += 1
        elif ch in "-=#:/\\":
            if pending is not None:
                raise ValueError("double bond symbol")
            pending = ch
            i += 1
        elif ch == "(":
            if prev is None:
                raise ValueError("branch before any atom")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise ValueError("unmatched ')'")
            prev = stack.pop()
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                if i + 2 >= n or not smi[i + 1 : i + 3].isdigit():
                    raise ValueError("bad %nn ring closure")
                num = int(smi[i + 1 : i + 3])
                i += 3
            else:
                num = int(ch)
                i += 1
            if prev is None:
                raise ValueError("ring digit before any atom")
            if num in rings:
                a, sym0 = rings.pop(num)
                sym = pending if pending is not None else sym0
                if sym0 is not None and pending is not None and sym0 != pending:
                    raise ValueError("conflicting ring bond symbols")
                add_bond(a, prev, sym)
                pending = None
            else:
                rings[num] = (prev, pending)
                pending = None
        elif ch == ".":
            prev = None
            pending = None
            i += 1
        else:
            raise ValueError(f"unexpected character {ch!r} at {i}")

    if rings:
        raise ValueError(f"unclosed ring closures: {sorted(rings)}")
    if stack:
        raise ValueError("unclosed branch")
    if pending is not None:
        raise ValueError("dangling bond symbol")
    if not atoms:
        raise ValueError("no atoms")
    # duplicate bonds are invalid
    seen = set()
    for a, b, _, _ in bonds:
        key = (min(a, b), max(a, b))
        if key in seen:
            raise ValueError("duplicate bond")
        seen.add(key)

    order = _kekulize(atoms, bonds)
    _check_valence(atoms, bonds, order)

    na = len(atoms)
    mol = Molecule(
        atomic_num=np.array([a.z for a in atoms], np.int64),
        pos=np.zeros((na, 3), np.float32),
        bonds=np.array([(a, b) for a, b, _, _ in bonds], np.int64).reshape(-1, 2),
        bond_order=np.asarray(order, np.int64),
        bond_aromatic=np.array([ar for *_, ar in bonds], bool),
        formal_charge=np.array([a.charge for a in atoms], np.int64),
        explicit_h=np.array([a.h if a.bracket else -1 for a in atoms], np.int64),
    )
    mol._aromatic = np.array([a.aromatic for a in atoms], bool)
    return mol


def _kekulize(atoms: list[_Atom], bonds) -> list[int]:
    """Assign orders to aromatic bonds via perfect matching.

    Each aromatic atom that still lacks a pi electron pair must receive
    exactly one double bond along an aromatic bond; others receive none.
    A maximum matching that fails to cover all 'needs-one' atoms means the
    aromatic system cannot be kekulised -> invalid SMILES.
    """
    order = [o for _, _, o, _ in bonds]
    arom_bonds = [(k, a, b) for k, (a, b, _, ar) in enumerate(bonds) if ar]
    if not arom_bonds:
        return order

    deg = np.zeros(len(atoms), int)  # sigma degree (all bonds count once)
    val = np.zeros(len(atoms), int)  # non-aromatic valence used
    has_exo_double = np.zeros(len(atoms), bool)
    for a, b, o, ar in bonds:
        deg[a] += 1
        deg[b] += 1
        if not ar:
            val[a] += o
            val[b] += o
            if o >= 2:
                has_exo_double[a] = has_exo_double[b] = True

    needs = {}
    for idx, at in enumerate(atoms):
        if not at.aromatic:
            continue
        h = at.h if at.bracket else -1
        if at.z == 6:
            if has_exo_double[idx]:
                need = False
            elif at.charge != 0:
                need = False  # c+/c- carry the ring charge, no pi bond
            else:
                need = True
        elif at.z == 7 or at.z == 15:
            if at.charge == 1:
                need = True  # pyridinium-type: [nH+] and [n+](R) both pi-bond
            elif at.charge == -1:
                need = False  # anionic n (tetrazolate): lone pair in ring
            elif h > 0 or deg[idx] >= 3:
                need = False  # pyrrole-type (H or substituent)
            else:
                need = True  # pyridine-type
        elif at.z in (8, 16, 34):
            need = False
        elif at.z == 5:
            need = False
        else:
            need = False
        if need:
            needs[idx] = True

    # the graph networkx would build from these edges: nodes and neighbours
    # in insertion order
    adj: dict[int, dict[int, None]] = {}
    for k, a, b in arom_bonds:
        if needs.get(a) and needs.get(b):
            adj.setdefault(a, {})
            adj.setdefault(b, {})
            adj[a][b] = adj[b][a] = None
    mate = max_cardinality_matching(adj)
    bond_of = {frozenset((a, b)): k for k, a, b in arom_bonds}
    for a, b in mate.items():
        order[bond_of[frozenset((a, b))]] = 2
    matched = set(mate)
    unmatched = [a for a in needs if a not in matched]
    if unmatched:
        raise ValueError(f"kekulisation failed at atoms {unmatched}")
    return order


def _check_valence(atoms: list[_Atom], bonds, order) -> None:
    used = np.zeros(len(atoms), float)
    for (a, b, _, _), o in zip(bonds, order):
        used[a] += o
        used[b] += o
    for idx, at in enumerate(atoms):
        allowed = _VALENCE.get((at.z, at.charge))
        if allowed is None:
            continue  # metals / exotic charges: unchecked
        h = at.h if at.bracket else None
        total = used[idx] + (h or 0)
        if h is None:
            # implicit H fills up to the smallest allowed valence
            if used[idx] > max(allowed):
                raise ValueError(
                    f"valence {used[idx]} exceeds {max(allowed)} at atom {idx}"
                )
        else:
            if total not in allowed:
                raise ValueError(
                    f"explicit valence {total} not in {allowed} at atom {idx}"
                )


def is_valid_smiles(smi: str) -> bool:
    try:
        parse_smiles(smi)
        return True
    except (ValueError, RecursionError):
        return False
