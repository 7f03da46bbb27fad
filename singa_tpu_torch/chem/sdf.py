"""Pure-python SDF/MOL (V2000) reader.

Replacement for the RDKit/line-parsing hybrid in the reference
(utils/PLParser.py:378-465). Reads atoms, coordinates, bonds
(order + aromatic), formal charges (both the atom-block column and M  CHG
lines) and computes the mass-weighted centre of mass.

Counterpart of ``singa_tpu/chem/sdf.py``.
"""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.chem.mol import Molecule
from singa_tpu_torch.chem.periodic import atomic_number, atomic_weight

_CHARGE_COLUMN = {1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}


def parse_sdf(path_or_text: str, remove_hs: bool = True) -> Molecule:
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    lines = text.splitlines()
    if len(lines) < 4:
        raise ValueError("not a valid SDF/MOL file")
    counts = lines[3]
    num_atoms = int(counts[0:3])
    num_bonds = int(counts[3:6])

    elements, pos, charges = [], [], []
    for line in lines[4 : 4 + num_atoms]:
        x, y, z = float(line[0:10]), float(line[10:20]), float(line[20:30])
        sym = line[31:34].strip()
        elements.append(atomic_number(sym))
        pos.append((x, y, z))
        try:
            cc = int(line[36:39])
        except (ValueError, IndexError):
            cc = 0
        charges.append(_CHARGE_COLUMN.get(cc, 0))

    bonds, orders, aroma = [], [], []
    for line in lines[4 + num_atoms : 4 + num_atoms + num_bonds]:
        i, j = int(line[0:3]) - 1, int(line[3:6]) - 1
        t = int(line[6:9])
        bonds.append((i, j))
        if t == 4:
            orders.append(1)
            aroma.append(True)
        else:
            orders.append(min(t, 3))
            aroma.append(False)

    # M  CHG overrides the atom-block charges
    for line in lines[4 + num_atoms + num_bonds :]:
        if line.startswith("M  CHG"):
            parts = line.split()
            n = int(parts[2])
            for k in range(n):
                idx = int(parts[3 + 2 * k]) - 1
                charges[idx] = int(parts[4 + 2 * k])
        if line.startswith("M  END"):
            break

    elements = np.asarray(elements, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.float32)
    charges = np.asarray(charges, dtype=np.int64)
    bonds = np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
    orders = np.asarray(orders, dtype=np.int64)
    aroma = np.asarray(aroma, dtype=bool)

    if remove_hs:
        keep = elements != 1
        remap = -np.ones(len(elements), dtype=np.int64)
        remap[keep] = np.arange(keep.sum())
        bond_keep = keep[bonds[:, 0]] & keep[bonds[:, 1]] if len(bonds) else np.zeros(0, bool)
        bonds = remap[bonds[bond_keep]] if len(bonds) else bonds
        orders = orders[bond_keep]
        aroma = aroma[bond_keep]
        elements = elements[keep]
        pos = pos[keep]
        charges = charges[keep]

    return Molecule(
        atomic_num=elements,
        pos=pos,
        bonds=bonds,
        bond_order=orders,
        bond_aromatic=aroma,
        formal_charge=charges,
    )


def center_of_mass(mol: Molecule) -> np.ndarray:
    w = np.array([atomic_weight(int(z)) for z in mol.atomic_num])
    return (mol.pos * w[:, None]).sum(axis=0) / w.sum()


def write_sdf(
    mol: Molecule, name: str = "mol", pos: np.ndarray | None = None
) -> str:
    """V2000 SDF text block round-trippable through parse_sdf. Aromatic bonds
    are written as type 4; formal charges as M  CHG lines."""
    from singa_tpu_torch.chem.periodic import SYMBOLS

    p = mol.pos if pos is None else pos
    n, m = mol.num_atoms, len(mol.bonds)
    lines = [name, "  singa_tpu", ""]
    lines.append(f"{n:3d}{m:3d}  0  0  0  0  0  0  0  0999 V2000")
    for i in range(n):
        x, y, z = (float(v) for v in p[i])
        zi = int(mol.atomic_num[i])
        sym = SYMBOLS[zi] if 0 < zi < len(SYMBOLS) else "X"
        lines.append(
            f"{x:10.4f}{y:10.4f}{z:10.4f} {sym:<3} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for (i, j), o, ar in zip(mol.bonds, mol.bond_order, mol.bond_aromatic):
        t = 4 if ar else int(o)
        lines.append(f"{int(i)+1:3d}{int(j)+1:3d}{t:3d}  0  0  0  0")
    chg = [(i, int(c)) for i, c in enumerate(mol.formal_charge) if c]
    for k in range(0, len(chg), 8):
        seg = chg[k : k + 8]
        lines.append(
            "M  CHG" + f"{len(seg):3d}" + "".join(f"{i+1:4d}{c:4d}" for i, c in seg)
        )
    lines += ["M  END", "$$$$"]
    return "\n".join(lines) + "\n"
