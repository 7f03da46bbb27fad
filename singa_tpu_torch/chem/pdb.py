"""Pure-python PDB parser with residue bookkeeping and pocket extraction.

Re-design of the reference's PDBProtein (utils/PLParser.py:157-336):
parses ATOM/HETATM records, groups residues, computes centres of mass, can
select residues within a radius of a point/ligand and re-emit a pocket PDB
block. Bonds are perceived geometrically (``chem/mol.perceive_bonds``)
since PDB carries no connectivity — the reference delegated this to OpenBabel.

Counterpart of ``singa_tpu/chem/pdb.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from singa_tpu_torch.chem.mol import Molecule, perceive_bonds
from singa_tpu_torch.chem.periodic import SYMBOLS, atomic_number, atomic_weight

BACKBONE_NAMES = ("N", "CA", "C", "O")


@dataclass
class PDBAtom:
    serial: int
    name: str
    res_name: str
    chain: str
    res_seq: int
    pos: np.ndarray
    element: int
    line: str


@dataclass
class PDBResidue:
    name: str
    chain: str
    seq: int
    atom_indices: list[int]


class PDBProtein:
    def __init__(self, path_or_text: str, remove_hs: bool = True):
        if "\n" in path_or_text:
            text = path_or_text
        else:
            with open(path_or_text) as f:
                text = f.read()
        self.atoms: list[PDBAtom] = []
        self.residues: list[PDBResidue] = []
        res_key = None
        for line in text.splitlines():
            record = line[0:6].strip()
            if record not in ("ATOM", "HETATM"):
                continue
            if record == "HETATM" and line[17:20].strip() == "HOH":
                continue
            element_field = line[76:78].strip() if len(line) >= 78 else ""
            name = line[12:16].strip()
            sym = element_field or "".join(c for c in name if c.isalpha())[:2]
            try:
                z = atomic_number(sym)
            except KeyError:
                try:
                    z = atomic_number(sym[:1])
                except KeyError:
                    continue
            if remove_hs and z == 1:
                continue
            atom = PDBAtom(
                serial=int(line[6:11]),
                name=name,
                res_name=line[17:20].strip(),
                chain=line[21:22],
                res_seq=int(line[22:26]),
                pos=np.array(
                    [float(line[30:38]), float(line[38:46]), float(line[46:54])],
                    dtype=np.float32,
                ),
                element=z,
                line=line,
            )
            key = (atom.chain, atom.res_seq, atom.res_name)
            if key != res_key:
                self.residues.append(
                    PDBResidue(atom.res_name, atom.chain, atom.res_seq, [])
                )
                res_key = key
            self.residues[-1].atom_indices.append(len(self.atoms))
            self.atoms.append(atom)

        self.pos = (
            np.stack([a.pos for a in self.atoms])
            if self.atoms
            else np.zeros((0, 3), np.float32)
        )
        self.atomic_num = np.array([a.element for a in self.atoms], dtype=np.int64)

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def center_of_mass(self) -> np.ndarray:
        w = np.array([atomic_weight(int(z)) for z in self.atomic_num])
        return (self.pos * w[:, None]).sum(axis=0) / w.sum()

    def residue_center_of_mass(self, res: PDBResidue) -> np.ndarray:
        idx = res.atom_indices
        w = np.array([atomic_weight(int(self.atomic_num[i])) for i in idx])
        return (self.pos[idx] * w[:, None]).sum(axis=0) / w.sum()

    def query_residues_radius(
        self, center: np.ndarray, radius: float, criterion: str = "center_of_mass"
    ) -> list[PDBResidue]:
        """Residues whose (COM | any atom) lies within ``radius`` of ``center``
        (reference PLParser.py:304-317)."""
        out = []
        center = np.asarray(center, dtype=np.float32).reshape(1, 3)
        for res in self.residues:
            if criterion == "center_of_mass":
                d = np.linalg.norm(self.residue_center_of_mass(res) - center[0])
                if d <= radius:
                    out.append(res)
            else:
                d = np.linalg.norm(self.pos[res.atom_indices] - center, axis=1)
                if (d <= radius).any():
                    out.append(res)
        return out

    def query_residues_ligand(
        self, ligand_pos: np.ndarray, radius: float = 10.0
    ) -> list[PDBResidue]:
        """Residues within ``radius`` of any ligand atom (PLParser.py:319-326)."""
        out = []
        lig = np.asarray(ligand_pos, dtype=np.float32)
        for res in self.residues:
            rpos = self.pos[res.atom_indices]
            d2 = ((rpos[:, None, :] - lig[None, :, :]) ** 2).sum(-1)
            if (d2 <= radius * radius).any():
                out.append(res)
        return out

    def residues_to_pdb_block(self, residues: list[PDBResidue]) -> str:
        """Re-emit selected residues as a PDB block (PLParser.py:328-336)."""
        lines = ["HEADER    POCKET"]
        for res in residues:
            for i in res.atom_indices:
                lines.append(self.atoms[i].line)
        lines.append("END")
        return "\n".join(lines) + "\n"

    def to_molecule(self, indices: np.ndarray | None = None) -> Molecule:
        """Geometry-perceived Molecule of (a subset of) the protein atoms."""
        if indices is None:
            elements, pos = self.atomic_num, self.pos
        else:
            elements, pos = self.atomic_num[indices], self.pos[indices]
        bonds = perceive_bonds(elements, pos)
        m = len(bonds)
        return Molecule(
            atomic_num=elements,
            pos=pos,
            bonds=bonds,
            bond_order=np.ones(m, dtype=np.int64),
            bond_aromatic=np.zeros(m, dtype=bool),
        )

    def pocket(self, ligand_pos: np.ndarray, radius: float = 10.0):
        """(Molecule, selected atom indices) for residues near the ligand."""
        residues = self.query_residues_ligand(ligand_pos, radius)
        idx = np.array(
            [i for r in residues for i in r.atom_indices], dtype=np.int64
        )
        return self.to_molecule(idx), idx


def atom_line(
    serial: int,
    name: str,
    res_name: str,
    res_seq: int,
    pos,
    element: int,
    chain: str = "A",
    record: str = "ATOM",
) -> str:
    """One fixed-column ATOM/HETATM record, the element in columns 77-78."""
    x, y, z = (float(v) for v in pos)
    sym = SYMBOLS[element].upper()
    return (
        f"{record:<6}{serial:5d} {name:<4} {res_name:>3} {chain:1}{res_seq:4d}    "
        f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {sym:>2}"
    )


def write_pdb(
    pos: np.ndarray, atomic_num: np.ndarray, res_size: int = 8, res_name: str = "UNK"
) -> str:
    """A PDB block of bare atoms (an ETL complex's protein nodes, say): ATOM
    records in order, grouped into residues of ``res_size`` consecutive
    atoms named ``res_name``, each atom named by its element and its place
    in the residue."""
    lines = []
    for i, (p, z) in enumerate(zip(pos, atomic_num)):
        z = int(z)
        name = f"{SYMBOLS[z].upper()}{i % res_size + 1}"
        lines.append(atom_line(i + 1, name, res_name, i // res_size + 1, p, z))
    lines.append("END")
    return "\n".join(lines) + "\n"
