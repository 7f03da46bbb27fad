"""Minimal periodic-table data for the self-contained chem stack.

Replaces the RDKit periodic table lookups the reference makes
(utils/PLParser.py:409-430) and supplies covalent radii for
bond perception (the reference delegates that to OpenBabel) plus van der
Waals radii for SASA (reference config/symbol_radius.json).

A copy of ``singa_tpu/chem/periodic.py``.
"""
from __future__ import annotations

SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po",
]

ATOMIC_NUMBER = {s: i for i, s in enumerate(SYMBOLS)}
ATOMIC_NUMBER.update({s.upper(): i for i, s in enumerate(SYMBOLS)})

# Standard atomic weights (g/mol); 0 placeholder for index 0.
ATOMIC_WEIGHT = [
    0.0, 1.008, 4.0026, 6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998,
    20.180, 22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933,
    58.693, 63.546, 65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
    85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07, 102.91,
    106.42, 107.87, 112.41, 114.82, 118.71, 121.76, 127.60, 126.90, 131.29,
    132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36, 151.96,
    157.25, 158.93, 162.50, 164.93, 167.26, 168.93, 173.05, 174.97, 178.49,
    180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97, 200.59, 204.38,
    207.2, 208.98, 209.0,
]

# Covalent radii (Angstrom, Cordero 2008 single-bond values; fallback 1.5).
_COVALENT = {
    1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 11: 1.66,
    12: 1.41, 14: 1.11, 15: 1.07, 16: 1.05, 17: 1.02, 19: 2.03, 20: 1.76,
    25: 1.39, 26: 1.32, 27: 1.26, 28: 1.24, 29: 1.32, 30: 1.22, 33: 1.19,
    34: 1.20, 35: 1.20, 44: 1.46, 45: 1.42, 46: 1.39, 47: 1.45, 48: 1.44,
    50: 1.39, 51: 1.39, 53: 1.39, 78: 1.36, 79: 1.36, 80: 1.32, 82: 1.46,
}

# Van der Waals radii (Bondi / reference symbol_radius.json family).
_VDW = {
    1: 1.20, 6: 1.70, 7: 1.55, 8: 1.52, 9: 1.47, 12: 1.73, 14: 2.10,
    15: 1.80, 16: 1.80, 17: 1.75, 19: 2.75, 20: 2.31, 26: 2.05, 29: 1.40,
    30: 1.39, 34: 1.90, 35: 1.85, 53: 1.98,
}

# Pauling electronegativities (for simple charge/polarity heuristics).
_ELECTRONEG = {
    1: 2.20, 5: 2.04, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98, 14: 1.90,
    15: 2.19, 16: 2.58, 17: 3.16, 34: 2.55, 35: 2.96, 53: 2.66,
}


def covalent_radius(z: int) -> float:
    return _COVALENT.get(z, 1.5)


def vdw_radius(z: int) -> float:
    return _VDW.get(z, 1.8)


def electronegativity(z: int) -> float:
    return _ELECTRONEG.get(z, 2.2)


def atomic_number(symbol: str) -> int:
    s = symbol.strip()
    if s in ATOMIC_NUMBER:
        return ATOMIC_NUMBER[s]
    s = s.capitalize()
    if s in ATOMIC_NUMBER:
        return ATOMIC_NUMBER[s]
    raise KeyError(f"unknown element symbol {symbol!r}")


def atomic_weight(z: int) -> float:
    return ATOMIC_WEIGHT[z] if z < len(ATOMIC_WEIGHT) else 210.0
