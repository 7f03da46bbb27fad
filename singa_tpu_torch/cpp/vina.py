"""ctypes bindings for the native Vina scoring and docking library
(counterpart of ``singa_tpu/cpp/vina.py``).

The library is built from this package's own copy of the C++ sources
(``cpp/src``: the Vina potential, rigid-pose scoring and the pose search) with
the JAX package's ``g++`` command line, at first use, into
``build/vina/`` at the root of the checkout, named by a hash of the sources
and the flags: a changed source is a new library, never a stale one. A build
that fails raises; no caller gets a placeholder score. Importing this module
builds nothing.

Everything here runs on the host: scoring and docking are branchy pair loops
over a few hundred atoms, which the JAX package also keeps in C++.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from singa_tpu_torch.chem.mol import Molecule
from singa_tpu_torch.chem.properties import rotatable_bonds

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SOURCES = ("vina_score.cc", "vina_dock.cc")
_HEADERS = ("vina_common.h",)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "vina")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
_LIB = None

# XS type ids (keep in sync with src/vina_score.cc)
C_H, C_P = 0, 1
N_P, N_D, N_A, N_DA = 2, 3, 4, 5
O_P, O_D, O_A, O_DA = 6, 7, 8, 9
S_T, P_T = 10, 11
F_H, CL_H, BR_H, I_H = 12, 13, 14, 15
MET_D, OTHER = 16, 17

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)


def lib_path() -> str:
    """Where the library of these sources and flags lives."""
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_SRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvina_score-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is already built; returns its path.
    Raises RuntimeError when the compiler is missing or fails."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp] + [os.path.join(_SRC, s) for s in _SOURCES]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {CXX!r} for the Vina library: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building the Vina library failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def _lib():
    """The loaded library (built at the first call), every entry point typed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.vina_score.restype = ctypes.c_double
        lib.vina_score.argtypes = [_DP, _IP, ctypes.c_int, _DP, _IP, ctypes.c_int, ctypes.c_int]
        lib.vina_score_batch.restype = None
        lib.vina_score_batch.argtypes = [_DP, _IP, _IP, _IP, ctypes.c_int, _DP, _IP,
                                         ctypes.c_int, _DP]
        lib.vina_terms.restype = None
        lib.vina_terms.argtypes = [_DP, _IP, ctypes.c_int, _DP, _IP, ctypes.c_int, _DP]
        lib.vina_dock.restype = ctypes.c_int
        lib.vina_dock.argtypes = [
            _DP, _IP, ctypes.c_int,          # ligand
            _DP, _IP, ctypes.c_int,          # receptor
            ctypes.c_int, _IP, _IP, _IP,     # torsion tree
            ctypes.c_int, _IP,               # intra pairs
            _DP, _DP,                        # box center/size
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double,   # max_poses, rmsd
            _DP, _DP,                        # out xyz / score
        ]
        lib.vina_conf_energy.restype = ctypes.c_double
        lib.vina_conf_energy.argtypes = [
            _DP, _IP, ctypes.c_int, _DP, _IP, ctypes.c_int,
            ctypes.c_int, _IP, _IP, _IP, ctypes.c_int, _IP, _DP, _DP,
        ]
        _LIB = lib
    return _LIB


def f64(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float64)


def i32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int32)


def dptr(a: np.ndarray):
    """Pointer to a float64 array the caller keeps alive across the call."""
    assert a.dtype == np.float64 and a.flags.c_contiguous
    return a.ctypes.data_as(_DP)


def iptr(a: np.ndarray):
    """Pointer to an int32 array the caller keeps alive across the call."""
    assert a.dtype == np.int32 and a.flags.c_contiguous
    return a.ctypes.data_as(_IP)


def xs_types(mol: Molecule) -> np.ndarray:
    """Map our perceived atom classes to the XS scoring types."""
    n = mol.num_atoms
    out = np.full(n, OTHER, np.int32)
    don = mol.is_donor
    acc = mol.is_acceptor
    hyd = mol.is_hydrophobe
    for a in range(n):
        z = int(mol.atomic_num[a])
        if z == 6:
            out[a] = C_H if hyd[a] else C_P
        elif z == 7:
            out[a] = (N_DA if acc[a] else N_D) if don[a] else (N_A if acc[a] else N_P)
        elif z == 8:
            out[a] = (O_DA if acc[a] else O_D) if don[a] else (O_A if acc[a] else O_P)
        elif z == 16:
            out[a] = S_T
        elif z == 15:
            out[a] = P_T
        elif z == 9:
            out[a] = F_H
        elif z == 17:
            out[a] = CL_H
        elif z == 35:
            out[a] = BR_H
        elif z == 53:
            out[a] = I_H
        elif z in (12, 20, 25, 26, 30):
            out[a] = MET_D
    return out


def score_pose(
    lig_pos: np.ndarray,
    lig_types: np.ndarray,
    rec_pos: np.ndarray,
    rec_types: np.ndarray,
    n_rot: int,
) -> float:
    lib = _lib()
    lp, rp, lt, rt = f64(lig_pos), f64(rec_pos), i32(lig_types), i32(rec_types)
    return float(lib.vina_score(dptr(lp), iptr(lt), len(lt), dptr(rp), iptr(rt), len(rt),
                                int(n_rot)))


def score_complex(pocket: Molecule, ligand: Molecule) -> float:
    """Affinity estimate (kcal/mol-scale) for the given pose."""
    return score_pose(
        ligand.pos, xs_types(ligand), pocket.pos, xs_types(pocket),
        rotatable_bonds(ligand),
    )


def score_terms(pocket: Molecule, ligand: Molecule) -> np.ndarray:
    """Unweighted (gauss1, gauss2, repulsion, hydrophobic, hbond) sums."""
    lib = _lib()
    out = np.zeros(5, np.float64)
    lp, rp = f64(ligand.pos), f64(pocket.pos)
    lt, rt = xs_types(ligand), xs_types(pocket)
    lib.vina_terms(dptr(lp), iptr(lt), len(lt), dptr(rp), iptr(rt), len(rt), dptr(out))
    return out


def score_batch(
    ligands: list[tuple[np.ndarray, np.ndarray, int]],
    rec_pos: np.ndarray,
    rec_types: np.ndarray,
) -> np.ndarray:
    """Score many (pos, types, n_rot) ligands against one receptor."""
    lib = _lib()
    offsets = np.zeros(len(ligands) + 1, np.int32)
    for i, (pos, _, _) in enumerate(ligands):
        offsets[i + 1] = offsets[i] + len(pos)
    all_pos = f64(np.concatenate([np.asarray(p, np.float64) for p, _, _ in ligands]))
    all_types = i32(np.concatenate([np.asarray(t, np.int32) for _, t, _ in ligands]))
    nrot = np.asarray([r for _, _, r in ligands], np.int32)
    out = np.zeros(len(ligands), np.float64)
    rp, rt = f64(rec_pos), i32(rec_types)
    lib.vina_score_batch(
        dptr(all_pos), iptr(all_types), iptr(offsets), iptr(nrot), len(ligands),
        dptr(rp), iptr(rt), len(rt), dptr(out),
    )
    return out
