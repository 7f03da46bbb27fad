"""ctypes front end of the native pose search ``cpp/src/vina_dock.cc``
(counterpart of ``singa_tpu/dock/engine.py``).

High-level API::

    from singa_tpu_torch.dock import dock
    poses = dock(pocket, ligand, exhaustiveness=8)
    poses[0].score, poses[0].pos  # best pose

An in-process, seedable, threaded search in place of the reference's
subprocess into the vendored AutoDock Vina binary (MakeGraph.py:103-111).
The library loads (and builds, at the first call) through
``cpp/vina.py``; a failed build raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from singa_tpu_torch.chem.mol import Molecule
from singa_tpu_torch.chem.properties import rotatable_bonds
from singa_tpu_torch.cpp import vina as _vina
from singa_tpu_torch.cpp.vina import dptr, f64, i32, iptr
from singa_tpu_torch.dock.tree import TorsionTree, interacting_pairs, torsion_tree


class DockResult(NamedTuple):
    score: float  # Vina affinity estimate (kcal/mol scale)
    pos: np.ndarray  # [N, 3] docked ligand coordinates


def _tree_arrays(tree: TorsionTree, pairs: np.ndarray):
    return i32(tree.axes), i32(tree.move_offsets), i32(tree.move_atoms), i32(pairs)


def conf_energy(
    ligand: Molecule,
    pocket: Molecule,
    x: np.ndarray,
    tree: TorsionTree | None = None,
    pairs: np.ndarray | None = None,
) -> tuple[float, np.ndarray]:
    """e_inter + e_intra of the conformation at dof vector ``x``
    ([cx, cy, cz, rx, ry, rz, torsions...]); returns (energy, coords)."""
    tree = tree or torsion_tree(ligand)
    pairs = interacting_pairs(ligand, tree) if pairs is None else pairs
    lt, rt = _vina.xs_types(ligand), _vina.xs_types(pocket)
    n = ligand.num_atoms
    out = np.zeros((n, 3), np.float64)
    lig, rec, xv = f64(ligand.pos), f64(pocket.pos), f64(x)
    if xv.shape != (6 + len(tree.axes),):
        raise ValueError(f"dof vector of shape {xv.shape}; the tree has {len(tree.axes)} torsions")
    axes, offs, moves, pr = _tree_arrays(tree, pairs)
    e = _vina._lib().vina_conf_energy(
        dptr(lig), iptr(lt), n, dptr(rec), iptr(rt), pocket.num_atoms,
        len(tree.axes), iptr(axes), iptr(offs), iptr(moves), len(pr), iptr(pr),
        dptr(xv), dptr(out),
    )
    return float(e), out


def dock(
    pocket: Molecule,
    ligand: Molecule,
    center: np.ndarray | None = None,
    box_size: float | np.ndarray = 22.0,
    exhaustiveness: int = 8,
    n_steps: int | None = None,
    seed: int = 0,
    max_poses: int = 9,
    rmsd_thresh: float = 2.0,
) -> list[DockResult]:
    """Search ligand poses in the pocket; returns poses best-first.

    ``center`` defaults to the ligand's input centroid (re-docking). The
    step count follows Vina's heuristic scaling in the dof count.
    """
    tree = torsion_tree(ligand)
    pairs = interacting_pairs(ligand, tree)
    lt, rt = _vina.xs_types(ligand), _vina.xs_types(pocket)
    n = ligand.num_atoms
    if center is None:
        center = np.asarray(ligand.pos, np.float64).mean(axis=0)
    center = f64(np.asarray(center, np.float64).reshape(3))
    size = f64(np.broadcast_to(np.asarray(box_size, np.float64), (3,)))
    n_tor = len(tree.axes)
    if n_steps is None:
        n_steps = 20 + 6 * (6 + n_tor)  # scaled in dof, Vina-style

    out_xyz = np.zeros((max_poses, n, 3), np.float64)
    out_score = np.zeros(max_poses, np.float64)
    lig, rec = f64(ligand.pos), f64(pocket.pos)
    axes, offs, moves, pr = _tree_arrays(tree, pairs)
    k = _vina._lib().vina_dock(
        dptr(lig), iptr(lt), n, dptr(rec), iptr(rt), pocket.num_atoms,
        n_tor, iptr(axes), iptr(offs), iptr(moves), len(pr), iptr(pr),
        dptr(center), dptr(size),
        int(exhaustiveness), int(n_steps), int(seed),
        rotatable_bonds(ligand), int(max_poses), float(rmsd_thresh),
        dptr(out_xyz), dptr(out_score),
    )
    # clustering picks basin representatives by search energy (inter+intra);
    # report best-affinity-first like the reference binary's output table
    results = [DockResult(float(out_score[i]), out_xyz[i].copy()) for i in range(k)]
    return sorted(results, key=lambda r: r.score)
