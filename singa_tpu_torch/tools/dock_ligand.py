"""Re-dock a ligand into its pocket with the native search engine
(counterpart of ``tools/dock_ligand.py``), fully in-process on the host:

    python -m singa_tpu_torch.tools.dock_ligand PROTEIN.pdb LIGAND.sdf \
        [--exhaustiveness 8] [--steps N] [--seed 0] [--poses 9] \
        [--radius 10] [--box 22] [--out poses.sdf]

Prints a Vina-style result table (mode, affinity, RMSD from the input pose)
and optionally writes the docked poses as a multi-molecule SDF
(``chem/sdf.py::write_sdf``, which ``parse_sdf`` reads back).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from singa_tpu_torch.chem.pdb import PDBProtein
from singa_tpu_torch.chem.sdf import parse_sdf, write_sdf
from singa_tpu_torch.cpp.vina import score_complex
from singa_tpu_torch.dock import dock, torsion_tree


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((np.asarray(a, np.float64) - b) ** 2, axis=-1))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("protein")
    ap.add_argument("ligand")
    ap.add_argument("--exhaustiveness", type=int, default=8)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--poses", type=int, default=9)
    ap.add_argument("--radius", type=float, default=10.0)
    ap.add_argument("--box", type=float, default=22.0)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    lig = parse_sdf(args.ligand)
    pocket, _ = PDBProtein(args.protein).pocket(lig.pos, radius=args.radius)
    tree = torsion_tree(lig)
    print(
        f"ligand: {lig.num_atoms} atoms, {len(tree.axes)} torsions; "
        f"pocket: {pocket.num_atoms} atoms (r={args.radius} A)",
        file=sys.stderr,
    )
    print(f"input-pose affinity: {score_complex(pocket, lig):8.3f}", file=sys.stderr)

    t0 = time.perf_counter()
    poses = dock(
        pocket, lig,
        box_size=args.box, exhaustiveness=args.exhaustiveness,
        n_steps=args.steps, seed=args.seed, max_poses=args.poses,
    )
    print(f"search: {time.perf_counter() - t0:.3f}s ({args.exhaustiveness} runs)",
          file=sys.stderr)

    print("mode |  affinity  | rmsd from input")
    print("-----+------------+----------------")
    ref = np.asarray(lig.pos, np.float64)
    for i, p in enumerate(poses, 1):
        print(f"{i:4d} | {p.score:10.3f} | {rmsd(p.pos, ref):10.2f}")

    if args.out:
        with open(args.out, "w") as f:
            for i, p in enumerate(poses, 1):
                f.write(write_sdf(lig, name=f"pose_{i}_score_{p.score:.3f}", pos=p.pos))
        print(f"wrote {len(poses)} poses to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
