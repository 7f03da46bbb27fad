"""Synthesize a protein-ligand corpus from one protein (counterpart of
``tools/gen_corpus_complexes.py``), entirely on the host:

  drug SMILES (chem/drug_corpus, grown by chem/ligand_expand)
    -> 3D conformer (chem/embed3d distance geometry)
    -> placed at a sampled surface site of the protein
    -> pose-refined by the native docking engine (dock/)
    -> written as <outdir>/<ligand>_s<site>_<i>_ligand.sdf + index.txt

Follow with the ETL:
  python -m singa_tpu_torch.tools.make_dataset --index <outdir>/index.txt \
      --outdir data/corpus --bucket large

Sites are diverse surface points (outward offsets from residue centers,
greedy max-min selection), so every complex has a distinct pocket despite
the single source protein. The split holds out whole drug families
(``ligand_disjoint_split``).

Run: python -m singa_tpu_torch.tools.gen_corpus_complexes --protein P.pdb \
         [--count 512] [--outdir data/corpus_raw] [--no-dock]

Unlike the JAX package there is no fallback to raw placements: a docking
library that cannot be built raises, and ``--no-dock`` is the only way to
skip the pose refinement.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from singa_tpu_torch.chem.drug_corpus import CORPUS
from singa_tpu_torch.chem.embed3d import embed_smiles
from singa_tpu_torch.chem.ligand_expand import expand_corpus, ligand_disjoint_split
from singa_tpu_torch.chem.pdb import PDBProtein
from singa_tpu_torch.chem.sdf import write_sdf
from singa_tpu_torch.cpp import vina
from singa_tpu_torch.dock import dock


def surface_sites(prot: PDBProtein, n_sites: int, seed: int = 0) -> np.ndarray:
    """Diverse pocket centers: residue centers pushed outward along the
    local-density gradient, filtered to surface-adjacent points, then a
    greedy max-min subset for diversity."""
    pos = np.asarray([a.pos for a in prot.atoms], np.float64)
    res_centers = np.asarray([pos[list(r.atom_indices)].mean(axis=0) for r in prot.residues])

    cands = []
    for c in res_centers:
        d = np.linalg.norm(pos - c, axis=1)
        nb = pos[d < 8.0]
        if len(nb) < 5:
            continue
        out_dir = c - nb.mean(axis=0)
        nrm = np.linalg.norm(out_dir)
        if nrm < 1e-3:
            continue
        site = c + out_dir / nrm * 5.0
        ds = np.linalg.norm(pos - site, axis=1)
        # surface pocket: not buried, but enough protein around for edges
        if ds.min() > 2.5 and (ds < 10.0).sum() >= 60:
            cands.append(site)
    cands = np.asarray(cands)
    if len(cands) == 0:
        raise RuntimeError("no surface sites found")

    rng = np.random.default_rng(seed)
    picked = [int(rng.integers(len(cands)))]
    d2 = np.linalg.norm(cands - cands[picked[0]], axis=1)
    while len(picked) < min(n_sites, len(cands)):
        nxt = int(np.argmax(d2))
        picked.append(nxt)
        d2 = np.minimum(d2, np.linalg.norm(cands - cands[nxt], axis=1))
    return cands[picked]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=512)
    ap.add_argument("--protein", required=True, help="the source protein's PDB file")
    ap.add_argument("--outdir", default="data/corpus_raw")
    ap.add_argument("--sites", type=int, default=8)
    ap.add_argument("--exhaustiveness", type=int, default=2)
    ap.add_argument(
        "--val-frac", type=float, default=0.12,
        help="fraction of base DRUG FAMILIES held out: every variant and "
        "every site of a held-out drug goes to val (ligand-disjoint split)",
    )
    ap.add_argument(
        "--ligands", type=int, default=450,
        help="expand the ~150-drug corpus to this many unique ligands by "
        "substituent enumeration (chem/ligand_expand); 0 = base drugs only",
    )
    ap.add_argument("--no-dock", action="store_true", help="skip pose refinement")
    args = ap.parse_args(argv)

    if not args.no_dock:
        vina.build()  # a missing or broken compiler stops the run here
    os.makedirs(args.outdir, exist_ok=True)
    prot = PDBProtein(args.protein)
    sites = surface_sites(prot, args.sites)
    print(f"{len(sites)} surface sites on {os.path.basename(args.protein)}")

    pos_all = np.asarray([a.pos for a in prot.atoms], np.float64)
    index_lines = []
    ligands = expand_corpus(args.ligands, seed=7) if args.ligands else [
        (n, s, n) for n, s in CORPUS]
    split_map = ligand_disjoint_split(ligands, val_frac=args.val_frac, seed=7)
    n_drugs = len(ligands)
    print(
        f"{n_drugs} unique ligands "
        f"({sum(1 for _, _, b in ligands if split_map[b] == 'val')} in held-out "
        f"families / {sum(1 for v in split_map.values() if v == 'val')} of "
        f"{len(split_map)} base drugs -> val)"
    )
    rng = np.random.default_rng(7)
    t0 = time.time()
    made = 0
    i = 0
    while made < args.count and i < args.count * 2:
        name, smi, base_drug = ligands[i % n_drugs]
        site = sites[(i // n_drugs) % len(sites)]
        seed = i
        i += 1
        tag = f"{name}_s{(seed // n_drugs) % len(sites)}_{seed}"
        try:
            mol = embed_smiles(smi, seed=seed)
        except (ValueError, RecursionError, IndexError) as e:  # an unparsable SMILES
            print(f"skip {tag}: {type(e).__name__}: {e}")
            continue
        if mol.num_atoms < 4:
            continue
        # random orientation, centered at the site
        q = rng.standard_normal((3, 3))
        u, _, vt = np.linalg.svd(q)
        R = u @ vt
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        mol.pos = (mol.pos - mol.pos.mean(axis=0)) @ R.astype(np.float32).T + site.astype(
            np.float32)
        if not args.no_dock:
            # pocket = protein atoms near the site (keeps the C++ pair
            # loops small); box around the site
            idx = np.where(np.linalg.norm(pos_all - site, axis=1) < 14.0)[0]
            res = dock(prot.to_molecule(idx), mol, center=site, box_size=16.0,
                       exhaustiveness=args.exhaustiveness, seed=seed, max_poses=1)
            if res:
                mol.pos = res[0].pos.astype(np.float32)
        sdf_path = os.path.join(args.outdir, f"{tag}_ligand.sdf")
        with open(sdf_path, "w") as f:
            f.write(write_sdf(mol, name=tag))
        split = split_map[base_drug]  # ligand-disjoint: whole drug families
        index_lines.append(f"{os.path.abspath(args.protein)} {os.path.abspath(sdf_path)} {split}")
        made += 1
        if made % 32 == 0:
            dt = time.time() - t0
            print(f"{made}/{args.count} complexes ({dt:.0f}s, {dt / made:.2f}s each)")

    with open(os.path.join(args.outdir, "index.txt"), "w") as f:
        f.write("\n".join(index_lines) + "\n")
    n_val = sum(1 for ln in index_lines if ln.endswith(" val"))
    print(f"wrote {made} complexes ({made - n_val} train / {n_val} val) "
          f"-> {args.outdir}/index.txt in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
