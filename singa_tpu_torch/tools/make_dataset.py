"""Dataset ETL: (protein.pdb, ligand.sdf) complexes -> fixed-shape ``.npz``
shards (counterpart of ``tools/make_dataset.py``).

Pocket extraction, featurization, interaction edges, property labels
(QED/logP/TPSA/SA/weight from ``chem/properties``, the Vina affinity from the
native scorer ``cpp/vina.py``), SMILES tokens and Laplacian PEs, all
precomputed on the host. The shards are what ``load_npz`` and ``NpzDataset``
read, and what ``generate --input shard.npz`` serves.

Input layouts:
  * --index FILE: lines "protein.pdb ligand.sdf [split]"
  * --scan DIR: pairs "<name>_protein.pdb" / "<name>_ligand.sdf"

Run: python -m singa_tpu_torch.tools.make_dataset --index index.txt \
         --outdir data/processed [--bucket large] [--pocket-radius 10]

Unlike the JAX package, a Vina label is never a silent 0.0: the scorer's
library is built before the first complex, and a build that fails raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import traceback

import numpy as np

from singa_tpu_torch.chem.interactions import ProteinContext
from singa_tpu_torch.chem.pdb import PDBProtein
from singa_tpu_torch.chem.properties import all_properties
from singa_tpu_torch.chem.sdf import parse_sdf
from singa_tpu_torch.chem.smiles_writer import write_smiles
from singa_tpu_torch.config import Config, load_config
from singa_tpu_torch.cpp import vina
from singa_tpu_torch.data.complex_builder import BucketOverflow, build_complex
from singa_tpu_torch.data.dataset import save_complex


def vina_score(pocket, ligand) -> float:
    """Affinity label from the native scorer; raises if it cannot be built."""
    return float(vina.score_complex(pocket, ligand))


def process_one(protein_pdb: str, ligand_sdf: str, out_path: str, cfg: Config,
                pocket_radius: float = 10.0) -> str | None:
    """Featurize one complex into ``out_path``; returns why it was skipped,
    or None when it was written."""
    prot = PDBProtein(protein_pdb)
    ligand = parse_sdf(ligand_sdf)
    residues = prot.query_residues_ligand(ligand.pos, pocket_radius)
    idx = np.array([i for r in residues for i in r.atom_indices], np.int64)
    if len(idx) == 0:
        return "empty pocket"
    pocket = prot.to_molecule(idx)
    ctx = ProteinContext(
        res_name=np.array([prot.atoms[i].res_name for i in idx]),
        atom_name=np.array([prot.atoms[i].name for i in idx]),
        res_id=np.array(
            [hash((prot.atoms[i].chain, prot.atoms[i].res_seq)) % (1 << 31) for i in idx]
        ),
    )
    props = all_properties(ligand)
    props["vina"] = vina_score(pocket, ligand)
    sample = build_complex(
        pocket, ligand, ctx, cfg.shapes, cfg.model.decoder.tgt_len,
        smiles=write_smiles(ligand), props=props,
    )
    save_complex(out_path, sample)
    return None


def read_pairs(index: str | None, scan: str | None, split: str) -> list[tuple[str, str, str]]:
    """(protein, ligand, split) triples from an index file or a directory."""
    pairs = []
    if index:
        with open(index) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                pairs.append((parts[0], parts[1], parts[2] if len(parts) > 2 else split))
    else:
        for f in sorted(os.listdir(scan)):
            if f.endswith("_protein.pdb"):
                lig = os.path.join(scan, f[: -len("_protein.pdb")] + "_ligand.sdf")
                if os.path.exists(lig):
                    pairs.append((os.path.join(scan, f), lig, split))
    return pairs


def main(argv=None) -> list[str]:
    """Returns the paths of the shards written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", type=str, default=None)
    ap.add_argument("--scan", type=str, default=None)
    ap.add_argument("--outdir", type=str, required=True)
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--split", type=str, default="train")
    ap.add_argument("--pocket-radius", type=float, default=10.0)
    ap.add_argument(
        "--bucket", choices=["default", "large"], default="default",
        help="'large' = (576 protein nodes, 1280 pp edges): with the "
        "reference's 10 A pocket radius, many real pockets overflow the "
        "default 384-node bucket",
    )
    args = ap.parse_args(argv)
    if not (args.index or args.scan):
        ap.error("need --index or --scan")

    cfg = load_config(args.config) if args.config else Config()
    if args.bucket == "large":
        cfg = dataclasses.replace(cfg, shapes=dataclasses.replace(
            cfg.shapes, num_protein_nodes=576, num_pp_edges=1280))
    vina.build()  # a missing or broken compiler stops the ETL here

    pairs = read_pairs(args.index, args.scan, args.split)
    written, skipped = [], []
    for p_pdb, l_sdf, split in pairs:
        # name by the LIGAND file: an index may pair many ligands with one
        # protein (tools/gen_corpus_complexes.py); for --scan pairs the
        # ligand prefix equals the protein prefix
        name = os.path.basename(l_sdf).replace("_ligand.sdf", "").replace(".sdf", "")
        outdir = os.path.join(args.outdir, split)
        os.makedirs(outdir, exist_ok=True)
        out = os.path.join(outdir, name + ".npz")
        try:
            err = process_one(p_pdb, l_sdf, out, cfg, args.pocket_radius)
        except BucketOverflow as e:
            err = f"bucket overflow: {e}"
        except (OSError, ValueError, IndexError, KeyError) as e:  # an unreadable input
            err = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        if err:
            skipped.append((name, err))
        else:
            written.append(out)
            print(f"ok {name}")
    print(f"done: {len(written)} ok, {len(skipped)} skipped")
    for name, why in skipped:
        print(f"  skipped {name}: {why}")
    return written


if __name__ == "__main__":
    main()
