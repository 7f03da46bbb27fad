"""Generation pipeline: weights -> pocket batch -> beam search -> SMILES CSV
(counterpart of ``singa_tpu/generate/generate.py``; reference gen.py).

CLI: python -m singa_tpu_torch.generate.generate --checkpoint weights.pt \
       --input pocket.pdb [--ligand ligand.sdf] [--props] --output out.csv

``--checkpoint`` is either a ``.pt`` file holding the port's state dict or
the checkpoint directory of the port's trainer or GAN
(``<logdir>/checkpoints`` or ``<logdir>``; its latest step is read).
Without ``--config``, the ``config.yml`` in ``<logdir>`` is used when there
is one (the trainer and the GAN write it). The
input is a protein PDB, featurized on the host by ``data/complex_builder``
(with ``--ligand``, the residues within 10 A of the ligand's atoms are the
pocket; without, the whole PDB is), or an ETL ``.npz`` complex. ``--props``
adds the validity, QED, SA, logP and TPSA columns (``chem/properties``).
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os

import numpy as np
import torch

from singa_tpu_torch.chem.properties import logp, qed, sa_score, tpsa
from singa_tpu_torch.chem.smiles_parser import parse_smiles
from singa_tpu_torch.chem.tokenizer import decode as detokenize
from singa_tpu_torch.config import Config, load_config
from singa_tpu_torch.data.batch import ComplexBatch, load_npz
from singa_tpu_torch.data.complex_builder import build_from_files
from singa_tpu_torch.generate.beam import beam_generate
from singa_tpu_torch.models.singa import SINGA, binarize_props
from singa_tpu_torch.train.checkpointing import CheckpointManager


@torch.inference_mode()
def generate_for_pocket(model: SINGA, batch: ComplexBatch, cfg: Config, prop_target=None):
    """Returns (smiles list, scores [B*topk]) for one pocket batch, which must
    be on the model's device."""
    enc, pad = model.encode_pocket(batch)
    prop = None
    if cfg.model.num_props:
        tgt = prop_target if prop_target is not None else cfg.generate.prop
        prop = torch.as_tensor(
            np.asarray([tgt] * batch.batch_size, np.float32), device=enc.device
        )
    tokens, scores = beam_generate(
        model,
        enc,
        pad,
        prop,
        num_beams=cfg.generate.num_beams,
        max_length=cfg.generate.max_length,
        length_penalty=cfg.generate.length_penalty,
        topk=cfg.generate.topk,
        grammar_mask=cfg.generate.grammar_mask,
        allow_dot=cfg.generate.allow_dot,
    )
    tokens = tokens.cpu().numpy()
    smiles = [
        detokenize(tokens[b, k]) for b in range(tokens.shape[0]) for k in range(tokens.shape[1])
    ]
    return smiles, scores.cpu().numpy().reshape(-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", type=str, required=True,
                    help=".pt file holding the port's SINGA state dict, or the "
                    "checkpoint directory of the trainer or the GAN (<logdir>/checkpoints, "
                    "or <logdir>)")
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--input", type=str, required=True,
                    help="pocket PDB, or a .npz complex from the ETL (exact same "
                    "featurization the checkpoint was trained on)")
    ap.add_argument("--ligand", type=str, default=None,
                    help="ligand SDF locating the pocket (PDB input only)")
    ap.add_argument("--output", type=str, default="generated.csv")
    ap.add_argument("--props", action="store_true",
                    help="add validity/QED/SA/logP/TPSA columns (host chem stack)")
    ap.add_argument(
        "--prop", type=str, default=None,
        help="property prefix override: comma-separated floats (e.g. '0,0,1'), "
        "or 'from-input' to binarize the input complex's own labels",
    )
    ap.add_argument("--no-mask", action="store_true",
                    help="disable SMILES grammar/valence masking during decode")
    ap.add_argument("--allow-dot", action="store_true",
                    help="admit '.' under the grammar mask (multi-fragment outputs)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but CUDA is not available")

    cfg = load_config(args.config) if args.config else Config()
    if os.path.isdir(os.path.join(args.checkpoint, "checkpoints")):  # a run's logdir
        args.checkpoint = os.path.join(args.checkpoint, "checkpoints")
    ckpt_dir = os.path.isdir(args.checkpoint)
    ckpt_cfg_path = os.path.join(
        os.path.dirname(os.path.abspath(args.checkpoint.rstrip("/"))), "config.yml"
    )
    if args.config is None and os.path.exists(ckpt_cfg_path):
        cfg = load_config(ckpt_cfg_path)
    if args.no_mask or args.allow_dot:
        cfg = dataclasses.replace(
            cfg,
            generate=dataclasses.replace(
                cfg.generate,
                grammar_mask=cfg.generate.grammar_mask and not args.no_mask,
                allow_dot=cfg.generate.allow_dot or args.allow_dot,
            ),
        )

    if args.input.endswith(".npz"):
        batch = load_npz([args.input])
    else:
        batch = build_from_files(args.input, args.ligand, cfg.shapes, cfg.model.decoder.tgt_len)
    model = SINGA(cfg, device=device)
    if ckpt_dir:
        if CheckpointManager(args.checkpoint).restore(model) is None:
            raise FileNotFoundError(f"no checkpoint under {args.checkpoint}")
    else:
        model.load_state_dict(torch.load(args.checkpoint, map_location=device, weights_only=True))
    model.eval()

    prop_target = None
    if args.prop == "from-input":
        prop_target = binarize_props(batch, cfg.model.props)[0].tolist()
    elif args.prop:
        prop_target = [float(x) for x in args.prop.split(",")]

    smiles, scores = generate_for_pocket(model, batch.to(device), cfg, prop_target)
    with open(args.output, "w", newline="") as f:
        w = csv.writer(f)
        if not args.props:
            w.writerow(["smiles", "score"])
            for s, sc in zip(smiles, scores):
                w.writerow([s, float(sc)])
        else:
            w.writerow(["smiles", "score", "valid", "qed", "sa", "logp", "tpsa"])
            n_valid = 0
            for s, sc in zip(smiles, scores):
                try:
                    mol = parse_smiles(s)
                    row = [s, float(sc), 1, qed(mol), sa_score(mol), logp(mol), tpsa(mol)]
                    n_valid += 1
                except Exception:
                    row = [s, float(sc), 0, "", "", "", ""]
                w.writerow(row)
            print(f"valid: {n_valid}/{len(smiles)}")
    print(f"wrote {len(smiles)} molecules to {args.output}")


if __name__ == "__main__":
    main()
