"""Host-side chemistry bridge of the adversarial loop (counterpart of
``singa_tpu/train/rewards.py``).

Sampled token sequences are decoded to SMILES, parsed back to molecular
graphs (``chem/smiles_parser``) and scored on the host in numpy; the results
go back to the device as ordinary inputs of the discriminator and generator
updates. Rewards are REINFORCE weights, so no gradient flows through them.

  * ``chem_reward_host`` / ``chem_reward_host_shaped``: [B] rewards, the
    validity gate times the QED / SA terms (the conditioning thresholds of
    reference model/GAN.py:38-40);
  * ``graph_batch_host``: fixed-shape (node features, mask, dense adjacency,
    valid flag) batches for the graph discriminator;
  * ``validity_stats``: validity, uniqueness and property means of a batch.

The docking pass-rate (``vina_conditioning_host``) needs the native Vina
engine, which the port does not have yet (ROADMAP, Queue 1 item 2a).
"""
from __future__ import annotations

import numpy as np

from singa_tpu_torch.chem.featurize import NODE_FEAT_DIM, atom_features
from singa_tpu_torch.chem.properties import qed, sa_score
from singa_tpu_torch.chem.smiles_parser import parse_smiles
from singa_tpu_torch.chem.tokenizer import decode

# conditioning thresholds (reference model/GAN.py:38-40)
QED_GOOD = 0.6
SAS_GOOD = 4.0


def _parse_tokens(tokens: np.ndarray):
    """[B, T] int -> list[Molecule | None] (None = invalid or empty). Only
    what the parser raises for a bad SMILES counts as invalid."""
    mols = []
    for row in np.asarray(tokens):
        try:
            smi = decode(row)
            mols.append(parse_smiles(smi) if smi else None)
        except (ValueError, RecursionError, IndexError):
            mols.append(None)
    return mols


def chem_reward_host(tokens: np.ndarray, w_qed: float = 0.5, w_sas: float = 0.5) -> np.ndarray:
    """[B, T] tokens -> [B] float32 rewards: 0 for an invalid SMILES or one
    of fewer than 3 atoms (the validity gate), else
    1 + w_qed*[QED > 0.6] + w_sas*[SA < 4.0]."""
    out = np.zeros(len(tokens), np.float32)
    for i, mol in enumerate(_parse_tokens(tokens)):
        if mol is None or mol.num_atoms < 3:
            continue
        r = 1.0
        if w_qed:
            r += w_qed * float(qed(mol) > QED_GOOD)
        if w_sas:
            r += w_sas * float(sa_score(mol) < SAS_GOOD)
        out[i] = r
    return out


def chem_reward_host_shaped(tokens: np.ndarray, w_qed: float = 0.5,
                            w_sas: float = 0.5) -> np.ndarray:
    """Dense-gradient form of ``chem_reward_host``: monotone in the property
    below the threshold, equal to the threshold form at it, with a bonus for
    clearing it:

        r = 1 + w_qed*(min(qed/0.6, 1) + [qed > 0.6])/2
              + w_sas*(clip((4-sa)/4, 0, 1) + [sa < 4])/2
    """
    out = np.zeros(len(tokens), np.float32)
    for i, mol in enumerate(_parse_tokens(tokens)):
        if mol is None or mol.num_atoms < 3:
            continue
        q, s = qed(mol), sa_score(mol)
        r = 1.0
        r += w_qed * (min(q / QED_GOOD, 1.0) + float(q > QED_GOOD)) / 2.0
        r += w_sas * (min(max((SAS_GOOD - s) / SAS_GOOD, 0.0), 1.0) + float(s < SAS_GOOD)) / 2.0
        out[i] = r
    return out


def graph_batch_host(tokens: np.ndarray, n_max: int) -> tuple[np.ndarray, ...]:
    """[B, T] tokens -> (x [B, N, 59] f32, mask [B, N] bool, adj [B, N, N]
    f32, valid [B] f32); an invalid molecule, or one of fewer than 3 or more
    than ``n_max`` atoms, gives an empty graph with valid 0."""
    B = len(tokens)
    x = np.zeros((B, n_max, NODE_FEAT_DIM), np.float32)
    mask = np.zeros((B, n_max), bool)
    adj = np.zeros((B, n_max, n_max), np.float32)
    valid = np.zeros((B,), np.float32)
    for i, mol in enumerate(_parse_tokens(tokens)):
        if mol is None or not (3 <= mol.num_atoms <= n_max):
            continue
        n = mol.num_atoms
        x[i, :n] = atom_features(mol)
        mask[i, :n] = True
        for a, b in mol.bonds:
            adj[i, a, b] = adj[i, b, a] = 1.0
        valid[i] = 1.0
    return x, mask, adj, valid


def validity_stats(tokens: np.ndarray) -> dict:
    """%valid, %unique among the valid, QED and SA means, and the shares of
    ALL generated molecules that meet the conditioning thresholds
    (``pct_qed_good``, ``pct_sas_good``, both: ``pct_cond``; an invalid
    molecule counts as a failure)."""
    mols = _parse_tokens(tokens)
    smiles = [decode(r) for r in np.asarray(tokens)]
    valid = [s for s, m in zip(smiles, mols) if m is not None and m.num_atoms >= 3]
    stats = {
        "n": len(smiles),
        "pct_valid": 100.0 * len(valid) / max(1, len(smiles)),
        "pct_unique": 100.0 * len(set(valid)) / max(1, len(valid)) if valid else 0.0,
    }
    scored = [m for m in mols if m is not None and m.num_atoms >= 3]
    n_all = max(1, len(smiles))
    qed_ok = sas_ok = both_ok = 0
    if scored:
        qs = [qed(m) for m in scored]
        ss = [sa_score(m) for m in scored]
        stats["qed_mean"] = float(np.mean(qs))
        stats["sas_mean"] = float(np.mean(ss))
        qed_ok = sum(q > QED_GOOD for q in qs)
        sas_ok = sum(s < SAS_GOOD for s in ss)
        both_ok = sum((q > QED_GOOD) and (s < SAS_GOOD) for q, s in zip(qs, ss))
    stats["pct_qed_good"] = 100.0 * qed_ok / n_all
    stats["pct_sas_good"] = 100.0 * sas_ok / n_all
    stats["pct_cond"] = 100.0 * both_ok / n_all
    return stats
