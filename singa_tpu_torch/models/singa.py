"""SINGA: the property-conditioned pocket-to-SMILES generator (counterpart
of ``singa_tpu/models/singa.py``; reference model/GAN.py), generation path.
"""
from __future__ import annotations

import torch
from torch import nn

from singa_tpu_torch.config import PAD_TOKEN, Config
from singa_tpu_torch.data.batch import ComplexBatch
from singa_tpu_torch.equivariant.embedding import EquivariantEmbedding
from singa_tpu_torch.models.cpromg import CProMGTransformer, DecodeCache

# Property-conditioning thresholds (reference GAN.py:37-44)
VINA_GOOD = -7.5
QED_GOOD = 0.6
SAS_GOOD = 4.0


def binarize_props(batch: ComplexBatch, props: tuple[str, ...]) -> torch.Tensor:
    """Binary 'is-good' conditioning vector [B, P] (GAN.py:37-44)."""
    table = {
        "vina_score": batch.props.vina < VINA_GOOD,
        "qed": batch.props.qed > QED_GOOD,
        "sas": batch.props.sas < SAS_GOOD,
        "logP": batch.props.logp,
        "weight": batch.props.weight,
        "tpsa": batch.props.tpsa,
    }
    return torch.stack([table[p].to(torch.float32) for p in props], dim=-1)


class SINGA(nn.Module):
    """Equivariant embedding + CProMG transformer. Built on ``device`` (CUDA
    unless the caller asks for the CPU) and initialised from ``seed``."""

    def __init__(self, config: Config, device="cuda", seed: int = 0):
        super().__init__()
        from singa_tpu_torch.params import seeded_init

        self.config = config
        self.embedding = EquivariantEmbedding(config.embedding, device)
        self.model = CProMGTransformer(config.model, PAD_TOKEN, device)
        seeded_init(self, seed)

    def encode_pocket(self, batch: ComplexBatch):
        """Protein-only path for generation (gen_mode; reference
        gen.py:157-160 + BeamSearch.py:64-76). Returns (encoding [B, Np, C],
        pad mask [B, 1, Np])."""
        B = batch.batch_size
        emb = self.embedding(batch, gen_mode=True)
        feat = emb.protein.reshape(B, -1, self.config.model.featurizer_feat_dim)
        enc, pad, _ = self.model.encode(
            feat, batch.protein.pos, batch.protein.mask, batch.protein.lap_pe
        )
        return enc, pad

    def prime_cache(self, enc, enc_pad_mask, prop) -> DecodeCache:
        """A decoder KV cache with the property prefix written."""
        return self.model.prime_cache(enc, enc_pad_mask, prop)

    def decode_token(self, token, pos: int, cache: DecodeCache) -> torch.Tensor:
        """KV-cached one-token decode -> next-token logits [R, V]."""
        return self.model.decode_token(token, pos, cache)
