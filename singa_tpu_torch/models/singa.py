"""SINGA: the property-conditioned pocket-to-SMILES generator (counterpart
of ``singa_tpu/models/singa.py``; reference model/GAN.py): the training
forward, the token cross-entropy and the generation path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
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

    def forward(self, batch: ComplexBatch) -> torch.Tensor:
        """Teacher-forced next-token logits [B, tgt_len, vocab]: both
        embedding stages, encoder 1 on the pocket, Encoder2 on the ligand,
        the property-prefixed decoder."""
        cfg = self.config
        B = batch.batch_size
        fd = cfg.model.featurizer_feat_dim
        prop = binarize_props(batch, cfg.model.props) if cfg.model.num_props else None
        emb = self.embedding(batch)
        return self.model(
            emb.protein.reshape(B, -1, fd), batch.protein.pos, batch.protein.mask,
            batch.protein.lap_pe, batch.tokens.input,
            emb.ligand.reshape(B, -1, fd), batch.ligand.pos, batch.ligand.mask,
            batch.ligand.lap_pe, prop,
        )

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

    def decode_step(self, tokens, enc, enc_pad_mask, prop) -> torch.Tensor:
        """Teacher-forced decode of tokens [B, T] from an encoding ->
        next-token logits [B, T, V] (the GAN's log-probs of sampled
        sequences)."""
        return self.model.decode(tokens, enc, enc_pad_mask, prop)

    def prime_cache(self, enc, enc_pad_mask, prop) -> DecodeCache:
        """A decoder KV cache with the property prefix written."""
        return self.model.prime_cache(enc, enc_pad_mask, prop)

    def decode_token(self, token, pos: int, cache: DecodeCache) -> torch.Tensor:
        """KV-cached one-token decode -> next-token logits [R, V]."""
        return self.model.decode_token(token, pos, cache)


def cross_entropy_loss(
    logits: torch.Tensor, targets: torch.Tensor, mask_pad: bool = False, pad_token: int = PAD_TOKEN
) -> torch.Tensor:
    """Token cross-entropy. The reference averages over all positions,
    padding targets included (train.py:106,123, no ignore_index);
    ``mask_pad=False`` keeps that."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask_pad:
        w = (targets != pad_token).to(torch.float32)
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    return nll.mean()
