"""CProMG-style conditional transformer: the kNN pocket encoder and the
property-prefixed, KV-cached SMILES decoder (counterpart of
``singa_tpu/models/cpromg.py``; reference CProMG.py).

The generation path only: ``Encoder`` (neighbour-list form), ``Decoder.prime``
/ ``decode_token`` and ``CProMGTransformer.encode`` / ``prime_cache`` /
``decode_token``. ``Encoder2`` and the teacher-forced decoder belong to the
training path and are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from singa_tpu_torch.config import DecoderConfig, EncoderConfig, ModelConfig
from singa_tpu_torch.equivariant.layers import Embed, Linear, layer_norm


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - math.log(2.0)


class EdgeMLP(nn.Module):
    """edge_channels -> hidden -> hidden with ShiftedSoftplus (CProMG.py:31-43)."""

    def __init__(self, in_features: int, hidden: int, device=None):
        super().__init__()
        self.Linear_0 = Linear(in_features, hidden, device=device)
        self.Linear_1 = Linear(hidden, hidden, device=device)

    def forward(self, e: torch.Tensor) -> torch.Tensor:
        return self.Linear_1(shifted_softplus(self.Linear_0(e)))


class DenseMHA(nn.Module):
    """Dense multi-head attention with residual + post-LN (CProMG.py:81-158)."""

    def __init__(self, model_channels: int, hidden_channels: int, key_channels: int,
                 num_heads: int, device=None):
        super().__init__()
        self.H = num_heads
        self.kd = key_channels // num_heads
        self.vd = hidden_channels // num_heads
        self.W_Q = Linear(model_channels, key_channels, device=device)
        self.W_K = Linear(model_channels, key_channels, device=device)
        self.W_V = Linear(model_channels, hidden_channels, device=device)
        self.linear = Linear(hidden_channels, hidden_channels, device=device)
        self.layer_norm = layer_norm(hidden_channels, device)

    def keys_values(self, kv: torch.Tensor):
        """Per-head keys [B, Tk, H, kd] and values [B, Tk, H, vd] of ``kv``."""
        B = kv.shape[0]
        return (
            self.W_K(kv).reshape(B, -1, self.H, self.kd),
            self.W_V(kv).reshape(B, -1, self.H, self.vd),
        )

    def attend(self, q: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
               blocked: torch.Tensor | None) -> torch.Tensor:
        """q [B, Tq, C] against keys/values; ``blocked`` [B, Tq, Tk] is True
        where a key is masked (score -1e9)."""
        B, Tq, _ = q.shape
        qs = self.W_Q(q).reshape(B, Tq, self.H, self.kd)
        scores = torch.einsum("bqhd,bkhd->bhqk", qs, ks) / math.sqrt(self.kd)
        if blocked is not None:
            scores = torch.where(blocked[:, None], -1e9, scores)
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, vs).reshape(B, Tq, -1)
        return self.layer_norm(self.linear(ctx) + q)


class PositionwiseFFN(nn.Module):
    """1x1-conv FFN with residual + post-LN (CProMG.py:161-191)."""

    def __init__(self, hidden_channels: int, ffn_hidden: int = 1024, device=None):
        super().__init__()
        self.conv1 = Linear(hidden_channels, ffn_hidden, device=device)
        self.conv2 = Linear(ffn_hidden, hidden_channels, device=device)
        self.layer_norm = layer_norm(hidden_channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.conv2(F.relu(self.conv1(x))) + x)


def sinusoidal_pe(length: int, d_model: int) -> np.ndarray:
    """[length, d_model] float32 sinusoidal position table."""
    position = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


class Encoder(nn.Module):
    """Pocket-atom encoder (CProMG.py:276-309), neighbour-list form. The
    layers are a Python loop over ``layers`` (the JAX package's ``nn.scan``
    stack, one module per layer)."""

    def __init__(self, cfg: EncoderConfig, feature_dim: int, device=None):
        super().__init__()
        from singa_tpu_torch.models.neighbor_graph import NeighborEncoderLayer

        if cfg.attn_form != "neighbor":
            raise ValueError(f"encoder form {cfg.attn_form!r} is not ported (only 'neighbor')")
        self.cfg = cfg
        self.protein_atom_emb = Linear(feature_dim, cfg.hidden_channels, device=device)
        self.laplacian_emb = Linear(cfg.lap_dim, cfg.hidden_channels, device=device)
        self.layers = nn.ModuleList(
            NeighborEncoderLayer(cfg, cfg.smear_stop, device)
            for _ in range(cfg.num_interactions)
        )

    def forward(self, feat, pos, mask, lap_pe):
        """Returns (encoding [B, N, C], pad mask [B, 1, N] True = blocked,
        per-layer attention outputs)."""
        from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph

        cfg = self.cfg
        x = self.protein_atom_emb(feat) + self.laplacian_emb(lap_pe)
        g = build_neighbor_graph(pos, mask, cfg.knn, cfg.smear_stop, cfg.edge_channels)
        msas = []
        for layer in self.layers:
            msa, x = layer(x, g)
            msas.append(msa)
        return x * mask[..., None].to(x.dtype), ~mask[:, None, :], msas


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        C = cfg.hidden_channels
        self.dec_self_attn = DenseMHA(C, C, cfg.key_channels, cfg.num_heads, device)
        self.dec_enc_attn = DenseMHA(C, C, cfg.key_channels, cfg.num_heads, device)
        self.pos_ffn = PositionwiseFFN(C, cfg.ffn_hidden, device)


@dataclass
class DecodeCache:
    """KV cache of the decoder for one batch of rows (pockets x beams).

    ``self_k``/``self_v`` hold one [R, tgt_len+1, H, d] tensor per layer,
    written in place at slot ``length`` (slot 0 is the property prefix).
    ``cross_k``/``cross_v`` are the layers' keys and values of the encoder
    output, computed once at priming instead of at every step."""

    self_k: list
    self_v: list
    cross_k: list
    cross_v: list
    cross_blocked: torch.Tensor  # [R, 1, S] True = padded encoder position
    length: int = 0

    def reorder(self, rows: torch.Tensor) -> None:
        """Follow a beam reordering: row r takes the cache of ``rows[r]``.
        Only the written slots move. The cross-attention entries stay: every
        row of one pocket holds the same ones, and beam search only permutes
        rows within a pocket."""
        L = self.length
        for t in self.self_k + self.self_v:
            t[:, :L] = t[:, :L].index_select(0, rows)


class Decoder(nn.Module):
    """Property-prefixed causal SMILES decoder (CProMG.py:371-423),
    incremental KV-cached form (``prime`` + ``decode_token``)."""

    def __init__(self, cfg: DecoderConfig, num_props: int, pad_token: int, device=None):
        super().__init__()
        C = cfg.hidden_channels
        self.cfg = cfg
        self.num_props = num_props
        self.pad_token = pad_token
        self.mol_emb = Embed(cfg.vocab_size, C, device)
        self.type_emb = Embed(2, C, device)
        if num_props:
            self.prop_nn = Linear(num_props, C, device=device)
        for i in range(cfg.num_interactions):
            setattr(self, f"layer_{i}", DecoderLayer(cfg, device))
        self._pe = sinusoidal_pe(cfg.tgt_len, C)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_interactions)]

    def _step(self, x: torch.Tensor, cache: DecodeCache) -> torch.Tensor:
        """Run one new position x [R, 1, C] through every layer, writing its
        keys and values at slot ``cache.length``."""
        idx = cache.length
        for i, layer in enumerate(self.layers()):
            sa = layer.dec_self_attn
            ks, vs = sa.keys_values(x)
            cache.self_k[i][:, idx] = ks[:, 0]
            cache.self_v[i][:, idx] = vs[:, 0]
            x = sa.attend(x, cache.self_k[i][:, : idx + 1], cache.self_v[i][:, : idx + 1], None)
            x = layer.dec_enc_attn.attend(
                x, cache.cross_k[i], cache.cross_v[i], cache.cross_blocked
            )
            x = layer.pos_ffn(x)
        cache.length = idx + 1
        return x

    def prime(self, enc: torch.Tensor, enc_pad_mask: torch.Tensor, prop: torch.Tensor | None):
        """A fresh cache for ``enc`` rows, with the property prefix written at
        slot 0. Returns (prefix output [R, 1, C] or None, cache)."""
        R = enc.shape[0]
        cfg = self.cfg
        H = cfg.num_heads
        shape = lambda d: (R, cfg.tgt_len + 1, H, d)
        kd = cfg.key_channels // H
        vd = cfg.hidden_channels // H
        cross = [layer.dec_enc_attn.keys_values(enc) for layer in self.layers()]
        cache = DecodeCache(
            self_k=[enc.new_zeros(shape(kd)) for _ in cross],
            self_v=[enc.new_zeros(shape(vd)) for _ in cross],
            cross_k=[k for k, _ in cross],
            cross_v=[v for _, v in cross],
            cross_blocked=enc_pad_mask,
        )
        if not self.num_props:
            return None, cache
        p = self.prop_nn(prop.to(enc.dtype))[:, None, :]
        p = p + self.type_emb(torch.zeros((R, 1), dtype=torch.long, device=enc.device))
        return self._step(p, cache), cache

    def decode_token(self, token: torch.Tensor, pos: int, cache: DecodeCache) -> torch.Tensor:
        """One decode step: ``token [R, 1]`` at sequence position ``pos``."""
        R = token.shape[0]
        x = self.mol_emb(token)
        pe = torch.as_tensor(self._pe[pos], device=x.device)
        x = x + pe[None, None, :]
        if self.num_props:
            x = x + self.type_emb(torch.ones((R, 1), dtype=torch.long, device=x.device))
        return self._step(x, cache)


class CProMGTransformer(nn.Module):
    """Encoder -> Decoder -> vocab projection (CProMG.py:426-464), the
    generation path (no Encoder2)."""

    def __init__(self, cfg: ModelConfig, pad_token: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg.encoder, cfg.featurizer_feat_dim, device)
        self.decoder = Decoder(cfg.decoder, cfg.num_props, pad_token, device)
        self.projection = Linear(
            cfg.decoder.hidden_channels, cfg.decoder.vocab_size, bias=False, device=device
        )

    def encode(self, protein_feat, protein_pos, protein_mask, protein_lap):
        return self.encoder(protein_feat, protein_pos, protein_mask, protein_lap)

    def prime_cache(self, enc, enc_pad_mask, prop) -> DecodeCache:
        return self.decoder.prime(enc, enc_pad_mask, prop)[1]

    def decode_token(self, token, pos: int, cache: DecodeCache) -> torch.Tensor:
        """KV-cached single-token decode -> next-token logits [R, V]."""
        return self.projection(self.decoder.decode_token(token, pos, cache))[:, 0, :]
