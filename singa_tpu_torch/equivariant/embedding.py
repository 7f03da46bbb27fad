"""The heterogeneous SE(3)-equivariant protein-ligand embedding
(counterpart of ``singa_tpu/equivariant/embedding.py``; reference
Embedding.py:52-480).

Two merged stages over a combined [protein; ligand] node set: both intra
edge sets (block-diagonal), then both interaction directions, sharing one
stack of TransBlocks, one final norm and one embedding set. ``gen_mode``
runs the intra stage only, as generation does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from singa_tpu_torch.config import EmbeddingConfig
from singa_tpu_torch.data.batch import ComplexBatch
from singa_tpu_torch.equivariant import so3
from singa_tpu_torch.equivariant.attention import EdgeDegreeEmbedding, TransBlock
from singa_tpu_torch.equivariant.layers import Embed, get_norm_layer
from singa_tpu_torch.ops.neighbors import EdgeEngine
from singa_tpu_torch.ops.smearing import gaussian_smearing


class EmbeddingOutput(NamedTuple):
    protein: torch.Tensor  # [B*Np, (lmax+1)^2, C]
    ligand: torch.Tensor  # [B*Nl, (lmax+1)^2, C]


def _barcode(x: torch.Tensor, bits: int = 15) -> torch.Tensor:
    """Trailing binary features -> integer id (Embedding.py:249-262)."""
    b = (x[:, -bits:] >= 0.5).long()
    powers = 2 ** torch.arange(bits - 1, -1, -1, device=x.device)
    return (b * powers).sum(dim=-1)


class EquivariantEmbedding(nn.Module):
    def __init__(self, cfg: EmbeddingConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.sphere_embedding = Embed(cfg.max_num_elements, cfg.sphere_channels, device)
        self.sphere_embedding_2 = Embed(2**15, cfg.sphere_channels, device)
        self.source_embedding = Embed(cfg.max_num_elements, cfg.edge_channels, device)
        self.target_embedding = Embed(cfg.max_num_elements, cfg.edge_channels, device)
        # radial MLPs see [smear; source embedding; target embedding]
        edge_mlp = (3 * cfg.edge_channels, cfg.edge_channels, cfg.edge_channels)
        self.edge_degree_embedding = EdgeDegreeEmbedding(
            cfg.sphere_channels, cfg.lmax, cfg.mmax, edge_mlp, cfg.avg_degree, device
        )
        self.num_layers = cfg.num_layers
        for i in range(cfg.num_layers):
            setattr(
                self,
                f"block_{i}",
                TransBlock(
                    sphere_channels=cfg.sphere_channels,
                    attn_hidden_channels=cfg.attn_hidden_channels,
                    attn_alpha_channels=cfg.attn_alpha_channels,
                    attn_value_channels=cfg.attn_value_channels,
                    ffn_hidden_channels=cfg.ffn_hidden_channels,
                    num_heads=cfg.num_heads,
                    lmax=cfg.lmax,
                    mmax=cfg.mmax,
                    edge_channels=edge_mlp,
                    norm_type=cfg.norm_type,
                    ffn_activation=cfg.ffn_activation,
                    device=device,
                ),
            )
        self.final_norm = get_norm_layer(cfg.norm_type, cfg.lmax, cfg.sphere_channels, device)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def _edge_scalars(self, pos_src, pos_dst, z_src, z_dst, edges: EdgeEngine):
        cfg = self.cfg
        vec = edges.gather_src(pos_src) - edges.gather_dst(pos_dst)
        dist = torch.linalg.vector_norm(vec, dim=-1)
        x_edge = gaussian_smearing(
            dist, 0.0, cfg.cutoff, cfg.edge_channels, cfg.basis_width_scalar
        )
        src_emb = edges.gather_src(self.source_embedding(z_src))
        dst_emb = edges.gather_dst(self.target_embedding(z_dst))
        return torch.cat([x_edge, src_emb, dst_emb], dim=-1), so3.edge_frame(vec)

    def _base_features(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        scal = self.sphere_embedding(z) + self.sphere_embedding_2(_barcode(x))
        rest = scal.new_zeros((scal.shape[0], so3.num_coeffs(cfg.lmax) - 1, scal.shape[1]))
        return torch.cat([scal[:, None, :], rest], dim=1)

    def _intra_pass(self, x, z, pos, edges: EdgeEngine):
        x_edge, frame = self._edge_scalars(pos, pos, z, z, edges)
        h = self._base_features(x, z)
        h = h + self.edge_degree_embedding(x_edge, edges, frame)
        for block in self.blocks():
            h = block(h, h, x_edge, edges, frame)
        return self.final_norm(h)

    def _inter_pass(self, h_src, h_dst, z, pos, edges: EdgeEngine):
        x_edge, frame = self._edge_scalars(pos, pos, z, z, edges)
        h = h_dst + self.edge_degree_embedding(x_edge, edges, frame)
        for block in self.blocks():
            h = block(h_src, h, x_edge, edges, frame)
        return self.final_norm(h)

    def forward(self, batch: ComplexBatch, gen_mode: bool = False) -> EmbeddingOutput:
        if batch.tables is None:
            raise ValueError(
                "batch lacks destination tables; build it with "
                "singa_tpu_torch.data.batch.stack / attach_tables"
            )
        B = batch.batch_size
        n_p = batch.protein.x.shape[1]
        n_l = batch.ligand.x.shape[1]
        n_c = n_p + n_l
        cat = lambda a, b: torch.cat([a, b], dim=1)
        cx = cat(batch.protein.x, batch.ligand.x).reshape(B * n_c, -1)
        cpos = cat(batch.protein.pos, batch.ligand.pos).reshape(B * n_c, 3)
        cz = cat(batch.protein.atomic_num, batch.ligand.atomic_num).reshape(B * n_c)
        cmask = cat(batch.protein.mask, batch.ligand.mask).reshape(B * n_c)

        # stage 1: both intra edge sets, block-diagonal
        intra_idx = cat(batch.pp.index, batch.ll.index + n_p)
        intra_mask = cat(batch.pp.mask, batch.ll.mask)
        intra = EdgeEngine.create(intra_idx, intra_mask, batch.tables.intra, n_c, n_c)
        h = self._intra_pass(cx, cz, cpos, intra)
        h = h * cmask[:, None, None].to(h.dtype)

        if not gen_mode:
            # stage 2: both interaction directions (l->p and p->l)
            lp_idx = torch.stack(
                [batch.lp.index[..., 0] + n_p, batch.lp.index[..., 1]], dim=-1
            )
            pl_idx = torch.stack(
                [batch.pl.index[..., 0], batch.pl.index[..., 1] + n_p], dim=-1
            )
            inter = EdgeEngine.create(
                cat(lp_idx, pl_idx), cat(batch.lp.mask, batch.pl.mask),
                batch.tables.inter, n_c, n_c,
            )
            h_inter = self._inter_pass(h, h, cz, cpos, inter)
            h = (h + h_inter) * cmask[:, None, None].to(h.dtype)

        hb = h.reshape(B, n_c, *h.shape[1:])
        return EmbeddingOutput(
            protein=hb[:, :n_p].reshape(B * n_p, *h.shape[1:]),
            ligand=hb[:, n_p:].reshape(B * n_l, *h.shape[1:]),
        )
