"""Neighbour-list edge-conditioned graph attention of the kNN encoder
(counterpart of ``singa_tpu/models/neighbor_graph.py``; reference
CProMG.py:19-78, 293-298).

Every pair tensor lives on a fixed ``[B, N, K]`` in-neighbour axis. K
defaults to 2k: a node's in-neighbourhood in the symmetrised kNN graph is its
own k nearest plus everyone who chose it; overflow neighbours are dropped
deterministically (lowest index kept), and the degree attribute is computed
over the kept set.

The pair core runs in one of three forms, chosen as the JAX package chooses
them: ``dense_edge_attn`` (K8) over the [B, N, N] ``adj_dist`` whenever the
graph carries one (``SINGA_TPU_DENSE_ATTN``: the untruncated adjacency, so a
row whose in-degree exceeds K attends over all its neighbours, while the
degree attribute still comes from the kept lists); else
``neighbor_attn_hybrid`` (K7) under ``SINGA_TPU_HYBRID_ATTN``; else
``neighbor_attn`` (K1). Both variables are read at every call, and either is
off when unset, empty or "0". Every form takes qt, k, v and diag_value in the
compute dtype (K7 gathers its neighbour rows in it), and the distances
(``dist``, ``adj_dist``) and self scores in float32, as the JAX module
passes them: at bfloat16 each form runs its kernel's bfloat16 instance.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from singa_tpu_torch.config import EncoderConfig
from singa_tpu_torch.dtypes import compute_dtype
from singa_tpu_torch.equivariant.layers import Linear, layer_norm, uniform_
from singa_tpu_torch.equivariant.so3 import as_const
from singa_tpu_torch.models.cpromg import EdgeMLP, PositionwiseFFN, shifted_softplus
from singa_tpu_torch.ops.cuda.dense_edge_attn import (
    BIG,
    DenseLists,
    dense_edge_attn,
    live_columns,
)
from singa_tpu_torch.ops.cuda.neighbor_attn import (
    neighbor_attn,
    neighbor_attn_hybrid,
    transpose_slots,
)
from singa_tpu_torch.ops.smearing import gaussian_smearing


class NeighborGraph(NamedTuple):
    nbr: torch.Tensor  # [B, N, K] int32 in-neighbour indices (graph-local)
    nbr_mask: torch.Tensor  # [B, N, K] bool
    dist: torch.Tensor  # [B, N, K] f32 distances to those neighbours
    deg_attr: torch.Tensor  # [B, N, De] Laplacian diagonal (degree) attr
    node_mask: torch.Tensor  # [B, N] bool
    rev_offsets: torch.Tensor  # [B*N + 1] int32 CSR transpose of nbr (transpose_slots)
    rev_slots: torch.Tensor  # [B*N*K] int32: the slots naming each row, ascending
    # the dense form's pair distances (dense_edge_attn): the distance where j
    # is adjacent to i, BIG elsewhere (the diagonal and padded nodes included)
    adj_dist: torch.Tensor | None = None  # [B, N, N] f32
    # its live columns per row and their transpose (live_columns), which K8
    # and K8b walk in every layer
    dense_lists: DenseLists | None = None


def _switch(name: str) -> bool:
    return os.environ.get(name, "0") not in ("0", "")


def _dense_attn() -> bool:
    """``SINGA_TPU_DENSE_ATTN`` set (and not "0"): the encoder builds
    ``adj_dist`` and every layer runs the dense form, K8."""
    return _switch("SINGA_TPU_DENSE_ATTN")


def _hybrid_attn() -> bool:
    """``SINGA_TPU_HYBRID_ATTN`` set (and not "0"): layers without
    ``adj_dist`` run the hybrid form, K7."""
    return _switch("SINGA_TPU_HYBRID_ATTN")


def build_neighbor_graph(
    pos: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    smear_stop: float,
    edge_channels: int,
    k_in: int | None = None,
    with_adj_dist: bool = False,
) -> NeighborGraph:
    """Symmetrised threshold-kNN as per-node neighbour lists.

    Matches the JAX package tie for tie: squared distances by the same
    expansion ``|a|^2 - 2 a.b + |b|^2`` (clamped at 0), the k-th distance as
    an inclusive threshold, and the lowest indices first among the kept
    neighbours (a stable descending sort of the 0/1 adjacency, as
    ``jax.lax.top_k`` orders ties). ``with_adj_dist``: also the dense
    form's ``adj_dist``, from the adjacency before the top-K cut, and its
    live columns (``live_columns``)."""
    B, N, _ = pos.shape
    K = min(k_in or 2 * k, N)
    n2 = (pos * pos).sum(dim=-1)
    d2 = n2[:, :, None] - 2.0 * torch.einsum("bnc,bmc->bnm", pos, pos) + n2[:, None, :]
    d2 = torch.clamp(d2, min=0.0)
    valid_pair = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)[None]
    big = torch.tensor(1e30, dtype=d2.dtype, device=pos.device)
    d2m = torch.where(valid_pair & ~eye, d2, big)
    kth = torch.kthvalue(d2m, k, dim=-1, keepdim=True).values
    adj_dir = (d2m <= kth) & (d2m < big)
    adj = adj_dir | adj_dir.transpose(1, 2)
    val, nbr = torch.sort(adj.to(torch.float32), dim=-1, descending=True, stable=True)
    nbr_mask = val[..., :K] > 0.5
    nbr = nbr[..., :K].to(torch.int32).contiguous()
    dist_full = torch.sqrt(torch.clamp(d2, min=1e-12))
    dist = torch.gather(dist_full, 2, nbr.long())
    # the degree attribute is summed from the smear in the compute dtype, as in JAX
    neg_smear = -gaussian_smearing(dist, 0.0, smear_stop, edge_channels).to(compute_dtype())
    deg = -(neg_smear * nbr_mask[..., None].to(neg_smear.dtype)).sum(dim=2)
    rev_offsets, rev_slots = transpose_slots(nbr)
    adj_dist = torch.where(adj, dist_full, BIG) if with_adj_dist else None
    lists = live_columns(adj_dist) if with_adj_dist else None
    return NeighborGraph(nbr=nbr, nbr_mask=nbr_mask, dist=dist, deg_attr=deg, node_mask=mask,
                         rev_offsets=rev_offsets, rev_slots=rev_slots, adj_dist=adj_dist,
                         dense_lists=lists)


class NeighborGraphMHA(nn.Module):
    """Edge-conditioned multi-head graph attention over neighbour lists. The
    pair core (smear, both EdgeMLPs, scores, softmax with the self slot,
    aggregate) is kernel K1, K7 or K8 (see the module's docstring); the
    grouped projections keep the flax layout ``[H, C/H, F/H]``."""

    def __init__(
        self,
        hidden_channels: int,
        key_channels: int,
        num_heads: int,
        edge_channels: int,
        smear_stop: float,
        device=None,
    ):
        super().__init__()
        H = num_heads
        C = hidden_channels
        self.H, self.C = H, C
        self.kd = key_channels // H
        self.vd = hidden_channels // H
        self.edge_channels = edge_channels
        self.smear_stop = smear_stop
        self.q_lin = nn.Parameter(torch.empty(H, C // H, key_channels // H, device=device))
        self.k_lin = nn.Parameter(torch.empty(H, C // H, key_channels // H, device=device))
        self.v_lin = nn.Parameter(torch.empty(H, C // H, hidden_channels // H, device=device))
        self.weight_k_net = EdgeMLP(edge_channels, self.kd, device)
        self.weight_v_net = EdgeMLP(edge_channels, self.vd, device)
        self.weight_k_lin_kernel = nn.Parameter(torch.empty(self.kd, self.kd, device=device))
        self.weight_v_lin = Linear(self.vd, self.vd, device=device)
        self.centroid_lin = Linear(C, hidden_channels, device=device)
        self.out_transform = Linear(hidden_channels, hidden_channels, device=device)
        self.layer_norm = layer_norm(hidden_channels, device)
        self._centers = np.linspace(0.0, smear_stop, edge_channels, dtype=np.float32)

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.C // self.H)
        for p in (self.q_lin, self.k_lin, self.v_lin):
            uniform_(p, bound, gen)
        uniform_(self.weight_k_lin_kernel, 1.0 / math.sqrt(self.kd), gen)

    def forward(self, x: torch.Tensor, g: NeighborGraph) -> torch.Tensor:
        B, N, C = x.shape
        H, kd, vd = self.H, self.kd, self.vd
        dt = compute_dtype()
        xh = x.to(dt).reshape(B, N, H, C // H)
        q = torch.einsum("bnhc,hco->bnho", xh, self.q_lin.to(dt))
        k = torch.einsum("bnhc,hco->bnho", xh, self.k_lin.to(dt))
        v = torch.einsum("bnhc,hco->bnho", xh, self.v_lin.to(dt))

        w_k_diag = self.weight_k_net(g.deg_attr.to(dt))  # [B, N, kd]
        w_v_diag = self.weight_v_net(g.deg_attr.to(dt))  # [B, N, vd]
        q_tilde = torch.einsum("bnhe,de->bnhd", q, self.weight_k_lin_kernel.to(dt))
        # the self scores are float32 (the JAX package scales by a numpy
        # float, which promotes), from a sum in the compute dtype
        scores_diag = (q_tilde * w_k_diag[:, :, None, :] * k).sum(-1).float() / math.sqrt(kd)
        s_diag = torch.where(g.node_mask[..., None], scores_diag, -1e9)

        width = self.smear_stop / (self.edge_channels - 1)
        ek, ev = self.weight_k_net, self.weight_v_net
        nodes = (
            q_tilde.reshape(B, N, H * kd).contiguous(),
            k.reshape(B, N, H * kd).contiguous(),
            v.reshape(B, N, H * vd).contiguous(),
        )
        diag = (s_diag.contiguous(), (w_v_diag[:, :, None, :] * v).reshape(B, N, H * vd).contiguous())
        weights = (
            as_const(self._centers, x.device),
            ek.Linear_0.weight.t().contiguous(), ek.Linear_0.bias,
            ek.Linear_1.weight.t().contiguous(), ek.Linear_1.bias,
            ev.Linear_0.weight.t().contiguous(), ev.Linear_0.bias,
            ev.Linear_1.weight.t().contiguous(), ev.Linear_1.bias,
            -0.5 / (width * width),
        )
        if g.adj_dist is not None:
            agg = dense_edge_attn(*nodes, g.adj_dist, *diag, *weights, g.dense_lists)
        else:
            attn = neighbor_attn_hybrid if _hybrid_attn() else neighbor_attn
            agg = attn(*nodes, g.nbr, g.nbr_mask, g.dist, *diag, *weights,
                       g.rev_offsets, g.rev_slots)
        agg = agg.reshape(B, N, H, vd)
        aggr = self.weight_v_lin(agg).reshape(B, N, H * vd)
        out = self.centroid_lin(x) + aggr
        out = self.layer_norm(self.out_transform(shifted_softplus(out)))
        return out * g.node_mask[..., None].to(out.dtype)


class NeighborEncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, smear_stop: float, device=None):
        super().__init__()
        self.enc_self_attn = NeighborGraphMHA(
            cfg.hidden_channels, cfg.key_channels, cfg.num_heads, cfg.edge_channels,
            smear_stop, device,
        )
        self.pos_ffn = PositionwiseFFN(cfg.hidden_channels, cfg.ffn_hidden, device)

    def forward(self, x: torch.Tensor, g: NeighborGraph):
        msa = self.enc_self_attn(x, g)
        return msa, self.pos_ffn(msa)
