"""Dense-form edge-conditioned graph attention of Encoder2 (counterpart of
``singa_tpu/models/dense_graph.py``; reference CProMG.py:19-78, 293-298).

The same attention as the neighbour-list form, on dense masked ``[B, N, N]``
tensors; Encoder2 runs it over the ligand's atoms. Two exact rewrites keep it
small:

  * ``score_ij = q_i . W(w_ij * k_j) + q_i . b``: the bias term is constant
    per query row and softmax-invariant, so it is dropped; with
    ``q~ = W^T q`` the score is ``sum_d q~_id k_jd w_ijd``;
  * ``out_i = sum_j a_ij (W(w_ij * v_j) + b) = W(sum_j a_ij w_ij * v_j) + b``.

The Laplacian edge transform (off-diagonal ``-smear(d)``, diagonal the
degree) evaluates the edge MLPs on the off-diagonal attributes of every pair
and on the degree vector for the self slot.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from singa_tpu_torch.dtypes import compute_dtype
from singa_tpu_torch.equivariant.layers import Linear, layer_norm, uniform_
from singa_tpu_torch.models.cpromg import EdgeMLP, shifted_softplus
from singa_tpu_torch.ops.smearing import gaussian_smearing


class DenseGraph(NamedTuple):
    adj: torch.Tensor  # [B, N, N] bool, symmetric kNN closure (no self)
    deg_attr: torch.Tensor  # [B, N, De] Laplacian diagonal (degree) attr
    node_mask: torch.Tensor  # [B, N] bool
    neg_smear: torch.Tensor  # [B, N, N, De] negated smeared distances


def build_dense_graph(
    pos: torch.Tensor, mask: torch.Tensor, k: int, smear_stop: float, edge_channels: int
) -> DenseGraph:
    """Symmetrised threshold-kNN over every valid pair, as the JAX package
    builds it: squared distances by ``|a|^2 - 2 a.b + |b|^2`` (clamped at 0),
    invalid pairs and the diagonal at ``1e30``, the k-th smallest distance of
    each row as an inclusive threshold (ties admit every tied neighbour).
    A graph with at most ``k`` valid nodes gets every valid pair."""
    N = pos.shape[1]
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
    dist = torch.sqrt(torch.clamp(d2, min=1e-12))
    neg_smear = -gaussian_smearing(dist, 0.0, smear_stop, edge_channels).to(compute_dtype())
    deg = -(neg_smear * adj[..., None].to(neg_smear.dtype)).sum(dim=2)
    return DenseGraph(adj=adj, deg_attr=deg, node_mask=mask, neg_smear=neg_smear)


class DenseGraphMHA(nn.Module):
    """Edge-conditioned multi-head graph attention over every pair of a
    graph; the same parameters as ``NeighborGraphMHA``."""

    def __init__(
        self,
        hidden_channels: int,
        key_channels: int,
        num_heads: int,
        edge_channels: int,
        device=None,
    ):
        super().__init__()
        H = num_heads
        C = hidden_channels
        self.H, self.C = H, C
        self.kd = key_channels // H
        self.vd = hidden_channels // H
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

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.C // self.H)
        for p in (self.q_lin, self.k_lin, self.v_lin):
            uniform_(p, bound, gen)
        uniform_(self.weight_k_lin_kernel, 1.0 / math.sqrt(self.kd), gen)

    def forward(self, x: torch.Tensor, g: DenseGraph) -> torch.Tensor:
        B, N, C = x.shape
        H, vd = self.H, self.vd
        dt = compute_dtype()
        xh = x.to(dt).reshape(B, N, H, C // H)
        q = torch.einsum("bnhc,hco->bnho", xh, self.q_lin.to(dt))
        k = torch.einsum("bnhc,hco->bnho", xh, self.k_lin.to(dt))
        v = torch.einsum("bnhc,hco->bnho", xh, self.v_lin.to(dt))

        w_k_off = self.weight_k_net(g.neg_smear.to(dt))  # [B, N, N, kd]
        w_v_off = self.weight_v_net(g.neg_smear.to(dt))  # [B, N, N, vd]
        w_k_diag = self.weight_k_net(g.deg_attr.to(dt))  # [B, N, kd]
        w_v_diag = self.weight_v_net(g.deg_attr.to(dt))

        # W_k folded into the query; its bias is softmax-invariant and dropped
        q_tilde = torch.einsum("bnhe,de->bnhd", q, self.weight_k_lin_kernel.to(dt))
        scale = 1.0 / math.sqrt(self.kd)
        # scores and softmax in float32 (JAX's numpy-float scale promotes)
        scores_off = torch.einsum("bihd,bjhd,bijd->bhij", q_tilde, k, w_k_off).float()
        scores_diag = torch.einsum("bihd,bihd,bid->bhi", q_tilde, k, w_k_diag).float()
        eye = torch.eye(N, dtype=torch.bool, device=x.device)
        m = g.node_mask
        domain = (g.adj | eye[None]) & m[:, None, :] & m[:, :, None]
        scores = torch.where(domain[:, None], scores_off * scale, -1e9)
        scores = torch.where(eye[None, None], scores_diag[..., None] * scale, scores)
        # padded nodes' own diagonal is blocked again
        scores = torch.where(m[:, None, :, None] & m[:, None, None, :], scores, -1e9)
        alpha = torch.softmax(scores, dim=-1)  # [B, H, N, N]

        alpha_off = torch.where(eye[None, None], 0.0, alpha)
        alpha_diag = torch.diagonal(alpha, dim1=-2, dim2=-1)  # [B, H, N]
        agg = torch.einsum("bhij,bijd,bjhd->bihd", alpha_off.to(dt), w_v_off, v)
        agg = agg + alpha_diag.transpose(1, 2)[..., None].to(dt) * (w_v_diag[:, :, None, :] * v)
        aggr = self.weight_v_lin(agg).reshape(B, N, H * vd)  # bias commutes with the sum
        out = self.centroid_lin(x) + aggr
        out = self.layer_norm(self.out_transform(shifted_softplus(out)))
        return out * m[..., None].to(out.dtype)
