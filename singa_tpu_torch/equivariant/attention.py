"""SO(2) equivariant graph attention, the gate feed-forward network and the
transformer block (counterpart of ``singa_tpu/equivariant/attention.py``;
reference EF_layers.py:23-149, 152-270, 878-1204, 1207-1410).

Heterogeneous (ligand <-> protein) edges use the same modules with distinct
source and target feature tensors; data flow is purely functional.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from singa_tpu_torch.equivariant import so3
from singa_tpu_torch.equivariant.layers import (
    RadialMLP,
    SO2Conv,
    add_l0,
    get_norm_layer,
    layer_norm,
    separable_s2_activation,
    smooth_leaky_relu,
    uniform_,
)
from singa_tpu_torch.ops.cuda.so3_ffn import so3_gate_ffn
from singa_tpu_torch.ops.neighbors import EdgeEngine


class EdgeDegreeEmbedding(nn.Module):
    """Invariant edge scalars -> m=0 edge-frame features -> rotate back ->
    degree-rescaled sum at the target node (EF_layers.py:86-149).
    ``edge_channels`` lists the radial MLP widths, input first."""

    def __init__(
        self,
        sphere_channels: int,
        lmax: int,
        mmax: int,
        edge_channels: Sequence[int],
        rescale_factor: float,
        device=None,
    ):
        super().__init__()
        self.sphere_channels = sphere_channels
        self.lmax, self.mmax = lmax, mmax
        self.mapping = so3.CoefficientMapping(lmax, mmax)
        self.rescale_factor = rescale_factor
        n0 = self.mapping.m_size[0]
        self.RadialMLP_0 = RadialMLP(
            edge_channels[0], tuple(edge_channels[1:]) + (n0 * sphere_channels,), device
        )

    def forward(self, x_edge: torch.Tensor, edges: EdgeEngine, wigner: so3.EdgeFrame):
        n0 = self.mapping.m_size[0]
        C = self.sphere_channels
        rad = self.RadialMLP_0(x_edge).reshape(-1, n0, C)
        # in the m-primary layout the m=0 block is the first n0 rows
        pad = rad.new_zeros((x_edge.shape[0], self.mapping.n_trunc - n0, C))
        x = torch.cat([rad, pad], dim=1)
        x = so3.rotate_inv(wigner, x, self.lmax, self.mmax, m_primary=True)
        return edges.scatter_dst(x) / self.rescale_factor


class FeedForwardNetwork(nn.Module):
    """SO3 linear -> gate activation -> SO3 linear (EF_layers.py:152-270,
    use_gate_act). The whole block is kernel K2; parameters keep the flax
    layouts (w1 [L, H, C], w2 [L, Co, H], gate_kernel [C, lmax*H])."""

    def __init__(
        self,
        in_channels: int,
        hidden_channels: int,
        output_channels: int,
        lmax: int,
        activation: str = "gate",
        device=None,
    ):
        super().__init__()
        if activation != "gate":
            raise ValueError(
                f"ffn activation {activation!r} is not ported yet (only 'gate', the default)"
            )
        L = lmax + 1
        self.lmax = lmax
        self.C, self.H = in_channels, hidden_channels
        self.w1 = nn.Parameter(torch.empty(L, hidden_channels, in_channels, device=device))
        self.b1 = nn.Parameter(torch.empty(hidden_channels, device=device))
        self.w2 = nn.Parameter(torch.empty(L, output_channels, hidden_channels, device=device))
        self.b2 = nn.Parameter(torch.empty(output_channels, device=device))
        self.gate_kernel = nn.Parameter(
            torch.empty(in_channels, lmax * hidden_channels, device=device)
        )
        self.gate_bias = nn.Parameter(torch.empty(lmax * hidden_channels, device=device))

    def init_params(self, gen: torch.Generator) -> None:
        uniform_(self.w1, 1.0 / math.sqrt(self.C), gen)
        uniform_(self.w2, 1.0 / math.sqrt(self.H), gen)
        uniform_(self.gate_kernel, 1.0 / math.sqrt(self.C), gen)
        uniform_(self.gate_bias, 1.0 / math.sqrt(self.C), gen)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return so3_gate_ffn(
            x.contiguous(),
            self.w1.transpose(1, 2).contiguous(),  # [L, C, H]
            self.b1,
            self.gate_kernel,
            self.gate_bias,
            self.w2.transpose(1, 2).contiguous(),  # [L, H, Co]
            self.b2,
            self.lmax,
        )


class GraphAttention(nn.Module):
    """SO2EquivariantGraphAttention (EF_layers.py:878-1204), config path:
    use_s2_act_attn=False, use_attn_renorm=True, use_gate_act=False,
    use_sep_s2_act=True, use_m_share_rad=False. The edge-frame chain runs
    m-primary; the separable S2 activation is kernel K3."""

    def __init__(
        self,
        sphere_channels: int,
        hidden_channels: int,
        num_heads: int,
        attn_alpha_channels: int,
        attn_value_channels: int,
        output_channels: int,
        lmax: int,
        mmax: int,
        edge_channels: Sequence[int],
        device=None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.alpha_channels = attn_alpha_channels
        self.value_channels = attn_value_channels
        self.lmax, self.mmax = lmax, mmax
        self.mapping = so3.CoefficientMapping(lmax, mmax)
        extra = num_heads * attn_alpha_channels + hidden_channels
        F2 = num_heads * attn_value_channels
        self.so2_conv_1 = SO2Conv(
            2 * sphere_channels, hidden_channels, lmax, mmax,
            edge_channels=edge_channels, extra_m0_features=extra, device=device,
        )
        self.so2_conv_2 = SO2Conv(hidden_channels, F2, lmax, mmax, device=device)
        self.alpha_norm = layer_norm(attn_alpha_channels, device)
        self.alpha_dot = nn.Parameter(
            torch.empty(num_heads, attn_alpha_channels, device=device)
        )
        self.proj_w = nn.Parameter(torch.empty(lmax + 1, output_channels, F2, device=device))
        self.proj_b = nn.Parameter(torch.empty(output_channels, device=device))
        self._l_of_m = self.mapping.l_of_trunc[self.mapping.l_to_m]

    def init_params(self, gen: torch.Generator) -> None:
        uniform_(self.alpha_dot, 1.0 / math.sqrt(self.alpha_channels), gen)
        uniform_(self.proj_w, 1.0 / math.sqrt(self.proj_w.shape[2]), gen)
        with torch.no_grad():
            self.proj_b.zero_()

    def forward(self, x_src, x_dst, x_edge, edges: EdgeEngine, wigner: so3.EdgeFrame):
        msg = torch.cat([edges.gather_src(x_src), edges.gather_dst(x_dst)], dim=-1)
        msg = so3.rotate(wigner, msg, self.lmax, self.mmax, m_primary=True)
        msg, x0_extra = self.so2_conv_1(msg, x_edge)
        alpha_ch = self.num_heads * self.alpha_channels
        x_alpha = x0_extra[:, :alpha_ch]
        gating = x0_extra[:, alpha_ch:]
        msg = separable_s2_activation(
            gating.contiguous(), msg.contiguous(), self.lmax, self.mmax, m_primary=True
        )
        msg = self.so2_conv_2(msg)

        # attention logits from the invariant m=0 channel
        x_alpha = x_alpha.reshape(-1, self.num_heads, self.alpha_channels)
        x_alpha = smooth_leaky_relu(self.alpha_norm(x_alpha))
        alpha = torch.einsum("ehk,hk->eh", x_alpha, self.alpha_dot)
        alpha = edges.softmax_dst(alpha)

        E, n_trunc, _ = msg.shape
        msg = msg.reshape(E, n_trunc, self.num_heads, self.value_channels)
        msg = (msg * alpha[:, None, :, None]).reshape(E, n_trunc, -1)
        # per-degree output projection before rotate-back + reduce (it
        # commutes with both; reference projects after, EF_layers.py:1196-1203)
        l_of_m = so3.as_const(self._l_of_m, msg.device, torch.long)
        wt = self.proj_w.index_select(0, l_of_m)  # [n_trunc, Co, Cin]
        msg = torch.einsum("eic,ioc->eio", msg, wt)
        msg = so3.rotate_inv(wigner, msg, self.lmax, self.mmax, m_primary=True)
        return add_l0(edges.scatter_dst(msg), self.proj_b)


class TransBlock(nn.Module):
    """Pre-norm attention + FFN residual block (TransBlockV2,
    EF_layers.py:1207-1410). The norms keep their flax names
    (``EquivariantRMSNorm_0`` before attention, ``_1`` before the FFN)."""

    def __init__(
        self,
        sphere_channels: int,
        attn_hidden_channels: int,
        attn_alpha_channels: int,
        attn_value_channels: int,
        ffn_hidden_channels: int,
        num_heads: int,
        lmax: int,
        mmax: int,
        edge_channels: Sequence[int],
        norm_type: str = "rms_norm_sh",
        ffn_activation: str = "gate",
        device=None,
    ):
        super().__init__()
        self.EquivariantRMSNorm_0 = get_norm_layer(norm_type, lmax, sphere_channels, device)
        self.ga = GraphAttention(
            sphere_channels, attn_hidden_channels, num_heads, attn_alpha_channels,
            attn_value_channels, sphere_channels, lmax, mmax, edge_channels, device,
        )
        self.EquivariantRMSNorm_1 = get_norm_layer(norm_type, lmax, sphere_channels, device)
        self.ffn = FeedForwardNetwork(
            sphere_channels, ffn_hidden_channels, sphere_channels, lmax,
            ffn_activation, device,
        )

    def forward(self, x_src, x_dst, x_edge, edges: EdgeEngine, wigner: so3.EdgeFrame):
        xs = self.EquivariantRMSNorm_0(x_src)
        xt = self.EquivariantRMSNorm_0(x_dst) if x_dst is not x_src else xs
        x = x_dst + self.ga(xs, xt, x_edge, edges, wigner)
        return self.ffn(self.EquivariantRMSNorm_1(x)) + x
