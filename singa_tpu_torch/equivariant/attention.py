"""SO(2) equivariant graph attention, the gate and S2 feed-forward networks
and the transformer block (counterpart of ``singa_tpu/equivariant/attention.py``;
reference EF_layers.py:23-149, 152-270, 878-1204, 1207-1410).

Heterogeneous (ligand <-> protein) edges use the same modules with distinct
source and target feature tensors; data flow is purely functional.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch
from torch import nn

from singa_tpu_torch.dtypes import compute_dtype
from singa_tpu_torch.equivariant import so3
from singa_tpu_torch.equivariant.layers import (
    RadialMLP,
    SO2Conv,
    _grid_mats_for,
    add_l0,
    get_norm_layer,
    layer_norm,
    separable_s2_activation,
    smooth_leaky_relu,
    uniform_,
)
from singa_tpu_torch.ops.cuda.so2_attn import sections as so2_sections
from singa_tpu_torch.ops.cuda.so2_attn import so2_attn
from singa_tpu_torch.ops.cuda.so3_ffn import so3_ffn, so3_gate_ffn
from singa_tpu_torch.ops.neighbors import EdgeEngine


def _fused_so2_enabled() -> bool:
    """``SINGA_TPU_FUSED_SO2`` set: GraphAttention runs its edge chain as
    kernel K6 (the JAX package's opt-in of the same name)."""
    return bool(os.environ.get("SINGA_TPU_FUSED_SO2"))


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
        # the factor in the features' dtype, as JAX's weak-typed constant
        return edges.scatter_dst(x) / torch.tensor(self.rescale_factor, dtype=x.dtype)


class FeedForwardNetwork(nn.Module):
    """SO3 linear -> activation -> SO3 linear (EF_layers.py:152-270), the
    whole block one kernel. ``activation`` 'gate' (use_gate_act): per-degree
    sigmoid gates from the l=0 row, kernel K2; 's2' (use_sep_s2_act): SiLU
    on the sphere grid with row 0 from ``silu(x0 @ gate_kernel +
    gate_bias)``, kernel K4. Parameters keep the flax layouts (w1 [L, H, C],
    w2 [L, Co, H], gate_kernel [C, lmax*H] for 'gate', [C, H] for 's2')."""

    ACTIVATIONS = ("gate", "s2")

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
        if activation not in self.ACTIVATIONS:
            raise ValueError(
                f"ffn activation {activation!r} is not ported yet (ported: "
                f"{', '.join(self.ACTIVATIONS)})"
            )
        L = lmax + 1
        self.lmax = lmax
        self.activation = activation
        self.C, self.H = in_channels, hidden_channels
        gate_width = lmax * hidden_channels if activation == "gate" else hidden_channels
        self.w1 = nn.Parameter(torch.empty(L, hidden_channels, in_channels, device=device))
        self.b1 = nn.Parameter(torch.empty(hidden_channels, device=device))
        self.w2 = nn.Parameter(torch.empty(L, output_channels, hidden_channels, device=device))
        self.b2 = nn.Parameter(torch.empty(output_channels, device=device))
        self.gate_kernel = nn.Parameter(torch.empty(in_channels, gate_width, device=device))
        self.gate_bias = nn.Parameter(torch.empty(gate_width, device=device))

    def init_params(self, gen: torch.Generator) -> None:
        uniform_(self.w1, 1.0 / math.sqrt(self.C), gen)
        uniform_(self.w2, 1.0 / math.sqrt(self.H), gen)
        uniform_(self.gate_kernel, 1.0 / math.sqrt(self.C), gen)
        uniform_(self.gate_bias, 1.0 / math.sqrt(self.C), gen)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the kernels take the activations in the compute dtype and the
        # weights in float32, as the JAX package's Pallas calls do
        x = x.to(compute_dtype())
        args = (
            x.contiguous(),
            self.w1.transpose(1, 2).contiguous(),  # [L, C, H]
            self.b1,
            self.gate_kernel,
            self.gate_bias,
            self.w2.transpose(1, 2).contiguous(),  # [L, H, Co]
            self.b2,
        )
        if self.activation == "gate":
            return so3_gate_ffn(*args, self.lmax)
        # l-primary grid of the full lmax (mmax = lmax), flattened to [G, I]
        tg, fg = _grid_mats_for(self.lmax, self.lmax, False)
        dev = x.device
        return so3_ffn(*args, so3.as_const(tg, dev, x.dtype), so3.as_const(fg, dev, x.dtype),
                       self.lmax)


class GraphAttention(nn.Module):
    """SO2EquivariantGraphAttention (EF_layers.py:878-1204), config path:
    use_s2_act_attn=False, use_attn_renorm=True, use_gate_act=False,
    use_sep_s2_act=True, use_m_share_rad=False. The edge-frame chain runs
    m-primary; the separable S2 activation is kernel K3. With
    ``SINGA_TPU_FUSED_SO2`` set (read at every call), mmax 2 and a hidden
    width that is a multiple of 128, the whole chain from the rotation to
    SO2 conv 2 is kernel K6 instead, from the same parameters."""

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
        self.hidden_channels = hidden_channels
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

    def _fused(self, wigner) -> bool:
        """The JAX package's selection of its fused kernel, so that both
        packages take the same path for the same configuration."""
        return (
            _fused_so2_enabled()
            and isinstance(wigner, so3.EdgeFrame)
            and self.mmax == 2
            and self.hidden_channels % 128 == 0
        )

    def forward(self, x_src, x_dst, x_edge, edges: EdgeEngine, wigner: so3.EdgeFrame):
        msg = torch.cat([edges.gather_src(x_src), edges.gather_dst(x_dst)], dim=-1)
        alpha_ch = self.num_heads * self.alpha_channels
        if self._fused(wigner):
            # rotate -> SO2 conv 1 -> separable S2 -> SO2 conv 2 in kernel K6
            # (K6·bf16 at a bfloat16 compute dtype): the message and the
            # radial modulation in the compute dtype, the float32 weights
            # and grids, which the kernel rounds, as JAX passes them
            w1s, b1 = self.so2_conv_1.section_weights()
            w2s, b2 = self.so2_conv_2.section_weights()
            tg, fg = _grid_mats_for(self.lmax, self.mmax, True)
            dev, dt = msg.device, compute_dtype()
            F2 = self.num_heads * self.value_channels
            *zs, x0_extra = so2_attn(
                msg.to(dt).contiguous(), self.so2_conv_1.radial(x_edge).to(dt).contiguous(),
                wigner.phi, wigner.beta, w1s, b1, w2s, b2, so3.as_const(tg, dev),
                so3.as_const(fg, dev), self.lmax, self.mmax, self.hidden_channels, F2, alpha_ch,
            )
            E = msg.shape[0]
            secs = so2_sections(self.lmax, self.mmax)
            msg = torch.cat([z.reshape(E, rows, F2) for z, rows in zip(zs, secs)], dim=1)
            x_alpha = x0_extra[:, :alpha_ch]
        else:
            msg = so3.rotate(wigner, msg, self.lmax, self.mmax, m_primary=True)
            msg, x0_extra = self.so2_conv_1(msg, x_edge)
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
        # the float32 attention weights rounded to the messages' dtype, as in JAX
        msg = (msg * alpha.to(msg.dtype)[:, None, :, None]).reshape(E, n_trunc, -1)
        # per-degree output projection before rotate-back + reduce (it
        # commutes with both; reference projects after, EF_layers.py:1196-1203)
        dt = compute_dtype()
        l_of_m = so3.as_const(self._l_of_m, msg.device, torch.long)
        wt = self.proj_w.to(dt).index_select(0, l_of_m)  # [n_trunc, Co, Cin]
        msg = torch.einsum("eic,ioc->eio", msg.to(dt), wt)
        msg = so3.rotate_inv(wigner, msg, self.lmax, self.mmax, m_primary=True)
        return add_l0(edges.scatter_dst(msg), self.proj_b)


class TransBlock(nn.Module):
    """Pre-norm attention + FFN residual block (TransBlockV2,
    EF_layers.py:1207-1410). The norms keep their flax names
    (``EquivariantRMSNorm_0`` before attention, ``_1`` before the FFN). The
    attention runs K3 (K6 under ``SINGA_TPU_FUSED_SO2``); the FFN runs K2
    under ``ffn_activation: gate`` and K4 under ``s2``."""

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
