"""Equivariant building blocks: linears, embeddings, radial MLPs, the
equivariant RMS norm, gate, S2 and separable S2 activations, SO(2)
convolutions.

Counterpart of ``singa_tpu/equivariant/layers.py``. Features are tensors
``[N, coeffs, C]``. Parameters keep the flax layouts where a module owns them
directly (``SO2Conv.w_m0`` is ``[in, out]`` as in the JAX package); ``Linear``
and ``Embed`` use PyTorch's ``[out, in]`` / ``[num, features]``. Submodule
attribute names follow the flax module names (``RadialMLP_0``, ``Linear_1``)
so that the weight bridge (``singa_tpu_torch/params.py``) is a path map.

Mixed precision follows the JAX package's (``singa_tpu_torch/dtypes.py``):
``Linear``, ``Embed``, ``SO2Conv``'s products and the kernels compute in
``compute_dtype()``; parameters stay float32; ``LayerNorm`` promotes its
input to its float32 parameters, as flax's does, so it returns float32 on a
bfloat16 input; the norms of ``[N, coeffs, C]`` features run in float32 and
return the input's dtype. Under float32 every cast is a no-op.

Initialisation is explicit: every module with parameters of its own has
``init_params(gen)``, which draws from a ``torch.Generator`` on the CPU with
the JAX package's distributions (torch-default uniform for linears, N(0, 1)
for embeddings); ``params.seeded_init`` walks a model and calls them.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from singa_tpu_torch.dtypes import compute_dtype
from singa_tpu_torch.equivariant.grid import _grid_mats
from singa_tpu_torch.equivariant.so3 import CoefficientMapping, as_const
from singa_tpu_torch.ops.cuda.s2_act import s2_silu, s2_silu_sep


@torch.no_grad()
def uniform_(p: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))


@torch.no_grad()
def normal_(p: torch.Tensor, gen: torch.Generator) -> None:
    p.copy_(torch.randn(p.shape, generator=gen))


class Linear(nn.Module):
    """Affine map with torch-default initialisation (uniform +-1/sqrt(in))."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = (
            nn.Parameter(torch.empty(out_features, device=device)) if bias else None
        )

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        uniform_(self.weight, bound, gen)
        if self.bias is not None:
            uniform_(self.bias, bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype()
        if dt == torch.float32:
            return F.linear(x, self.weight, self.bias)
        # flax's Dense(dtype=dt): input and weights cast, the product and the
        # bias add each rounded to dt
        y = x.to(dt) @ self.weight.to(dt).t()
        return y if self.bias is None else y + self.bias.to(dt)


class Embed(nn.Module):
    """Embedding table with N(0, 1) initialisation."""

    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features, device=device))

    def init_params(self, gen: torch.Generator) -> None:
        normal_(self.weight, gen)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        # the table cast first, as flax's Embed(dtype=...): its gradient then
        # sums the rows' cotangents in that dtype, as JAX's scatter does
        return F.embedding(idx.long(), self.weight.to(compute_dtype()))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that promotes its input to its parameters' dtype
    first, as flax's LayerNorm does: float32 out of a bfloat16 input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


def layer_norm(features: int, device=None) -> LayerNorm:
    """LayerNorm with torch's default eps 1e-5, which the JAX package sets
    explicitly (flax defaults to 1e-6)."""
    return LayerNorm(features, eps=1e-5, device=device)


def smooth_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """Reference EF_layers.py:1669-1677."""
    a = negative_slope
    return ((1 + a) / 2.0) * x + ((1 - a) / 2.0) * x * (2.0 * torch.sigmoid(x) - 1.0)


class RadialMLP(nn.Module):
    """Linear -> LayerNorm -> SiLU stack; last layer plain Linear
    (reference RadialFunction, EF_layers.py:1634-1657)."""

    def __init__(self, in_features: int, channels: Sequence[int], device=None):
        super().__init__()
        self.n = len(channels)
        prev = in_features
        for i, ch in enumerate(channels):
            setattr(self, f"Linear_{i}", Linear(prev, ch, device=device))
            if i < self.n - 1:
                setattr(self, f"LayerNorm_{i}", layer_norm(ch, device))
            prev = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Linear_{i}")(x)
            if i < self.n - 1:
                x = F.silu(getattr(self, f"LayerNorm_{i}")(x))
        return x


def add_l0(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Add a per-channel bias to the l=0 (first) coefficient row."""
    return torch.cat([x[:, :1] + bias.to(x.dtype), x[:, 1:]], dim=1)


class EquivariantRMSNorm(nn.Module):
    """'rms_norm_sh' (EF_layers.py:2099-2192): centred l=0, degree-balanced
    component RMS, per-degree affine weight, l=0 bias."""

    def __init__(self, lmax: int, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.lmax = lmax
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(lmax + 1, channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        mapping = CoefficientMapping(lmax, lmax)
        self._l_of = mapping.l_of_full
        self._bal = (
            1.0 / ((2.0 * mapping.l_of_full + 1.0) * (lmax + 1) * channels)
        ).astype(np.float32)

    def init_params(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        N, I, C = x.shape
        dev = x.device
        mean0 = x[:, 0, :].mean(dim=-1, keepdim=True)  # [N, 1]
        x = torch.cat([x[:, :1] - mean0[:, :, None], x[:, 1:]], dim=1)
        balv = as_const(self._bal, dev, x.dtype).repeat_interleave(C)  # [I*C]
        x2 = x.reshape(N, I * C)
        norm = (x2 * x2) @ balv  # [N]
        inv = torch.rsqrt(norm + self.eps)[:, None]
        l_of = as_const(self._l_of, dev, torch.long)
        wv = self.weight.to(x.dtype).index_select(0, l_of)  # [I, C]
        out = x2 * inv * wv.reshape(1, I * C)
        out = add_l0(out.reshape(N, I, C), self.bias)
        return out.to(in_dtype)


def get_norm_layer(norm_type: str, lmax: int, channels: int, device=None) -> nn.Module:
    if norm_type == "rms_norm_sh":
        return EquivariantRMSNorm(lmax, channels, device=device)
    raise ValueError(
        f"norm {norm_type!r} is not ported yet (only 'rms_norm_sh', the default)"
    )


def gate_activation(
    gating_scalars: torch.Tensor, x: torch.Tensor, lmax: int, mmax: int
) -> torch.Tensor:
    """Reference GateActivation (EF_layers.py:1683-1733): SiLU on row 0,
    each degree l >= 1 times its sigmoid gate. Parameter-free."""
    C = x.shape[-1]
    gates = torch.sigmoid(gating_scalars).reshape(x.shape[0], lmax, C)
    expand = []
    for l in range(1, lmax + 1):
        expand.extend([l - 1] * min(2 * l + 1, 2 * mmax + 1))
    idx = torch.as_tensor(expand, dtype=torch.long, device=x.device)
    gates = gates.index_select(1, idx)
    return torch.cat([F.silu(x[:, :1]), x[:, 1:] * gates], dim=1)


@functools.lru_cache(maxsize=None)
def _grid_mats_for(lmax: int, mmax: int, m_primary: bool):
    """(to_grid, from_grid) flattened to ``[G, n_trunc]``, with the m-primary
    coefficient permutation folded into the constants when requested."""
    tg, fg = _grid_mats(lmax, mmax)
    if m_primary:
        perm = CoefficientMapping(lmax, mmax).l_to_m
        tg, fg = tg[:, :, perm], fg[:, :, perm]
    tg = np.ascontiguousarray(tg.reshape(-1, tg.shape[-1]))
    fg = np.ascontiguousarray(fg.reshape(-1, fg.shape[-1]))
    return tg, fg


def s2_activation(
    x: torch.Tensor, lmax: int, mmax: int, m_primary: bool = False
) -> torch.Tensor:
    """Pointwise SiLU on the sphere grid, every row (EF_layers.py:1736-1754).
    Runs kernel K5."""
    tg, fg = _grid_mats_for(lmax, mmax, m_primary)
    dev = x.device
    return s2_silu(x, as_const(tg, dev, x.dtype), as_const(fg, dev, x.dtype))


def separable_s2_activation(
    scalars: torch.Tensor, x: torch.Tensor, lmax: int, mmax: int, m_primary: bool = False
) -> torch.Tensor:
    """SiLU on explicit scalars (row 0) + S2 SiLU on the tensor part (rows
    1..), recombined (EF_layers.py:1757-1773). Runs kernel K3."""
    tg, fg = _grid_mats_for(lmax, mmax, m_primary)
    dev = x.device
    return s2_silu_sep(x, scalars, as_const(tg, dev, x.dtype), as_const(fg, dev, x.dtype))


class SO2Conv(nn.Module):
    """SO(2) convolution over all orders m in the edge frame, on m-primary
    truncated features ``[E, n_trunc, C]`` (reference SO2_Convolution,
    EF_layers.py:732-875). ``edge_channels`` (radial MLP widths, input
    first) configures the radial modulation of the inputs;
    ``extra_m0_features`` returns additional invariant channels from the
    m=0 branch."""

    def __init__(
        self,
        c_in: int,
        features: int,
        lmax: int,
        mmax: int,
        edge_channels: Sequence[int] | None = None,
        extra_m0_features: int = 0,
        device=None,
    ):
        super().__init__()
        self.mapping = CoefficientMapping(lmax, mmax)
        self.c_in = c_in
        self.features = features
        self.extra = extra_m0_features
        self.mmax = mmax
        m_sizes = self.mapping.m_size
        n0 = m_sizes[0]
        if edge_channels is not None:
            total_rad = n0 * c_in + sum(s * c_in for s in m_sizes[1:])
            self.RadialMLP_0 = RadialMLP(
                edge_channels[0], tuple(edge_channels[1:]) + (total_rad,), device
            )
        else:
            self.RadialMLP_0 = None
        self.w_m0 = nn.Parameter(
            torch.empty(n0 * c_in, n0 * features + self.extra, device=device)
        )
        self.b_m0 = nn.Parameter(torch.empty(n0 * features + self.extra, device=device))
        for m in range(1, mmax + 1):
            sz = m_sizes[m]
            setattr(
                self,
                f"w_m{m}",
                nn.Parameter(torch.empty(sz * c_in, 2 * sz * features, device=device)),
            )

    def init_params(self, gen: torch.Generator) -> None:
        m_sizes = self.mapping.m_size
        bound0 = 1.0 / math.sqrt(m_sizes[0] * self.c_in)
        uniform_(self.w_m0, bound0, gen)
        uniform_(self.b_m0, bound0, gen)
        for m in range(1, self.mmax + 1):
            bound = 1.0 / math.sqrt(m_sizes[m] * self.c_in) / math.sqrt(2.0)
            uniform_(getattr(self, f"w_m{m}"), bound, gen)

    def section_weights(self) -> tuple[list[torch.Tensor], torch.Tensor]:
        """``([w_m0, W_1, .., W_mmax], b_m0)``: one weight per m-primary
        section, ``W_m`` the complex-pair block ``[[K_r, K_i], [-K_i, K_r]]``
        of ``w_m{m}`` (its cos rows, then its sin rows), assembled with
        autograd so gradients reach the parameters."""
        Fo = self.features
        ws = [self.w_m0]
        for m in range(1, self.mmax + 1):
            sz = self.mapping.m_size[m]
            K = getattr(self, f"w_m{m}")
            K_r, K_i = K[:, : sz * Fo], K[:, sz * Fo :]
            ws.append(torch.cat([torch.cat([K_r, K_i], dim=1), torch.cat([-K_i, K_r], dim=1)], dim=0))
        return ws, self.b_m0

    def radial(self, x_edge: torch.Tensor) -> torch.Tensor:
        """The radial modulation ``[E, n_trunc, c_in]`` of the m-primary
        input: each m>0 radial segment is shared by its cos and sin rows."""
        c_in = self.c_in
        m_sizes = self.mapping.m_size
        rad = self.RadialMLP_0(x_edge)
        parts = [rad[:, : m_sizes[0] * c_in]]
        off = m_sizes[0] * c_in
        for s in m_sizes[1:]:
            seg = rad[:, off : off + s * c_in]
            parts.extend((seg, seg))
            off += s * c_in
        return torch.cat(parts, dim=-1).reshape(x_edge.shape[0], self.mapping.n_trunc, c_in)

    def forward(self, x: torch.Tensor, x_edge: torch.Tensor | None = None):
        E = x.shape[0]
        c_in, Fo = self.c_in, self.features
        n0 = self.mapping.m_size[0]
        xm = x.reshape(E, -1)
        if self.RadialMLP_0 is not None:
            xm = xm * self.radial(x_edge).reshape(E, -1).to(xm.dtype)

        dt = compute_dtype()
        ws, b = self.section_weights()
        ws = [w.to(dt) for w in ws]
        xm = xm.to(dt)
        y0 = xm[:, : n0 * c_in] @ ws[0] + b.to(dt)
        outs = [y0[:, : n0 * Fo]]
        off = n0 * c_in
        for W in ws[1:]:
            rows = W.shape[0] // c_in
            outs.append(xm[:, off : off + rows * c_in] @ W)
            off += rows * c_in
        out = torch.cat(outs, dim=-1).reshape(E, self.mapping.n_trunc, Fo)
        if self.extra:
            return out, y0[:, n0 * Fo :]
        return out
