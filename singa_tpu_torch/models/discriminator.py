"""Discriminators of the adversarial loop (counterpart of
``singa_tpu/models/discriminator.py``; the reference's Discriminator.py is
an empty placeholder and its only discriminator code is a GIN prototype,
vanilla/vanillaModel.py:144-180):

* ``GINDiscriminatorDense``: graph-level real/fake score of ligand graphs
  given as node features and a dense adjacency, differentiable in both (the
  form WGAN-GP needs at interpolated graphs);
* ``SeqDiscriminator``: transformer encoder over token sequences with a
  masked mean pool, taking token ids or soft one-hots.

Both keep the flax module names as attributes, so ``params.load_flax_params``
carries the JAX package's weights over. The JAX package applies both without
dropout rngs, so its ``nn.Dropout`` layers are deterministic: the port has
none. The edge-list ``GINConv`` / ``GINDiscriminator`` have no caller in the
GAN and are not ported (ROADMAP, Queue 1 item 6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from singa_tpu_torch.config import PAD_TOKEN
from singa_tpu_torch.equivariant.layers import Linear, normal_
from singa_tpu_torch.equivariant.so3 import as_const
from singa_tpu_torch.models.cpromg import _pe_table

# flax's nn.LayerNorm() default (the port's encoder LayerNorms set torch's 1e-5)
FLAX_LN_EPS = 1e-6


class GINDiscriminatorDense(nn.Module):
    """GIN over a dense adjacency [B, N, N] (agg = A @ h), sum pooling and an
    MLP head; returns one raw logit per graph."""

    def __init__(self, in_features: int, hidden: int = 128, out_channels: int = 64,
                 num_layers: int = 3, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"conv_{i}_1", Linear(in_features if i == 0 else hidden, hidden,
                                                device=device))
            setattr(self, f"conv_{i}_2", Linear(hidden, hidden, device=device))
        self.mlp_1 = Linear(hidden, hidden, device=device)
        self.mlp_2 = Linear(hidden, out_channels, device=device)
        self.head = Linear(out_channels, 1, device=device)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
        """x [B, N, F], adj [B, N, N] (0/1 or interpolated), node_mask [B, N]
        -> logits [B]."""
        m = node_mask.to(x.dtype)[..., None]
        h = x * m
        for i in range(self.num_layers):
            h = h + torch.einsum("bnm,bmf->bnf", adj, h)
            h = F.relu(getattr(self, f"conv_{i}_1")(h))
            h = F.relu(getattr(self, f"conv_{i}_2")(h)) * m
        g = F.relu(self.mlp_1(h.sum(dim=1)))  # global_add_pool (vanillaModel.py:170)
        return self.head(self.mlp_2(g))[:, 0]


class _DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` as MultiHeadDotProductAttention holds it: a
    kernel in flax's layout ([in, H, d] for query/key/value, [H, d, out] for
    out) with lecun-normal initialisation over ``fan_in``, a zero bias."""

    def __init__(self, kernel_shape, bias_shape, fan_in: int, device=None):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = nn.Parameter(torch.empty(kernel_shape, device=device))
        self.bias = nn.Parameter(torch.empty(bias_shape, device=device))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        # variance_scaling(1, fan_in, truncated_normal): the std of the normal
        # truncated at +-2 is 0.8796 of the untruncated one
        std = math.sqrt(1.0 / self.fan_in) / 0.87962566103423978
        w = torch.empty(self.kernel.shape)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
        self.kernel.copy_(w)
        self.bias.zero_()


class _MHA(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, qkv and out
    features = C): q scaled by 1/sqrt(head_dim), blocked keys set to the
    float32 minimum before the softmax."""

    def __init__(self, channels: int, num_heads: int, device=None):
        super().__init__()
        H, d = num_heads, channels // num_heads
        self.head_dim = d
        self.query = _DenseGeneral((channels, H, d), (H, d), channels, device)
        self.key = _DenseGeneral((channels, H, d), (H, d), channels, device)
        self.value = _DenseGeneral((channels, H, d), (H, d), channels, device)
        self.out = _DenseGeneral((H, d, channels), (channels,), channels, device)

    def forward(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """x [B, T, C]; keep [B, T] True where a key may be attended."""
        proj = lambda p: torch.einsum("btc,chd->bthd", x, p.kernel) + p.bias
        q = proj(self.query) / math.sqrt(self.head_dim)
        w = torch.einsum("bqhd,bkhd->bhqk", q, proj(self.key))
        w = torch.where(keep[:, None, None, :], w, torch.finfo(w.dtype).min)
        ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(w, dim=-1), proj(self.value))
        return torch.einsum("bqhd,hdc->bqc", ctx, self.out.kernel) + self.out.bias


class SeqDiscriminator(nn.Module):
    """Pre-LN transformer encoder over token sequences, masked mean pool,
    LayerNorm and a linear head; one raw logit per sequence."""

    def __init__(self, vocab_size: int, hidden: int = 256, num_layers: int = 4,
                 num_heads: int = 4, pad_token: int = PAD_TOKEN, device=None):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.pad_token = pad_token
        self.embedding = nn.Parameter(torch.empty(vocab_size, hidden, device=device))
        ln = lambda: nn.LayerNorm(hidden, eps=FLAX_LN_EPS, device=device)
        # flax numbers the auto-named LayerNorm_k / Linear_k in call order
        for i in range(num_layers):
            setattr(self, f"LayerNorm_{2 * i}", ln())
            setattr(self, f"attn_{i}", _MHA(hidden, num_heads, device))
            setattr(self, f"LayerNorm_{2 * i + 1}", ln())
            setattr(self, f"Linear_{2 * i}", Linear(hidden, 2 * hidden, device=device))
            setattr(self, f"Linear_{2 * i + 1}", Linear(2 * hidden, hidden, device=device))
        setattr(self, f"LayerNorm_{2 * num_layers}", ln())
        self.head = Linear(hidden, 1, device=device)

    def init_params(self, gen: torch.Generator) -> None:
        normal_(self.embedding, gen)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids [B, T] or soft one-hots [B, T, V] -> logits [B]."""
        if tokens.dim() == 2:
            x = F.embedding(tokens.long(), self.embedding)
            pad = tokens == self.pad_token
        else:
            x = torch.einsum("btv,vc->btc", tokens, self.embedding)
            pad = tokens[..., self.pad_token] > 0.5
        x = x + as_const(_pe_table(x.shape[1], self.hidden), x.device)[None]
        keep = ~pad
        for i in range(self.num_layers):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"LayerNorm_{2 * i}")(x), keep)
            y = getattr(self, f"Linear_{2 * i}")(getattr(self, f"LayerNorm_{2 * i + 1}")(x))
            x = x + getattr(self, f"Linear_{2 * i + 1}")(F.gelu(y, approximate="tanh"))
        w = keep.to(x.dtype)[..., None]
        pooled = (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
        return self.head(getattr(self, f"LayerNorm_{2 * self.num_layers}")(pooled))[:, 0]
