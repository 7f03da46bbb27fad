"""Split TF32, the arithmetic of K4's and K4b's grid transforms and of K6's
and K6b's conv and weight-gradient products on the tensor cores
(``singa_tpu_torch/csrc/mma_tf32.cuh``, ``csrc/s2_grid_tc.cuh``,
``csrc/so2_chain.cuh``), rendered in plain PyTorch on the CPU.

``tf32_rna`` is ``cvt.rna.tf32.f32`` by integer bit operations: round to
nearest with ties away from zero, to 10 explicit mantissa bits. The split
product is the kernel's three TF32 products, ``lo_a hi_b + hi_a lo_b +
hi_a hi_b`` with ``hi = tf32_rna(x)`` and ``lo = x - hi`` cut to TF32
toward zero; each product of two TF32 values is exact in float32, so
float32 matrix products of the halves give what the tensor cores form, up
to the order of the sums.

At the main path's grid (lmax 6, ``_grid_mats_for(6, 6, False)``: G 210,
I 49) and hidden width 512: each of the four transforms is within 1e-6 of
its largest output of a float64 product (float32 round-off), and one TF32
product is at least 30x further off (which is why the kernel splits); the
whole K4b backward rendered on split transforms, in the kernel's column
tiles and grid chunks (and, at lmax 6, its last coefficient row in float32
as the kernel takes it), is within 1e-5 (of each output's largest
magnitude, floored at 1) / 1e-5 of ``so3_ffn_bwd_plain``. K6's outputs
and K6b's gradients with every conv product split (``so2_split``,
``so2_bwd_split``) are within 1e-5 of each output's largest magnitude of
``so2_attn_plain`` / ``so2_attn_bwd_plain`` at the default widths. K2b's
backward with its weight kernel's four per-degree products split as the
kernel takes them (``k2b_split``: rows at depth 16 for h and dmid, 8-node
tiles summed from zero over a degree's rows for dw1 and dw2) is within
1e-5 of each output's largest magnitude of ``so3_gate_ffn_bwd_plain`` at
lmax 6 and 4, H 512, C and Co of 16 or 8. K4's forward with every product
its tensor-core kernel splits (``k4_split``: h, the two grid transforms in
the grid's two halves, y per 16-channel chunk) is within 1e-5 of its
largest output of ``so3_ffn_plain``; with one TF32 product each it fails
the 1e-4 hold the kernel meets. K1's forward with its EdgeMLP products split
(``k1_split``) is within 1e-5 of its largest output of
``neighbor_attn_plain``; with one TF32 product each it fails that hold too.
K3's forward and K3b's backward with their grid transforms split
(``k3_split``, ``k3b_split``) are within 1e-5 of each output's largest
magnitude of ``s2_silu_sep_plain`` / ``s2_silu_sep_bwd_plain`` and of the
JAX package's ``s2_silu_sep`` and its VJP in interpret mode; with one TF32
product each they fail the holds ``chip_smoke.py`` holds the kernels to.
Their bfloat16 instances (``k3_split_bf16``, ``k3b_split_bf16``: bfloat16
operands, one TF32 product a product, silu(v) and h rounded to bfloat16 as
they enter the second product, float32 sums, outputs rounded once) are
within ``BF16_TOL`` of each output's largest magnitude, at most 1 % of the
elements unequal, of JAX's ``s2_silu_sep`` and its VJP at bfloat16 (Pallas
in interpret mode) and of the port's bfloat16 twins; without the inner
rounding, more than 1 % of out's and dx's elements differ from JAX's.
K5's forward and K5b's backward with their grid transforms split as their
tensor-core kernels take them (``k5_split``, ``k5b_split``: at I 49 row 48
in float32) are within 1e-5 of each output's largest magnitude of
``s2_silu_plain`` / ``s2_silu_bwd_plain`` and within the tolerances of
``tests/test_torch_s2_ffn.py`` of the JAX package's Pallas ``s2_silu`` and
its ``_bwd`` in interpret mode.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

NAMES = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]
KGC = 32  # grid points per chunk of the kernel's chain
NCOL = 64  # columns per tile: 4 nodes x 16 hidden channels
K2B_TN = 8  # nodes per tile of K2b's weight kernel
K2B_DX_HC = 16  # hidden channels per chunk of K2b's dx kernel
K4_HC = 16  # hidden channels per chunk of K4's tensor-core kernel
K2_HC = 16  # hidden channels per chunk of K2's tensor-core kernel
K3_STEP = 8  # grid points of a step of K3's and K3b's chains: the from-grid product's depth
K5_TAIL = 49  # rows at which K5's and K5b's kernels take the last row in float32


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of float32 ``x``: add half a TF32 ulp to the bits
    of the magnitude (the sign bit is untouched), then clear the 13 low
    mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """x cut to TF32 toward zero: its 13 low mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: hi = tf32(x) to nearest, lo = x - hi cut."""
    hi = tf32_rna(x)
    return hi, tf32_cut(x - hi)


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 products, float32 sums."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product."""
    return tf32_rna(a) @ tf32_rna(b)


def silu_grad(v: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(v)
    return s * (1 + v * (1 - s))


def grid_chain_split(tg, fg, X, Y, mm=mm_split):
    """mid = fg^T silu(tg X), dh = tg^T (silu'(tg X) * fg Y) for X, Y
    [tiles, I, NCOL] as the kernel forms them: tg, fg zero-padded to
    [Gp, Ip] (Gp a multiple of KGC, Ip of 16), every product through ``mm``
    (the kernel's split; ``mm_tf32`` for one TF32 product), the
    from-grid sums carried over the grid chunks in float32. Where I - 1 is a
    multiple of 16 (I = 49), the kernel takes row I - 1 in float32 on the
    CUDA cores in both transforms, from the split activations (hi + lo)."""
    G, I = tg.shape
    Gp, Ip = -(-G // KGC) * KGC, -(-I // 16) * 16
    r = I - 1 if (I - 1) % 16 == 0 else I  # rows through the split products
    tgp, fgp = (F.pad(m, (0, Ip - I, 0, Gp - G)) for m in (tg, fg))
    X, Y = (F.pad(m, (0, 0, 0, Ip - I)) for m in (X, Y))
    mid = torch.zeros_like(X)
    dh = torch.zeros_like(Y)
    for g0 in range(0, Gp, KGC):
        t, f = tgp[g0:g0 + KGC], fgp[g0:g0 + KGC]
        v = mm(t[:, :r], X[:, :r]) + t[:, r:I] @ X[:, r:I]
        u = mm(f[:, :r], Y[:, :r]) + f[:, r:I] @ Y[:, r:I]
        saf, sab = (sum(split(a)) for a in (F.silu(v), silu_grad(v) * u))
        mid[:, :r] += mm(f[:, :r].T, saf)
        dh[:, :r] += mm(t[:, :r].T, sab)
        mid[:, r:I] += f[:, r:I].T @ saf
        dh[:, r:I] += t[:, r:I].T @ sab
    return mid[:, :I], dh[:, :I]


def to_tiles(a: torch.Tensor) -> torch.Tensor:
    """[N, I, H] -> [N/4 * H/16, I, NCOL]: column h * 4 + n of a tile is
    hidden channel h of node n, as in the kernel's shared memory."""
    N, I, H = a.shape
    return a.reshape(N // 4, 4, I, H // 16, 16).permute(0, 3, 2, 4, 1).reshape(-1, I, NCOL)


def from_tiles(a: torch.Tensor, N: int, H: int) -> torch.Tensor:
    I = a.shape[1]
    return a.reshape(N // 4, H // 16, I, 16, 4).permute(0, 4, 2, 1, 3).reshape(N, I, H)


def k4b_split(x, w1, b1, wg, bg, w2, tg, fg, lmax, dy, mm=mm_split):
    """K4b's backward with the grid transforms in split TF32 (or through
    another product ``mm``) and everything else in plain float32: the
    kernel's arithmetic, in other orders. Runs on the tensors' device."""
    from singa_tpu_torch.ops.cuda.so3_ffn import _l_of

    N, I, C = x.shape
    H = w1.shape[2]
    l_of = _l_of(lmax, x.device)
    g0 = x[:, 0] @ wg + bg
    h = torch.einsum("nic,ich->nih", x, w1.index_select(0, l_of))
    h[:, 0] += b1
    dmid = torch.einsum("nio,iho->nih", dy, w2.index_select(0, l_of))
    dg0 = silu_grad(g0) * dmid[:, 0]
    dmid[:, 0] = 0
    mid, dh = grid_chain_split(tg, fg, to_tiles(h), to_tiles(dmid), mm)
    mid, dh = from_tiles(mid, N, H), from_tiles(dh, N, H)
    mid[:, 0] = F.silu(g0)
    dx = torch.einsum("nih,ich->nic", dh, w1.index_select(0, l_of))
    dx[:, 0] += dg0 @ wg.T
    rows = [slice(l * l, (l + 1) ** 2) for l in range(lmax + 1)]  # the rows of each degree
    dw1 = torch.stack([torch.einsum("nic,nih->ch", x[:, r], dh[:, r]) for r in rows])
    dw2 = torch.stack([torch.einsum("nih,nio->ho", mid[:, r], dy[:, r]) for r in rows])
    return dx, dw1, dh[:, 0].sum(0), x[:, 0].T @ dg0, dg0.sum(0), dw2, dy[:, 0].sum(0)


def k4_split(x, w1, b1, wg, bg, w2, b2, tg, fg, lmax, mm=mm_split):
    """K4's forward (``so3_ffn_plain``'s arguments and output) as its
    tensor-core kernel takes it, with every product it splits through
    ``mm`` (split TF32 by default; ``mm_tf32`` for one TF32 product): h =
    x_i w1[l] row by row at depth C; the two grid transforms over the
    columns (node, hidden channel), which the products keep apart, so the
    kernel's 128-column tiles change nothing; the grid (zero-padded to a
    multiple of 16 points) in the two halves that the two warps of a column
    group take, each half's to-grid and from-grid product on its own and the
    halves' sums added in float32; at lmax 6 (I = 49) row 48 in float32 in
    both transforms, the to-grid one from h's row in float32 and the
    from-grid one from the split activations (hi + lo); then y_i +=
    mid_i w2[l] per chunk of K4_HC hidden channels, each chunk's product
    from zero, added in float32. The gates (row 0 of mid, exactly) and the
    biases in plain float32. Runs on the tensors' device."""
    from singa_tpu_torch.ops.cuda.so3_ffn import _l_of

    N, I, _ = x.shape
    H = w1.shape[2]
    l_of = _l_of(lmax, x.device)
    W1, W2 = w1.index_select(0, l_of), w2.index_select(0, l_of)
    gate = F.silu(x[:, 0] @ wg + bg)
    h = torch.stack([mm(x[:, i], W1[i]) for i in range(I)])  # [I, N, H]
    h[0] += b1
    cols = h.reshape(I, N * H)
    G = tg.shape[0]
    Gp = -(-G // 16) * 16
    r = I - 1 if I == 49 else I  # rows through the split products
    tgp, fgp = (F.pad(m, (0, 0, 0, Gp - G)) for m in (tg, fg))
    mid = torch.zeros_like(cols)
    for g in (slice(0, Gp // 2), slice(Gp // 2, Gp)):
        t, f = tgp[g], fgp[g]
        v = mm(t[:, :r], cols[:r]) + t[:, r:] @ cols[r:]
        act = sum(split(F.silu(v)))
        mid += torch.cat([mm(f[:, :r].T, act), f[:, r:].T @ act])
    mid = mid.reshape(I, N, H)
    mid[0] = gate
    y = torch.zeros(I, N, w2.shape[2], dtype=x.dtype, device=x.device)
    for h0 in range(0, H, K4_HC):
        c = slice(h0, h0 + K4_HC)
        y += torch.stack([mm(mid[i][:, c], W2[i][c]) for i in range(I)])
    y[0] += b2
    return y.transpose(0, 1)


def k2b_split(x, w1, b1, wg, bg, w2, lmax, dy, mm=mm_split):
    """K2b's backward with both kernels' products through ``mm`` (split TF32
    by default; ``mm_tf32`` for one TF32 product), as the kernels take them:
    h = x_i w1[l] and dmid = dy_i w2[l]^T row by row at depth C and Co (both
    kernels form the same products). The weight kernel: its gates in float32,
    dw1[l] = x^T dh and dw2[l] = mid^T dy per 8-node tile (rows past N zero),
    each tile's product over the degree's rows summed from zero and the tiles
    added in float32; dwg and the biases in plain float32. The dx kernel: its
    gates sigmoid(x_0 wg + bg) at depth C, then per hidden chunk of
    K2B_DX_HC channels dx_i += dh_i w1[l]^T and row 0's dg0 wg^T over every
    degree, each chunk's products summed from zero and the chunks added in
    float32 in order (the kernel's 16-node tiles change nothing in a product
    over the hidden: each node's row is its own). Same arguments and outputs
    as ``so3_gate_ffn_bwd_plain``."""
    from singa_tpu_torch.ops.cuda.so3_ffn import _l_of

    N, I, C = x.shape
    H = w1.shape[2]
    l_of = _l_of(lmax, x.device)
    W1, W2 = w1.index_select(0, l_of), w2.index_select(0, l_of)
    h = torch.stack([mm(x[:, i], W1[i]) for i in range(I)], dim=1)
    dmid = torch.stack([mm(dy[:, i], W2[i].T) for i in range(I)], dim=1)
    rows = [slice(l * l, (l + 1) ** 2) for l in range(lmax + 1)]
    dgate = torch.stack([(dmid[:, r] * h[:, r]).sum(1) for r in rows[1:]], dim=1)
    v0 = h[:, 0] + b1

    def chain(gates):
        """dh [N, I, H] and dg0 [N, lmax, H] from the gates [N, lmax, H]."""
        g = gates.index_select(1, l_of[1:] - 1)
        dh = torch.cat([(silu_grad(v0) * dmid[:, 0])[:, None], dmid[:, 1:] * g], dim=1)
        return dh, gates * (1 - gates) * dgate

    # the weight kernel
    gates = torch.sigmoid(x[:, 0] @ wg + bg).reshape(N, lmax, H)
    dh, dg0 = chain(gates)
    dg0 = dg0.reshape(N, lmax * H)
    mid = torch.cat([F.silu(v0)[:, None], h[:, 1:] * gates.index_select(1, l_of[1:] - 1)], dim=1)
    pad = -N % K2B_TN
    tiles = lambda a, r: F.pad(a[:, r], (0, 0, 0, 0, 0, pad)).reshape(
        -1, K2B_TN * (r.stop - r.start), a.shape[2])
    dw1 = torch.stack([mm(tiles(x, r).transpose(1, 2), tiles(dh, r)).sum(0) for r in rows])
    dw2 = torch.stack([mm(tiles(mid, r).transpose(1, 2), tiles(dy, r)).sum(0) for r in rows])
    # the dx kernel
    dh_x, dg0_x = chain(torch.sigmoid(mm(x[:, 0], wg) + bg).reshape(N, lmax, H))
    dh_x, dg0_x = dh_x.transpose(0, 1), dg0_x.transpose(0, 1)  # [I, N, H], [lmax, N, H]
    wgl = wg.reshape(C, lmax, H).transpose(0, 1)  # [lmax, C, H]
    dx = torch.zeros(I, N, C, dtype=x.dtype, device=x.device)
    for h0 in range(0, H, K2B_DX_HC):
        c = slice(h0, h0 + K2B_DX_HC)
        dx += mm(dh_x[:, :, c], W1[:, :, c].transpose(1, 2))
        dx[0] += mm(dg0_x[:, :, c], wgl[:, :, c].transpose(1, 2)).sum(0)
    return (dx.transpose(0, 1), dw1, dh[:, 0].sum(0), x[:, 0].T @ dg0, dg0.sum(0), dw2,
            dy[:, 0].sum(0))


def k2_split(x, w1, b1, wg, bg, w2, b2, lmax, mm=mm_split):
    """K2's forward (``so3_gate_ffn_plain``'s arguments and output) as its
    tensor-core kernel takes it, with every product through ``mm`` (split
    TF32 by default; ``mm_tf32`` for one TF32 product): the gates
    sigmoid(x_0 wg + bg) at depth C; then per chunk of K2_HC hidden channels
    and per row i of degree l, h = x_i w1[l] at depth C, mid = silu(h + b1)
    on row 0 and h gate_l elsewhere, and y_i's product mid w2[l] at depth
    K2_HC from zero, the chunks' products added in float32 in order; b2 on
    row 0 at the end. The kernel's 16-node tiles change nothing: each node's
    row is its own. Runs on the tensors' device."""
    from singa_tpu_torch.ops.cuda.so3_ffn import _l_of

    N, I, _ = x.shape
    H = w1.shape[2]
    l_of = _l_of(lmax, x.device)
    W1, W2 = w1.index_select(0, l_of), w2.index_select(0, l_of)  # [I, C, H], [I, H, Co]
    gates = torch.sigmoid(mm(x[:, 0], wg) + bg).reshape(N, lmax, H)
    gates = gates.index_select(1, l_of[1:] - 1).transpose(0, 1)  # [I - 1, N, H]
    X = x.transpose(0, 1)  # [I, N, C]
    y = torch.zeros(I, N, w2.shape[2], dtype=x.dtype, device=x.device)
    for h0 in range(0, H, K2_HC):
        c = slice(h0, h0 + K2_HC)
        h = mm(X, W1[:, :, c])
        mid = torch.cat([F.silu(h[:1] + b1[c]), h[1:] * gates[:, :, c]])
        y += mm(mid, W2[:, c])
    y[0] += b2
    return y.transpose(0, 1)


def _columns(a: torch.Tensor) -> torch.Tensor:
    """[E, I, C] -> [I, E * C]: the flat (edge, channel) columns of K3's and
    K3b's tensor-core kernels."""
    E, I, C = a.shape
    return a.transpose(0, 1).reshape(I, E * C)


def k3_split(x, s, tg, fg, mm=mm_split):
    """K3's forward (``s2_silu_sep_plain``'s arguments and output) as its
    tensor-core kernel takes it, with its two products through ``mm`` (split
    TF32 by default; ``mm_tf32`` for one TF32 product): v = tg X over the
    flat (edge, channel) columns at depth I; silu(v); the from-grid sums
    fg^T silu(v) step by step over K3_STEP grid points, each step's product
    added in float32 in order; row 0 replaced by silu(s). The kernel's
    32-column warp tiles change nothing: each column is its own. Runs on the
    tensors' device."""
    E, I, C = x.shape
    act = F.silu(mm(tg, _columns(x)))
    out = torch.zeros(I, E * C, dtype=x.dtype, device=x.device)
    for g0 in range(0, tg.shape[0], K3_STEP):
        out += mm(fg[g0:g0 + K3_STEP].T, act[g0:g0 + K3_STEP])
    out = out.reshape(I, E, C).transpose(0, 1).clone()
    out[:, 0] = F.silu(s)
    return out


def k3b_split(x, s, tg, fg, g, mm=mm_split):
    """K3b's (dx, ds) (``s2_silu_sep_bwd_plain``'s arguments and outputs) as
    its tensor-core kernel takes them, with its three products through
    ``mm``: v = tg X and u = fg' Y at depth I (fg' = fg with column 0
    zeroed: row 0 of the cotangent reaches only ds); h = silu'(v) u; dx =
    tg^T h step by step over K3_STEP grid points, each step's product added
    in float32 in order; ds = silu'(s) g[:, 0] in float32. Runs on the
    tensors' device."""
    E, I, C = x.shape
    fgz = fg.clone()
    fgz[:, 0] = 0
    h = silu_grad(mm(tg, _columns(x))) * mm(fgz, _columns(g))
    dx = torch.zeros(I, E * C, dtype=x.dtype, device=x.device)
    for g0 in range(0, tg.shape[0], K3_STEP):
        dx += mm(tg[g0:g0 + K3_STEP].T, h[g0:g0 + K3_STEP])
    return dx.reshape(I, E, C).transpose(0, 1).contiguous(), silu_grad(s) * g[:, 0]


def _rounded_bf16(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to bfloat16 (to nearest even) and back."""
    return a.to(torch.bfloat16).float()


def k3_split_bf16(x, s, tg, fg, inner: bool = True):
    """K3's bfloat16 instance as its tensor-core kernel takes it, at
    bfloat16 x, s, tg and fg (``s2_silu_sep_bf16_plain``'s arguments): v =
    tg X over the flat (edge, channel) columns as one TF32 product
    (``mm_tf32``: exact for bfloat16 operands); silu(v) rounded to bfloat16
    as it enters the from-grid product (``inner``; the Pallas kernel's
    ``.astype(dt)``, ``singa_tpu/ops/pallas/s2_act.py:142``); the from-grid
    sums fg^T silu(v) step by step over K3_STEP grid points, each step's
    one-product sum added in float32 in order; row 0 silu(s) in float32;
    the output rounded once to bfloat16. ``inner=False``: the same without
    the inner rounding (silu(v) goes in as TF32)."""
    E, I, C = x.shape
    act = F.silu(mm_tf32(tg.float(), _columns(x.float())))
    if inner:
        act = _rounded_bf16(act)
    out = torch.zeros(I, E * C)
    for g0 in range(0, tg.shape[0], K3_STEP):
        out += mm_tf32(fg[g0:g0 + K3_STEP].float().T, act[g0:g0 + K3_STEP])
    out = out.reshape(I, E, C).transpose(0, 1).clone()
    out[:, 0] = F.silu(s.float())
    return out.to(torch.bfloat16)


def k3b_split_bf16(x, s, tg, fg, g, inner: bool = True):
    """K3b's bfloat16 instance as its tensor-core kernel takes it, at
    bfloat16 inputs (``s2_silu_sep_bf16_bwd_plain``'s): v = tg X and u =
    fg' Y (fg' = fg with column 0 zeroed) each as one TF32 product; h =
    silu'(v) u in float32, rounded to bfloat16 as it enters dx's product
    (``inner``; ``s2_act.py:160``); dx = tg^T h step by step over K3_STEP
    grid points in float32, rounded once; ds = silu'(s) g[:, 0] in float32,
    rounded once. ``inner=False``: h goes in as TF32."""
    E, I, C = x.shape
    fgz = fg.float().clone()
    fgz[:, 0] = 0
    h = (silu_grad(mm_tf32(tg.float(), _columns(x.float())))
         * mm_tf32(fgz, _columns(g.float())))
    if inner:
        h = _rounded_bf16(h)
    dx = torch.zeros(I, E * C)
    for g0 in range(0, tg.shape[0], K3_STEP):
        dx += mm_tf32(tg[g0:g0 + K3_STEP].float().T, h[g0:g0 + K3_STEP])
    ds = silu_grad(s.float()) * g[:, 0].float()
    return dx.reshape(I, E, C).transpose(0, 1).to(torch.bfloat16), ds.to(torch.bfloat16)


def _tail_rows(I: int) -> int:
    """Rows K5's and K5b's tensor-core kernels take through mma: all but
    the last at I = K5_TAIL (the full lmax-6 grid), else all."""
    return I - 1 if I == K5_TAIL else I


def k5_split(x, tg, fg, mm=mm_split):
    """K5's forward (``s2_silu_plain``'s arguments and output) as its
    tensor-core kernel takes it, with its two products through ``mm``: v =
    tg X over the flat (node, channel) columns; silu(v); the from-grid sums
    fg^T silu(v) step by step over K3_STEP grid points, each step's product
    added in float32 in order. At I 49 row 48 stays out of the products: in
    float32, a rank-one term of v, and output row 48 from the split
    activations (hi + lo). Runs on the tensors' device."""
    N, I, C = x.shape
    r = _tail_rows(I)
    X = _columns(x)
    act = F.silu(mm(tg[:, :r], X[:r]) + tg[:, r:] @ X[r:])
    out = torch.zeros(I, N * C, dtype=x.dtype, device=x.device)
    for g0 in range(0, tg.shape[0], K3_STEP):
        out[:r] += mm(fg[g0:g0 + K3_STEP, :r].T, act[g0:g0 + K3_STEP])
    out[r:] = fg[:, r:].T @ sum(split(act))
    return out.reshape(I, N, C).transpose(0, 1).contiguous()


def k5b_split(x, tg, fg, g, mm=mm_split):
    """K5b's dx (``s2_silu_bwd_plain``'s arguments and output) as its
    tensor-core kernel takes it, with its three products through ``mm``: v =
    tg X and u = fg Y; h = silu'(v) u; dx = tg^T h step by step over K3_STEP
    grid points, each step's product added in float32 in order. At I 49 row
    48 stays out of the products: in float32, rank-one terms of v and u, and
    dx row 48 from h unsplit. Runs on the tensors' device."""
    N, I, C = x.shape
    r = _tail_rows(I)
    X, Y = _columns(x), _columns(g)
    h = (silu_grad(mm(tg[:, :r], X[:r]) + tg[:, r:] @ X[r:])
         * (mm(fg[:, :r], Y[:r]) + fg[:, r:] @ Y[r:]))
    dx = torch.zeros(I, N * C, dtype=x.dtype, device=x.device)
    for g0 in range(0, tg.shape[0], K3_STEP):
        dx[:r] += mm(tg[g0:g0 + K3_STEP, :r].T, h[g0:g0 + K3_STEP])
    dx[r:] = tg[:, r:].T @ h
    return dx.reshape(I, N, C).transpose(0, 1).contiguous()


def k1_split(*args, mm=mm_split):
    """K1's forward (``neighbor_attn_plain``'s arguments and output) as its
    tensor-core kernel takes it (``tests/test_torch_list_live.py``'s
    rendering: live slots and the dead-weighted rows' slots packed into
    tiles of at most 128 slot rows), with the products the kernel runs on
    the tensor cores through ``mm`` (split TF32 by default; ``mm_tf32`` for
    one TF32 product): both EdgeMLPs on the live slots (depth De, then kd or
    vd), the v-EdgeMLP alone on the dead-weighted rows' slots. The scores,
    the softmax and the aggregate in plain float32."""
    from test_torch_list_live import list_forward

    return list_forward(*args, mm=mm)


def k1b_split(*args, mm=mm_split):
    """K1b's backward (``neighbor_attn_bwd_plain``'s arguments and outputs)
    as its kernel takes it (``tests/test_torch_list_live.py``'s rendering:
    the live slots of consecutive rows packed into tiles of at most 128 slot
    rows), with the products the kernel runs on the tensor cores through
    ``mm`` (split TF32 by default; ``mm_tf32`` for one TF32 product): both
    EdgeMLPs (depth De, then kd or vd), dh = dw W2^T (depth kd or vd), and
    the four weight gradients over each tile's slots, each tile's products
    summed from zero and added in float32. The scores, the softmax, dqt, dw,
    dk/dv and the biases in plain float32."""
    from test_torch_list_live import list_backward

    return list_backward(*args, mm=mm)


class MM(torch.autograd.Function):
    """a @ b through ``mm`` both ways: the forward ``mm(a, b)``, the
    backward ``mm(g, b^T)`` and ``mm(a^T, g)``, the orientations of the
    SO(2) chain's GEMM (NN, NT, TN)."""

    @staticmethod
    def forward(ctx, a, b, mm):
        ctx.save_for_backward(a, b)
        ctx.mm = mm
        return mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return ctx.mm(g, b.T.contiguous()), ctx.mm(a.T.contiguous(), g), None


def so2_split(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
              lmax: int, mmax: int, H: int, F2: int, alpha_ch: int, mm=mm_split):
    """``so2_attn_plain`` with every conv product through ``MM`` (split TF32
    by default, as K6 and K6b form them; ``mm_tf32`` for one TF32 product),
    the rotation and the S2 activation in plain float32."""
    from singa_tpu_torch.equivariant import so3
    from singa_tpu_torch.ops.cuda.s2_act import s2_silu_sep_plain
    from singa_tpu_torch.ops.cuda.so2_attn import sections

    secs = sections(lmax, mmax)
    n0 = secs[0]
    E, _, c_in = x.shape
    mp = so3.rotate(so3.EdgeFrame(phi=phi, beta=beta), x, lmax, mmax, m_primary=True)
    flat = (mp * rad).reshape(E, sum(secs) * c_in)
    ys, off = [], 0
    for w, rows in zip(w1s, secs):
        ys.append(MM.apply(flat[:, off : off + rows * c_in].contiguous(), w, mm))
        off += rows * c_in
    ys[0] = ys[0] + b1
    extra = ys[0][:, n0 * H :]
    h = torch.cat(
        [ys[0][:, : n0 * H].reshape(E, n0, H)]
        + [y.reshape(E, rows, H) for y, rows in zip(ys[1:], secs[1:])],
        dim=1,
    )
    mid = s2_silu_sep_plain(h, extra[:, alpha_ch:], to_grid, from_grid).reshape(E, sum(secs) * H)
    zs, off = [], 0
    for w, rows in zip(w2s, secs):
        zs.append(MM.apply(mid[:, off : off + rows * H].contiguous(), w, mm))
        off += rows * H
    zs[0] = zs[0] + b2
    return (*zs, extra)


def so2_bwd_split(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                  lmax: int, mmax: int, H: int, F2: int, alpha_ch: int, *cts, mm=mm_split):
    """``so2_attn_bwd_plain`` over ``so2_split``: K6b's ten gradients with
    conv 1 recomputed, dw2, dmid, dw1 and dmpr through ``mm``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, rad, *w1s, b1, *w2s)]
        n1 = len(w1s)
        b2 = x.new_zeros((w2s[0].shape[1],), requires_grad=True)
        out = so2_split(leaves[0], leaves[1], phi, beta, leaves[2 : 2 + n1], leaves[2 + n1],
                        leaves[3 + n1 :], b2, to_grid, from_grid, lmax, mmax, H, F2, alpha_ch,
                        mm=mm)
        return torch.autograd.grad(out, (*leaves, b2), cts)


SO2_OUTS = ["z0", "z1", "z2", "extra"]
SO2_GRADS = ["dx", "drad", "dw1_0", "dw1_1", "dw1_2", "db1", "dw2_0", "dw2_1", "dw2_2", "db2"]


def rel_errs(got, want, names):
    """Each output's largest |got - want| over its largest magnitude."""
    return {n: ((a - b).abs().max() / b.abs().max()).item() for n, a, b in zip(names, got, want)}


def test_tf32_rna_rounds_to_nearest_ties_away():
    """Ten explicit mantissa bits kept; half a TF32 ulp rounds away from
    zero for either sign; just under half rounds down; 13 low bits clear."""
    e = 2.0 ** -10  # the TF32 ulp at 1
    x = torch.tensor([1 + e / 2, -(1 + e / 2), 1 + e / 2 - 2.0 ** -23, 1 + 1.5 * e, 3.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + e, -(1 + e), 1.0, 1 + 2 * e, 3.0, -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want)
    r = torch.as_tensor(np.random.default_rng(0).normal(size=4096).astype(np.float32)) * 1e3
    assert bool(((tf32_rna(r).view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((tf32_rna(r) - r).abs() <= r.abs() * 2.0 ** -11).all())


def _split_np(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """mma_tf32.cuh's split on float32 bit patterns (uint32), in numpy:
    hi = the bits plus half a TF32 ulp, 13 low bits cleared; lo = x - hi in
    float32, cut the same way. Returns (hi, lo) as bit patterns."""
    hi = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    diff = bits.view(np.float32) - hi.view(np.float32)
    return hi, diff.view(np.uint32) & np.uint32(0xFFFFE000)


def test_bf16_values_are_tf32_values_and_multiply_exactly():
    """The premise of K1b's and K2b's bfloat16 tensor-core instances (one
    TF32 product where float32 takes three). Over every finite bfloat16 bit
    pattern, the TF32 split of its float32 value has hi = the value and lo =
    0 (7 mantissa bits fit in TF32's 10), so the two products with lo are
    zero. The product of two bfloat16 values (8 x 8 significant bits) is
    exact in float32 wherever it is a normal float32: every finite value
    times each of the 256 values of [1, 2) of either sign (every pair of
    significands, at every exponent of the first), and 2**20 random pairs
    of finite patterns (every pair of exponents), against float64."""
    pat = np.arange(1 << 16, dtype=np.uint32)
    finite = ((pat >> 7) & 0xFF) != 0xFF
    bits = pat[finite] << 16  # each bfloat16 value's float32 bits
    hi, lo = _split_np(bits)
    assert np.array_equal(hi, bits)
    assert not lo.any()
    vals = bits.view(np.float32)
    tiny, big = np.finfo(np.float32).tiny, np.finfo(np.float32).max

    def exact_where_normal(a, b, share):
        want = a.astype(np.float64) * b.astype(np.float64)
        normal = (np.abs(want) >= tiny) & (np.abs(want) <= big)
        got = (a * b).astype(np.float64)  # float32 product, widened without loss
        assert normal.mean() > share
        assert np.array_equal(got[normal], want[normal])

    sig = ((np.uint32(0x3F80) | np.arange(128, dtype=np.uint32)) << 16).view(np.float32)
    rng = np.random.default_rng(24)
    pick = lambda: vals[rng.integers(0, vals.size, size=1 << 20)]
    with np.errstate(over="ignore", under="ignore"):
        for b in np.concatenate([sig, -sig]):
            exact_where_normal(vals, np.float32(b), 0.9)
        exact_where_normal(pick(), pick(), 0.4)


@pytest.mark.parametrize("transform", ["v = tg h", "u = fg dmid", "mid = fg^T s", "dh = tg^T s"])
def test_split_transforms_match_float64(transform):
    """Each of K4b's four grid transforms at the main path's grid, on
    [49, 512] (to-grid) or [210, 512] (from-grid) normal columns: the split
    within 1e-6 of the float64 product's largest output, one TF32 product
    at least 30x further off."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for

    tg, fg = (torch.as_tensor(m) for m in _grid_mats_for(6, 6, False))
    mat = {"v": tg, "u": fg, "mid": fg.T, "dh": tg.T}[transform.split()[0]].contiguous()
    rng = np.random.default_rng(7 + len(transform))
    cols = torch.as_tensor(rng.normal(size=(mat.shape[1], 512)).astype(np.float32))
    want = mat.double() @ cols.double()
    scale = want.abs().max().item()
    err_split = (mm_split(mat, cols).double() - want).abs().max().item() / scale
    err_tf32 = (mm_tf32(mat, cols).double() - want).abs().max().item() / scale
    assert err_split <= 1e-6, err_split
    assert err_tf32 >= 30 * err_split, (err_tf32, err_split)


@pytest.mark.parametrize("lmax,N,H,C,Co", [(6, 8, 512, 16, 16), (2, 12, 48, 8, 4)])
def test_k4b_split_matches_plain_backward(lmax, N, H, C, Co):
    """dx and the six weight and bias gradients of the s2 FFN, with K4b's
    grid transforms in split TF32 (Ip padded to 16s, Gp to 32s, 64-column
    tiles), against ``so3_ffn_bwd_plain`` (float32 throughout): within 1e-5
    of each output's largest magnitude, rtol 1e-5; non-zero biases."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda.so3_ffn import so3_ffn_bwd_plain

    L = lmax + 1
    rng = np.random.default_rng(11 + N)
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    tg, fg = (torch.as_tensor(m) for m in _grid_mats_for(lmax, lmax, False))
    args = [f(N, L * L, C), 0.2 * f(L, C, H), 0.1 * f(H), 0.2 * f(C, H), 0.1 * f(H),
            0.1 * f(L, H, Co), tg, fg, lmax, f(N, L * L, Co)]
    got = k4b_split(*args)
    want = so3_ffn_bwd_plain(*args)
    for name, a, b in zip(NAMES, got, want):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=1e-5, msg=name)


def test_so2_split_matches_plain_at_default_widths():
    """K6's outputs and K6b's ten gradients with every conv product (conv 1,
    conv 2, and backward dmid, dmpr, dw1, dw2) in split TF32, at the default
    Config's widths (lmax 6, c_in 32, H 128, F2 112, 224 alpha channels)
    and 300 edges, against ``so2_attn_plain`` / ``so2_attn_bwd_plain``
    (float32): within 1e-5 of each output's largest magnitude. The same
    rendering with one TF32 product is at least 30x further off on every
    output that a product reaches (db2 is the column sum of dz0, with no
    product on its path, and is exact in both)."""
    from test_torch_cuda import _so2_bwd_args, _so2_case

    from singa_tpu_torch.ops.cuda.so2_attn import so2_attn_bwd_plain, so2_attn_plain

    args, cts = _so2_case("cpu", 300, 6, 32, 128, 112, 224, 17)
    bwd = _so2_bwd_args(args, cts)
    want = so2_attn_plain(*args)
    want_g = so2_attn_bwd_plain(*bwd)
    split = {**rel_errs(so2_split(*args), want, SO2_OUTS),
             **rel_errs(so2_bwd_split(*bwd), want_g, SO2_GRADS)}
    one = {**rel_errs(so2_split(*args, mm=mm_tf32), want, SO2_OUTS),
           **rel_errs(so2_bwd_split(*bwd, mm=mm_tf32), want_g, SO2_GRADS)}
    assert max(split.values()) <= 1e-5, split
    assert one["db2"] == split["db2"] == 0.0, (one["db2"], split["db2"])
    for name in SO2_OUTS + SO2_GRADS[:-1]:
        assert one[name] >= 30 * split[name], (name, one[name], split[name])


@pytest.mark.parametrize("lmax,N,H,C,Co", [(6, 13, 512, 16, 16), (2, 13, 48, 8, 4)])
def test_k4_split_matches_plain_forward(lmax, N, H, C, Co):
    """K4's output with every product its tensor-core kernel splits rendered
    in split TF32 (``k4_split``: h and y at depth C and 16 hidden channels a
    chunk, the grid transforms in the two halves of the grid, row 48 in
    float32 at lmax 6), N not a multiple of the 8-node tile, non-zero
    biases: within 1e-5 of the output's largest magnitude of
    ``so3_ffn_plain`` (float32). The same rendering with one TF32 product in
    place of each split one fails the 1e-4 hold (atol and rtol 1e-4) that
    ``chip_smoke.py`` holds the kernel to."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda.so3_ffn import so3_ffn_plain

    L = lmax + 1
    rng = np.random.default_rng(19 + lmax)
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    tg, fg = (torch.as_tensor(m) for m in _grid_mats_for(lmax, lmax, False))
    args = [f(N, L * L, C), 0.2 * f(L, C, H), 0.1 * f(H), 0.2 * f(C, H), 0.1 * f(H),
            0.1 * f(L, H, Co), 0.1 * f(Co), tg, fg, lmax]
    want = so3_ffn_plain(*args)
    split_err = rel_errs([k4_split(*args)], [want], ["y"])["y"]
    one = k4_split(*args, mm=mm_tf32)
    hold_ratio = ((one - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    assert split_err <= 1e-5, split_err
    assert hold_ratio > 1.0, hold_ratio


@pytest.mark.parametrize("lmax,N,C,Co", [(6, 37, 16, 16), (4, 29, 16, 16), (6, 37, 8, 8),
                                         (4, 29, 16, 8)])
def test_k2b_split_matches_plain_backward(lmax, N, C, Co):
    """dx and the six weight and bias gradients of the gate FFN, with both
    K2b kernels' products in split TF32 (``k2b_split``: the weight kernel's
    h, dmid, dw1, dw2 over 8-node tiles, N not a multiple of 8; the dx
    kernel's gates, dx and row 0's gate term over 16-channel hidden chunks),
    at the widths the kernels take (C, Co of 16 or 8), H 512, against
    ``so3_gate_ffn_bwd_plain`` (float32): within 1e-5 of each output's
    largest magnitude. With one TF32 product in their place, every output
    the products reach is at least 30x further off (db2, the column sum of
    dy's row 0, has no product on its path and agrees in both)."""
    _check_k2b_split(lmax, N, 512, C, Co, 13 + lmax)


@pytest.mark.parametrize("lmax,N,H,C,Co", [(6, 17, 40, 16, 16), (6, 1, 512, 16, 16),
                                           (4, 17, 40, 8, 16), (6, 1, 40, 16, 8)])
def test_k2b_split_matches_plain_backward_at_ragged_edges(lmax, N, H, C, Co):
    """The same holds with H not a multiple of the hidden chunk (40) and N
    not a multiple of either kernel's node tile (1, 17)."""
    _check_k2b_split(lmax, N, H, C, Co, 17 + lmax + N)


def _check_k2b_split(lmax, N, H, C, Co, seed):
    from singa_tpu_torch.ops.cuda.so3_ffn import so3_gate_ffn_bwd_plain

    L = lmax + 1
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    args = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
            0.1 * f(lmax * H), 0.1 * f(L, H, Co), lmax, f(N, L * L, Co)]
    want = so3_gate_ffn_bwd_plain(*args)
    split = rel_errs(k2b_split(*args), want, NAMES)
    one = rel_errs(k2b_split(*args, mm=mm_tf32), want, NAMES)
    assert max(split.values()) <= 1e-5, split
    assert one["db2"] == split["db2"] <= 1e-6, (one["db2"], split["db2"])
    for name in NAMES[:-1]:
        assert one[name] >= 30 * split[name], (name, one[name], split[name])


def test_k1b_split_matches_plain_backward():
    """K1b's 13 gradients with the kernel's EdgeMLP and weight-gradient
    products in split TF32 (``k1b_split``), at the encoder's widths (H 4,
    kd 32, vd 64, De 64), K 24, random masks, a padded row with a
    cotangent: within 1e-5 of each output's largest magnitude of
    ``neighbor_attn_bwd_plain`` (float32). With one TF32 product in their
    place, every output is at least 30x further off."""
    from test_torch_cuda import _random_list_case

    from singa_tpu_torch.ops.cuda.neighbor_attn import neighbor_attn_bwd_plain

    args = _random_list_case("cpu", 2, 40, 24, 167)
    want = neighbor_attn_bwd_plain(*args)
    names = ["dqt", "dk", "dv", "dds", "ddv", "dwk1", "dbk1", "dwk2", "dbk2",
             "dwv1", "dbv1", "dwv2", "dbv2"]
    split = rel_errs(k1b_split(*args), want, names)
    one = rel_errs(k1b_split(*args, mm=mm_tf32), want, names)
    assert max(split.values()) <= 1e-5, split
    for name in names:
        assert one[name] >= 30 * split[name], (name, one[name], split[name])


def test_k1_split_matches_plain_forward():
    """K1's output with the kernel's EdgeMLP products in split TF32
    (``k1_split``), at the encoder's widths (H 4, kd 32, vd 64, De 64), K 24,
    random masks, a padded row (dead-weighted) and a real row with no live
    slot: within 1e-5 of its largest magnitude of ``neighbor_attn_plain``
    (float32). With one TF32 product in their place it fails the 1e-4 hold
    (atol and rtol 1e-4) that ``chip_smoke.py`` holds the kernel to."""
    from test_torch_cuda import _random_list_case

    from singa_tpu_torch.ops.cuda.neighbor_attn import neighbor_attn_plain

    args = _random_list_case("cpu", 2, 40, 24, 167)[:-1]
    want = neighbor_attn_plain(*args)
    split_err = rel_errs([k1_split(*args)], [want], ["out"])["out"]
    one = k1_split(*args, mm=mm_tf32)
    hold_ratio = ((one - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    assert split_err <= 1e-5, split_err
    assert hold_ratio > 1.0, hold_ratio


@pytest.mark.parametrize("lmax,N,H,C,Co", [(6, 37, 512, 16, 16), (4, 29, 512, 16, 16),
                                           (6, 37, 48, 8, 8), (5, 21, 40, 16, 8)])
def test_k2_split_matches_plain_and_pallas_forward(lmax, N, H, C, Co):
    """K2's output with every product its tensor-core kernel splits rendered
    in split TF32 (``k2_split``: the gates at depth C, h and y per row over
    16-channel hidden chunks, each chunk's y from zero), at the widths the
    kernel takes (C, Co of 16 or 8), lmax 6, 4 and 5, N not a multiple of
    the 16-node tile and, in the last case, H not a multiple of the chunk;
    non-zero biases: within 1e-5 of the output's largest magnitude of
    ``so3_gate_ffn_plain`` (float32) and of the JAX package's Pallas kernel
    ``so3_gate_ffn_fused`` in interpret mode (float32: the same function, its
    sums in other orders). The same rendering with one TF32 product in place
    of each split one fails the 1e-4 hold (atol and rtol 1e-4) that
    ``chip_smoke.py`` holds the kernel to."""
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.so3_ffn import so3_gate_ffn_fused
    from singa_tpu_torch.ops.cuda.so3_ffn import so3_gate_ffn_plain

    L = lmax + 1
    rng = np.random.default_rng(23 + lmax + N)
    f = lambda *s: (rng.normal(size=s)).astype(np.float32)
    arrays = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
              0.1 * f(lmax * H), 0.1 * f(L, H, Co), 0.1 * f(Co)]
    args = [torch.as_tensor(a) for a in arrays]
    want = so3_gate_ffn_plain(*args, lmax)
    with compute_dtype_scope("float32"):
        pallas = torch.as_tensor(np.array(
            so3_gate_ffn_fused(*(jnp.asarray(a) for a in arrays), lmax, True)))
    got = k2_split(*args, lmax)
    errs = rel_errs([got, got, pallas], [want, pallas, want], ["plain", "pallas", "pallas_plain"])
    one = k2_split(*args, lmax, mm=mm_tf32)
    hold_ratio = ((one - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    assert max(errs.values()) <= 1e-5, errs
    assert hold_ratio > 1.0, hold_ratio


def _k3_case(lmax, E, C, seed):
    """x, s, tg, fg, g of K3/K3b at mmax 2 (m-primary grid) as numpy arrays."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for

    tg, fg = _grid_mats_for(lmax, 2, True)
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    I = tg.shape[1]
    return f(E, I, C), f(E, C), tg, fg, f(E, I, C)


@pytest.mark.parametrize("lmax,E", [(6, 1), (6, 37), (4, 37), (2, 1), (2, 37)])
def test_k3_split_matches_plain_and_pallas_forward(lmax, E):
    """K3's output with both products its tensor-core kernel splits rendered
    in split TF32 (``k3_split``), at mmax 2 and lmax 6, 4 and 2 (I 29, 19,
    9; G 70, 50, 42), E of 1 and a ragged 37, C 64: within 1e-5 of its
    largest magnitude of ``s2_silu_sep_plain`` (float32) and of the JAX
    package's Pallas kernel ``s2_silu_sep`` in interpret mode (the same
    function, its sums in other orders). The same rendering with one TF32
    product in place of each split one fails the 1e-4 hold (atol and rtol
    1e-4) that ``chip_smoke.py`` holds the kernel to."""
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.s2_act import s2_silu_sep
    from singa_tpu_torch.ops.cuda.s2_act import s2_silu_sep_plain

    x, s, tg, fg, _ = _k3_case(lmax, E, 64, 29 + lmax + E)
    args = [torch.as_tensor(a) for a in (x, s, tg, fg)]
    want = s2_silu_sep_plain(*args)
    with compute_dtype_scope("float32"):
        pallas = torch.as_tensor(np.array(s2_silu_sep(jnp.asarray(x), jnp.asarray(s), tg, fg)))
    got = k3_split(*args)
    errs = rel_errs([got, got, pallas], [want, pallas, want], ["plain", "pallas", "pallas_plain"])
    one = k3_split(*args, mm=mm_tf32)
    hold_ratio = ((one - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    assert max(errs.values()) <= 1e-5, errs
    assert hold_ratio > 1.0, hold_ratio


@pytest.mark.parametrize("lmax,E", [(6, 1), (6, 37), (4, 37), (2, 1), (2, 37)])
def test_k3b_split_matches_plain_and_pallas_backward(lmax, E):
    """K3b's dx and ds with its three products in split TF32 (``k3b_split``),
    at the same cases as the forward's: within 1e-5 of each output's largest
    magnitude of ``s2_silu_sep_bwd_plain`` (float32) and of the VJP of the
    JAX package's ``s2_silu_sep`` (its Pallas ``_sep_bwd`` in interpret
    mode). With one TF32 product in their place, dx fails the hold
    ``chip_smoke.py`` holds the kernel to (1e-4 of its largest magnitude);
    ds has no product on its path and agrees in both."""
    import jax
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.s2_act import s2_silu_sep
    from singa_tpu_torch.ops.cuda.s2_act import s2_silu_sep_bwd_plain

    x, s, tg, fg, g = _k3_case(lmax, E, 64, 31 + lmax + E)
    args = [torch.as_tensor(a) for a in (x, s, tg, fg, g)]
    want = s2_silu_sep_bwd_plain(*args)
    with compute_dtype_scope("float32"):
        _, vjp = jax.vjp(lambda a, b: s2_silu_sep(a, b, tg, fg), jnp.asarray(x), jnp.asarray(s))
        pallas = [torch.as_tensor(np.array(t)) for t in vjp(jnp.asarray(g))]
    got = k3b_split(*args)
    names = ["dx", "ds"]
    errs = {**rel_errs(got, want, names),
            **{f"{n}_pallas": e for n, e in rel_errs(got, pallas, names).items()},
            **{f"{n}_pallas_plain": e for n, e in rel_errs(pallas, want, names).items()}}
    one = rel_errs(k3b_split(*args, mm=mm_tf32), want, names)
    assert max(errs.values()) <= 1e-5, errs
    assert one["dx"] > 1e-4, one
    assert one["ds"] == errs["ds"], (one, errs)


BF16_TOL = 1e-2  # chip_smoke.py's hold of a bfloat16 instance: of each output's largest magnitude
BF16_UNEQUAL = 0.01  # the share of elements that may differ (tests/test_torch_bf16_kernels.py's)


def _bf16_hold(got, want) -> tuple[float, float]:
    """(largest |got - want| over want's largest magnitude, share of
    elements unequal) of two bfloat16 outputs."""
    a, b = got.float(), torch.as_tensor(np.array(want, np.float32))
    return ((a - b).abs().max() / b.abs().max()).item(), (a != b).float().mean().item()


def _k3_bf16_jax(x, s, tg, fg, g):
    """JAX's ``s2_silu_sep`` and its VJP at bfloat16 x, s and cotangent
    (the Pallas kernels in interpret mode, which cast tg and fg to
    bfloat16), as ``tests/test_torch_bf16_kernels.py::_k3`` runs them: out,
    dx, ds as float32 numpy."""
    import jax
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.s2_act import s2_silu_sep

    bf = jnp.bfloat16
    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(lambda a, b: s2_silu_sep(a, b, tg, fg), jnp.asarray(x, bf),
                           jnp.asarray(s, bf))
        dx, ds = vjp(jnp.asarray(g, bf))
    assert out.dtype == dx.dtype == ds.dtype == bf
    return [np.asarray(t.astype(jnp.float32)) for t in (out, dx, ds)]


K3_BF16_CASES = [(6, 1), (6, 37), (4, 1), (4, 37), (2, 1), (2, 37)]


@pytest.mark.parametrize("lmax,E", K3_BF16_CASES)
def test_k3_split_bf16_matches_plain_and_pallas(lmax, E):
    """K3's and K3b's bfloat16 instances as their tensor-core kernels take
    them (``k3_split_bf16``, ``k3b_split_bf16``: one TF32 product a
    product, silu(v) and h rounded to bfloat16 as they enter the second
    product, float32 sums in K3_STEP steps, the outputs rounded once), at
    mmax 2 and lmax 6, 4 and 2 (I 29, 19, 9), E 1 and a ragged 37, C 64:
    out, dx and ds within BF16_TOL of their largest magnitude, at most
    BF16_UNEQUAL of the elements unequal, against the JAX package's
    ``s2_silu_sep`` and its VJP at bfloat16 (Pallas, interpret mode) and
    against the port's bfloat16 twins."""
    from singa_tpu_torch.ops.cuda.s2_act import (s2_silu_sep_bf16_bwd_plain,
                                                 s2_silu_sep_bf16_plain)

    x, s, tg, fg, g = _k3_case(lmax, E, 64, 37 + lmax + E)
    jax_outs = _k3_bf16_jax(x, s, tg, fg, g)
    args = [torch.as_tensor(a).to(torch.bfloat16) for a in (x, s, tg, fg)]
    gb = torch.as_tensor(g).to(torch.bfloat16)
    got = [k3_split_bf16(*args), *k3b_split_bf16(*args, gb)]
    plain = [s2_silu_sep_bf16_plain(*args), *s2_silu_sep_bf16_bwd_plain(*args, gb)]
    for name, a, j, p in zip(["out", "dx", "ds"], got, jax_outs, plain):
        assert a.dtype == p.dtype == torch.bfloat16, name
        for what, want in (("jax", j), ("plain", p.float())):
            err, unequal = _bf16_hold(a, want)
            assert err <= BF16_TOL and unequal <= BF16_UNEQUAL, (name, what, err, unequal)


@pytest.mark.parametrize("lmax,E", [(6, 37), (2, 37)])
def test_k3_split_bf16_without_the_inner_rounding_fails_the_hold(lmax, E):
    """The hold tells the bfloat16 function from a rendering that skips the
    inner rounding (silu(v) and h fed to the second product unrounded, as
    TF32): out and dx, which that rounding reaches, then differ from JAX's
    bfloat16 result in more than BF16_UNEQUAL of their elements (though
    within BF16_TOL of their largest), while the rendering with it stays
    inside; ds, which it does not reach, is the same either way."""
    x, s, tg, fg, g = _k3_case(lmax, E, 64, 41 + lmax + E)
    jax_outs = _k3_bf16_jax(x, s, tg, fg, g)
    args = [torch.as_tensor(a).to(torch.bfloat16) for a in (x, s, tg, fg)]
    gb = torch.as_tensor(g).to(torch.bfloat16)
    rounded = [k3_split_bf16(*args), *k3b_split_bf16(*args, gb)]
    unrounded = [k3_split_bf16(*args, inner=False), *k3b_split_bf16(*args, gb, inner=False)]
    for name, a, b, j in zip(["out", "dx", "ds"], rounded, unrounded, jax_outs):
        err, unequal = _bf16_hold(a, j)
        assert err <= BF16_TOL and unequal <= BF16_UNEQUAL, (name, err, unequal)
        err, unequal = _bf16_hold(b, j)
        if name == "ds":
            assert torch.equal(a, b)
        else:
            assert not torch.equal(a, b), name
            assert unequal > BF16_UNEQUAL, (name, err, unequal)


# K5's and K5b's cases: the s2 FFN's full lmax-6 grid (I 49, G 210: row 48
# in float32), the attention message's m-primary lmax-6 / mmax-2 grid (I
# 29, G 70) and the full lmax-2 grid (I 9, G 42), with N * C no multiple
# of the kernels' 32-column warp tiles
K5_CASES = [(6, 6, False, 7, 16), (6, 2, True, 5, 48), (2, 2, False, 9, 16)]


def _k5_case(lmax, mmax, m_primary, N, C, seed):
    """x, tg, fg, g of K5/K5b as numpy arrays, and the JAX package's tg, fg."""
    from singa_tpu.equivariant import layers as jl
    from singa_tpu_torch.equivariant.layers import _grid_mats_for

    tg, fg = _grid_mats_for(lmax, mmax, m_primary)
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    I = tg.shape[1]
    return (f(N, I, C), tg, fg, f(N, I, C)), jl._grid_mats_for(lmax, mmax, m_primary)


@pytest.mark.parametrize("lmax,mmax,m_primary,N,C", K5_CASES)
def test_k5_split_matches_plain_and_pallas_forward(lmax, mmax, m_primary, N, C):
    """K5's output with both products its tensor-core kernel splits rendered
    in split TF32 (``k5_split``): within 1e-5 of its largest magnitude of
    ``s2_silu_plain`` (float32), and within atol and rtol 1e-5 of the JAX
    package's Pallas ``s2_silu`` in interpret mode (as
    ``tests/test_torch_s2_ffn.py`` holds the plain version to it). The same
    rendering with one TF32 product in place of each split one fails the
    1e-4 hold (atol and rtol 1e-4) that ``chip_smoke.py`` holds the kernel
    to."""
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.s2_act import s2_silu
    from singa_tpu_torch.ops.cuda.s2_act import s2_silu_plain
    from test_torch_common import close

    (x, tg, fg, _), (jtg, jfg) = _k5_case(lmax, mmax, m_primary, N, C, 37 + lmax + N)
    args = [torch.as_tensor(a) for a in (x, tg, fg)]
    with compute_dtype_scope("float32"):
        pallas = np.array(s2_silu(jnp.asarray(x), jtg, jfg))
    want = s2_silu_plain(*args)
    got = k5_split(*args)
    errs = rel_errs([got], [want], ["plain"])
    one = k5_split(*args, mm=mm_tf32)
    hold_ratio = ((one - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    assert max(errs.values()) <= 1e-5, errs
    close(got, pallas, 1e-5, 1e-5, "out vs pallas")
    assert hold_ratio > 1.0, hold_ratio


@pytest.mark.parametrize("lmax,mmax,m_primary,N,C", K5_CASES)
def test_k5b_split_matches_plain_and_pallas_backward(lmax, mmax, m_primary, N, C):
    """K5b's dx with its three products in split TF32 (``k5b_split``), at
    the forward's cases: within 1e-5 of its largest magnitude of
    ``s2_silu_bwd_plain`` (float32), and within atol 2e-4 and rtol 1e-4 of
    the VJP of the JAX package's ``s2_silu`` (its Pallas ``_bwd`` in
    interpret mode), as ``tests/test_torch_s2_ffn.py`` holds the plain
    backward to it. With one TF32 product in their place, dx fails the hold
    ``chip_smoke.py`` holds the kernel to (1e-4 of its largest
    magnitude)."""
    import jax
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.s2_act import s2_silu
    from singa_tpu_torch.ops.cuda.s2_act import s2_silu_bwd_plain
    from test_torch_common import close

    (x, tg, fg, g), (jtg, jfg) = _k5_case(lmax, mmax, m_primary, N, C, 41 + lmax + N)
    args = [torch.as_tensor(a) for a in (x, tg, fg, g)]
    with compute_dtype_scope("float32"):
        _, vjp = jax.vjp(lambda a: s2_silu(a, jtg, jfg), jnp.asarray(x))
        (pallas,) = vjp(jnp.asarray(g))
    want = s2_silu_bwd_plain(*args)
    got = k5b_split(*args)
    errs = rel_errs([got], [want], ["dx"])
    one = rel_errs([k5b_split(*args, mm=mm_tf32)], [want], ["dx"])
    assert max(errs.values()) <= 1e-5, errs
    close(got, np.array(pallas), 2e-4, 1e-4, "dx vs pallas")
    assert one["dx"] > 1e-4, one
