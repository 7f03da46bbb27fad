"""The port's CUDA kernels (forward and backward) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine without JAX;
there ``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from fixed seeds, at the main path's widths and
at ragged sizes that exercise each kernel's edge handling. Everything runs
in float32 with TF32 off (K4 forms its grid transforms and per-degree
products, K3, K3b and K4b their grid transforms, and K6 and K6b their conv
and weight-gradient products, as split TF32, to float32 round-off); the kernel
and the plain version add the same products in a different order, so they
agree to atol/rtol 1e-4 on outputs
of order 1-100. Backward outputs that are sums over many nodes (weight
gradients, the dk/dv scatter) are held to 1e-4 of their largest magnitude:
float32 sums of thousands of terms taken in another order.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dev)


def _check(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


# K1's cases: random lists at K 24 and 96 (a node with no live slot, a
# padded node, a repeated neighbour); N 1 (each row's one slot itself); a
# live row whose score sits far below -1e9 (taken again whole); the main
# path's shapes (N 384, K 96, 150 padded rows a graph: dead-weighted) and 16
# graphs of them (many rows a block); the path's shapes with the padded rows
# of each graph on one row's neighbours and distances, as the corpus's
# padded nodes (all at the origin): the first evaluated, the rest copies;
# 3 heads at the encoder's other widths (a row taken again whole); then
# widths the tensor-core kernel does not take, which the CUDA-core
# instance runs
LIST_FWD_CASES = ["random_k24", "random_k96", "n1", "redo", "path", "deep", "copies", "h3",
                  "heads8", "k160"]
PATH_PAD = 150  # the padded rows of each graph in the "path" cases


def _copies_case(dev):
    """K1b's "path" arguments with each graph's padded rows reading the
    first padded row's neighbours at its distances."""
    args = _list_bwd_case(dev, "path")
    N = args[4].shape[1]
    for i in (3, 5):  # nbr, dist
        args[i][:, N - PATH_PAD:] = args[i][:, N - PATH_PAD:N - PATH_PAD + 1].clone()
    return args


def _list_fwd_case(dev, case):
    """K1's arguments (``neighbor_attn_plain``'s) for one of LIST_FWD_CASES."""
    if case == "n1":
        k7, k8, _, nbr = _hub_graph(dev, 2, 1, 1, 0, 191)
        return [*k8[:3], nbr, *k7[3:]]
    if case == "copies":
        return _copies_case(dev)[:-1]
    if case == "h3":
        return _random_list_case(dev, 2, 40, 30, 193, redo=True, widths=(3, 32, 64, 64))[:-1]
    return _list_bwd_case(dev, case)[:-1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LIST_FWD_CASES)
def test_neighbor_attn_kernel_matches_plain(dev, case):
    """K1 at the encoder's widths (H 4, kd 32, vd 64, De 64; and H 3) and
    others, every row held to the plain version: random masks, a node with
    no live slot, padded nodes (self score -1e9: dead-weighted, their
    softmax uniform), a repeated neighbour index, N 1, a row taken again
    whole, the main path's shapes with their padded rows, copies of them."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _list_fwd_case(dev, case)
    n = k1.launches
    got = k1.neighbor_attn(*args, *k1.transpose_slots(args[3]))
    assert k1.launches == n + 1
    _check(got, k1.neighbor_attn_plain(*args))


@pytest.mark.cuda
def test_neighbor_attn_instance_by_shape(dev):
    """K1's and K7's tensor-core kernel takes the encoder's widths (kd 32,
    vd 64, De 64), H <= 4, K <= 128, one block of 16 warps an SM; kd 16
    (key_channels 64), H 8 (num_heads 8) and K 160 run the CUDA-core
    instance, which ``cuda_cores`` also asks for at any shape. The
    tensor-core kernel counts what it walks (at the path's shapes: every row
    once, the live slots and the padded rows' slots, fewer than B*N*K; with
    each graph's padded rows on one row's inputs, one of them a graph and
    the rest copies); the CUDA-core instance evaluates every slot and counts
    nothing."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    takes = {(96, 4, 32, 64, 64): "tensor_cores", (128, 1, 32, 64, 64): "tensor_cores",
             (96, 4, 16, 64, 64): "cuda_cores", (96, 8, 32, 64, 64): "cuda_cores",
             (48, 8, 16, 32, 64): "cuda_cores", (160, 2, 16, 16, 16): "cuda_cores",
             (129, 4, 32, 64, 64): "cuda_cores"}
    assert {w: k1.fwd_instance(*w) for w in takes} == takes
    for hybrid in (False, True):
        res = k1.fwd_residency(hybrid)
        assert res["blocks_per_sm"] == 1 and res["threads"] == 512, res
    assert k1.fwd_residency(bf16=True) == k1.fwd_residency()  # the same tiles and buffers
    assert k1.fwd_residency(True, bf16=True) == k1.fwd_residency(True)  # K7's bfloat16 instance
    args = _list_fwd_case(dev, "path")
    B, N, K = args[4].shape
    walked = [torch.zeros(4, dtype=torch.int32, device=dev) for _ in range(2)]
    got = k1.neighbor_attn_cuda(*args, stats=walked[0])
    cc = k1.neighbor_attn_cuda(*args, cuda_cores=True, stats=walked[1])
    want = k1.neighbor_attn_plain(*args)
    _check(got, want)
    _check(cc, want)
    live, dead, whole, slots = walked[0].tolist()
    padded = int((args[6][..., 0] <= -5e8).sum())
    assert (live, dead, whole) == (B * N - padded, padded, 0)
    assert slots == int(args[4].sum()) + padded * K < B * N * K
    assert walked[1].tolist() == [0, 0, 0, 0]
    copies = _list_fwd_case(dev, "copies")
    walked[0].zero_()
    _check(k1.neighbor_attn_cuda(*copies, stats=walked[0]), k1.neighbor_attn_plain(*copies))
    live, dead, whole, slots = walked[0].tolist()
    assert (live, dead, whole) == (B * N - padded, B, 0)
    assert slots == int(copies[4].sum()) + B * K
    heads8 = _list_fwd_case(dev, "heads8")
    walked[1].zero_()
    _check(k1.neighbor_attn_cuda(*heads8, stats=walked[1]), k1.neighbor_attn_plain(*heads8))
    assert walked[1].tolist() == [0, 0, 0, 0]


@pytest.mark.cuda
def test_neighbor_attn_kernel_keeps_relative_precision(dev):
    """K1 at the main path's shapes with graph b's v and diag_value scaled by
    10^(-3 .. 3) across 16 graphs: every graph's output within 1e-4 of that
    graph's own largest magnitude (rtol 1e-4): the split keeps float32's
    relative precision at every scale, which a bound on the largest output
    alone would not see."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _list_fwd_case(dev, "deep")
    B = args[0].shape[0]
    scale = torch.logspace(-3, 3, B, device=dev)[:, None, None]
    args[2], args[7] = args[2] * scale, args[7] * scale
    got = k1.neighbor_attn_cuda(*args)
    want = k1.neighbor_attn_plain(*args)
    torch.cuda.synchronize()
    graph_scale = want.abs().amax(dim=(1, 2), keepdim=True)
    err = (got - want).abs() / (1e-4 * graph_scale + 1e-4 * want.abs())
    assert err.max().item() <= 1.0, err.amax(dim=(1, 2))


@pytest.mark.cuda
def test_neighbor_attn_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K1 meets (atol and rtol 1e-4, as chip_smoke.py
    holds it) tells split TF32 from one TF32 product at the main path's
    shapes (4 graphs of 384 nodes, K 96, padded rows): the kernel and the
    split rendering of its arithmetic (test_torch_tf32_split.k1_split) pass
    it against neighbor_attn_plain; the same rendering with one TF32
    product in place of each split one fails it."""
    from test_torch_tf32_split import k1_split, mm_tf32

    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _list_fwd_case(dev, "path")
    n = k1.launches
    got = k1.neighbor_attn_cuda(*args)
    assert k1.launches == n + 1
    want = k1.neighbor_attn_plain(*args)
    ratio = lambda a: ((a - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    ratios = {"kernel": ratio(got), "split": ratio(k1_split(*args)),
              "one_tf32": ratio(k1_split(*args, mm=mm_tf32))}
    print(json.dumps({"hold_ratios": ratios}))
    assert ratios["kernel"] <= 1.0, ratios
    assert ratios["split"] <= 1.0, ratios
    assert ratios["one_tf32"] > 1.0, ratios


def _gate_ffn_case(dev, lmax, N, H, C, Co, seed):
    """K2's inputs (``so3_gate_ffn_plain``'s tensors, non-zero biases)."""
    L = lmax + 1
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
            0.1 * f(lmax * H), 0.1 * f(L, H, Co), 0.1 * f(Co)]
    return [_t(a, dev) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", [(6, 37, 512, 16, 16), (6, 8, 40, 16, 16),
                                           (4, 37, 512, 16, 16), (4, 8, 40, 16, 16),
                                           (7, 37, 512, 16, 16), (7, 17, 40, 8, 8),
                                           (6, 37, 512, 8, 8), (6, 21, 40, 8, 16),
                                           (5, 21, 40, 16, 8), (2, 5, 24, 16, 16),
                                           (6, 1, 512, 16, 16), (6, 14336, 512, 16, 16)])
def test_so3_gate_ffn_kernel_matches_plain(dev, lmax, N, H, C, Co):
    """K2's tensor-core kernel at lmax 6 (the default Config), 4
    (configs/train_lmax4.yml, configs/gan_recipe.yml), 7 (64 rows: up to 6
    a warp), 5 and 2 (every slot of a warp may be empty), with C and Co of
    16 or 8; N not a multiple of the 16-node tile and H not a multiple of
    the 16-channel hidden chunk; N 1; N 14,336: a training microbatch's
    nodes."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    args = _gate_ffn_case(dev, lmax, N, H, C, Co, 43 + N + (C != 16) + 2 * (Co != 16))
    assert k2.so3_gate_ffn_instance(lmax, C, H, Co) == "tensor_cores"
    n = k2.launches
    got = k2.so3_gate_ffn(*args, lmax)
    assert k2.launches == n + 1
    _check(got, k2.so3_gate_ffn_plain(*args, lmax))


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", [(6, 37, 512, 16, 16), (2, 9, 64, 32, 32),
                                           (6, 17, 40, 16, 4), (4, 17, 40, 8, 12)])
def test_so3_gate_ffn_cuda_core_instance_matches_plain(dev, lmax, N, H, C, Co):
    """K2's CUDA-core instance, which ``cuda_cores`` asks for at the main
    path's widths, and which the shapes the tensor-core kernel does not
    take (32 channels, Co 4 or 12) run."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    args = _gate_ffn_case(dev, lmax, N, H, C, Co, 45 + N)
    n = k2.launches
    got = k2.so3_gate_ffn_cuda(*args, lmax, cuda_cores=True)
    assert k2.launches == n + 1
    _check(got, k2.so3_gate_ffn_plain(*args, lmax))


@pytest.mark.cuda
def test_so3_gate_ffn_instance_by_shape(dev):
    """K2's tensor-core kernel takes C and Co of 8 or 16 at lmax 1..7, one
    block of 12 warps an SM (139,136 B of shared memory at lmax 6 and 16
    channels, 167,936 B at lmax 7); every other shape it took before (32
    channels, Co 4, 12) runs the CUDA-core instance; Co 6 neither."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    takes = {(6, 16, 512, 16): "tensor_cores", (7, 16, 512, 16): "tensor_cores",
             (7, 8, 40, 8): "tensor_cores", (4, 16, 512, 8): "tensor_cores",
             (1, 8, 8, 16): "tensor_cores", (2, 32, 64, 32): "cuda_cores",
             (6, 16, 512, 4): "cuda_cores", (4, 8, 40, 12): "cuda_cores",
             (2, 4, 8, 6): None}
    assert {w: k2.so3_gate_ffn_instance(*w) for w in takes} == takes
    res = k2.gate_fwd_residency(6, 16, 512, 16)
    assert res == {"blocks_per_sm": 1, "threads": 384, "smem_bytes": 139136}, res
    assert k2.gate_fwd_residency(7, 16, 512, 16)["smem_bytes"] == 167936
    assert k2.gate_fwd_residency(2, 32, 64, 32)["blocks_per_sm"] == -1
    # bfloat16: half the tile's bytes and half the words of a weight fragment
    res = k2.gate_fwd_residency(6, 16, 512, 16, bf16=True)
    assert res["blocks_per_sm"] >= 1 and res["smem_bytes"] == 73088, res
    assert k2.gate_fwd_residency(2, 32, 64, 32, bf16=True)["blocks_per_sm"] == -1


@pytest.mark.cuda
def test_so3_gate_ffn_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K2 meets (atol and rtol 1e-4, as chip_smoke.py
    holds it) tells split TF32 from one TF32 product at the training
    microbatch's widths (N 14,336, lmax 6, H 512, C = Co = 16): the kernel
    and the split rendering of its arithmetic
    (test_torch_tf32_split.k2_split) pass it against so3_gate_ffn_plain; the
    same rendering with one TF32 product in place of each split one fails
    it."""
    from test_torch_tf32_split import k2_split, mm_tf32

    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    args = _gate_ffn_case(dev, 6, 14336, 512, 16, 16, 85)
    n = k2.launches
    got = k2.so3_gate_ffn_cuda(*args, 6)
    assert k2.launches == n + 1
    want = k2.so3_gate_ffn_plain(*args, 6)
    ratio = lambda a: ((a - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    ratios = {"kernel": ratio(got)}
    del got
    ratios["split"] = ratio(k2_split(*args, 6))
    ratios["one_tf32"] = ratio(k2_split(*args, 6, mm=mm_tf32))
    print(json.dumps({"hold_ratios": ratios}))
    assert ratios["kernel"] <= 1.0, ratios
    assert ratios["split"] <= 1.0, ratios
    assert ratios["one_tf32"] > 1.0, ratios


# K3's and K3b's cases: the lmax 6 / mmax 2 grid (I 29, G 70) at 50 edges
# and at a training microbatch's 31,744 stage-1 edges; C 100 (not a
# multiple of 16: the CUDA-core instance); lmax 4 and 2 (I 19 and 9; G 50
# and 42) at C 64 and 16; one edge
SEP_CASES = [(50, 128, 6), (9, 100, 6), (31744, 128, 6), (37, 64, 4), (9, 16, 2), (1, 64, 6)]


def _sep_case(dev, E, C, lmax, seed, cotangent=False):
    """x, s, tg, fg (and g) of K3 / K3b at mmax 2 (the m-primary grid)."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for

    rng = np.random.default_rng(seed)
    tg, fg = (_t(m, dev) for m in _grid_mats_for(lmax, 2, True))
    f = lambda *sh: _t(rng.normal(size=sh).astype(np.float32), dev)
    args = [f(E, tg.shape[1], C), f(E, C), tg, fg]
    return args + [f(E, tg.shape[1], C)] if cotangent else args


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,lmax", SEP_CASES)
def test_s2_silu_sep_kernel_matches_plain(dev, E, C, lmax):
    """K3 on its tensor-core kernel wherever C is a multiple of 16, else on
    its CUDA-core instance (C 100), with every grid K3 runs at mmax 2."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    x, s, tg, fg = _sep_case(dev, E, C, lmax, 47 + E)
    want = "tensor_cores" if C % 16 == 0 else "cuda_cores"
    assert k3.s2_silu_sep_instance(tg.shape[1], C, tg.shape[0]) == want
    n = k3.launches
    got = k3.s2_silu_sep(x, s, tg, fg)
    assert k3.launches == n + 1
    _check(got, k3.s2_silu_sep_plain(x, s, tg, fg))


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,lmax", [(50, 128, 6), (37, 64, 4)])
def test_s2_silu_sep_cuda_core_instance_matches_plain(dev, E, C, lmax):
    """K3's and K3b's CUDA-core instance, which ``cuda_cores`` asks for at
    shapes the tensor-core kernels take, against the plain versions."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    x, s, tg, fg, g = _sep_case(dev, E, C, lmax, 49 + E, cotangent=True)
    n, nb = k3.launches, k3.launches_bwd
    got = k3.s2_silu_sep_cuda(x, s, tg, fg, cuda_cores=True)
    grads = k3.s2_silu_sep_bwd_cuda(x, s, tg, fg, g, cuda_cores=True)
    assert (k3.launches, k3.launches_bwd) == (n + 1, nb + 1)
    _check(got, k3.s2_silu_sep_plain(x, s, tg, fg))
    _check_grads(grads, k3.s2_silu_sep_bwd_plain(x, s, tg, fg, g), ["dx", "ds"])


@pytest.mark.cuda
def test_s2_silu_sep_instance_by_shape(dev):
    """K3's and K3b's tensor-core kernels take I <= 32 and C a multiple of
    16 (lmax 6, 4, 2 at mmax 2: I 29, 19, 9), one block an SM (K3: 16
    warps, 219,776 B of shared memory at I 29, G 70; K3b: 15 warps, 225,888
    B; at I 32 K3b's block takes the 14 warps that fit); every other shape
    the parent took (C 100 or 8) runs the CUDA-core instance; I above 32
    neither."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    takes = {(29, 128, 70): "tensor_cores", (19, 64, 50): "tensor_cores",
             (9, 16, 42): "tensor_cores", (32, 16, 70): "tensor_cores",
             (29, 100, 70): "cuda_cores", (29, 8, 70): "cuda_cores", (9, 1, 42): "cuda_cores",
             (36, 128, 20): None, (33, 16, 70): None}
    assert {w: k3.s2_silu_sep_instance(*w) for w in takes} == takes
    fwd, bwd = k3.sep_residency(29, 128, 70), k3.sep_residency(29, 128, 70, bwd=True)
    assert fwd == {"blocks_per_sm": 1, "threads": 512, "smem_bytes": 219776}, fwd
    assert bwd == {"blocks_per_sm": 1, "threads": 480, "smem_bytes": 225888}, bwd
    assert k3.sep_residency(32, 16, 70, bwd=True) == {"blocks_per_sm": 1, "threads": 448,
                                                      "smem_bytes": 219776}
    assert k3.sep_residency(29, 100, 70)["blocks_per_sm"] == -1


@pytest.mark.cuda
def test_s2_silu_sep_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K3 meets (atol and rtol 1e-4, as chip_smoke.py
    holds it) tells split TF32 from one TF32 product at a training
    microbatch's stage-1 call (E 31,744, I 29, G 70, C 128): the kernel and
    the split rendering of its arithmetic (test_torch_tf32_split.k3_split)
    pass it against s2_silu_sep_plain; the same rendering with one TF32
    product in place of each split one fails it."""
    from test_torch_tf32_split import k3_split, mm_tf32

    from singa_tpu_torch.ops.cuda import s2_act as k3

    args = _sep_case(dev, 31744, 128, 6, 91)
    n = k3.launches
    got = k3.s2_silu_sep_cuda(*args)
    assert k3.launches == n + 1
    want = k3.s2_silu_sep_plain(*args)
    ratio = lambda a: ((a - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    ratios = {"kernel": ratio(got)}
    del got
    ratios["split"] = ratio(k3_split(*args))
    ratios["one_tf32"] = ratio(k3_split(*args, mm=mm_tf32))
    print(json.dumps({"hold_ratios": ratios}))
    assert ratios["kernel"] <= 1.0, ratios
    assert ratios["split"] <= 1.0, ratios
    assert ratios["one_tf32"] > 1.0, ratios


@pytest.mark.cuda
def test_s2_silu_sep_bwd_hold_rejects_one_tf32_product(dev):
    """K3b's hold (each output within 1e-4 of its largest magnitude, as
    chip_smoke.py holds it) at the same call: the kernel's and k3b_split's
    dx and ds pass it against s2_silu_sep_bwd_plain; with one TF32 product
    in place of each split one, dx fails it (ds has no product on its
    path)."""
    from test_torch_tf32_split import k3b_split, mm_tf32

    from singa_tpu_torch.ops.cuda import s2_act as k3

    args = _sep_case(dev, 31744, 128, 6, 93, cotangent=True)
    n = k3.launches_bwd
    got = k3.s2_silu_sep_bwd_cuda(*args)
    assert k3.launches_bwd == n + 1
    want = k3.s2_silu_sep_bwd_plain(*args)
    ratio = lambda outs: {n: ((a - b).abs().max() / (1e-4 * b.abs().max())).item()
                          for n, a, b in zip(("dx", "ds"), outs, want)}
    ratios = {"kernel": ratio(got)}
    del got
    ratios["split"] = ratio(k3b_split(*args))
    ratios["one_tf32"] = ratio(k3b_split(*args, mm=mm_tf32))
    print(json.dumps({"hold_ratios": ratios}))
    assert max(ratios["kernel"].values()) <= 1.0, ratios
    assert max(ratios["split"].values()) <= 1.0, ratios
    assert ratios["one_tf32"]["dx"] > 1.0, ratios


BWD_NAMES = ["dqt", "dk", "dv", "dds", "ddv", "dwk1", "dbk1", "dwk2", "dbk2",
             "dwv1", "dbv1", "dwv2", "dbv2"]


def _check_grads(got, want, names):
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, want):
        scale = max(1.0, b.abs().max().item()) if b.numel() else 1.0
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=1e-4, msg=name)


def _random_list_case(dev, B, N, K, seed, redo=False, widths=(4, 32, 64, 64)):
    """K1b's arguments on random lists: random (not prefix) masks, a node
    with no live slot, a padded node (self score -1e9, no live slot: its
    softmax is uniform over masked slots, which send dv to the rows they
    name), a repeated neighbour index, a random cotangent on every row.
    ``redo``: also a padded node (row 9 of graph 0) with one live slot whose
    score is far below -1e9, so its max is the self score and its dead
    slots keep their weight (the kernel takes such a row again whole).
    ``widths``: (H, kd, vd, De)."""
    H, kd, vd, De = widths
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    nbr = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    nbr[1, 7, :3] = 5  # a repeated neighbour
    mask = rng.random((B, N, K)) > 0.6
    mask[0, 3] = False
    ds = f(B, N, H)
    ds[0, 5] = -1e9
    mask[0, 5] = False
    args = [
        f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd), nbr, mask,
        rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * vd),
        np.linspace(0.0, 15.0, De, dtype=np.float32),
        0.3 * f(De, kd), 0.1 * f(kd), 0.3 * f(kd, kd), 0.1 * f(kd),
        0.3 * f(De, vd), 0.1 * f(vd), 0.3 * f(vd, vd), 0.1 * f(vd),
    ]
    coeff = -0.5 / (15.0 / (De - 1)) ** 2
    if redo:
        from singa_tpu_torch.ops.cuda.neighbor_attn import _ssp

        ds[0, 9] = -1e9
        mask[0, 9] = False
        mask[0, 9, 2] = True
        t = lambda a: torch.as_tensor(a)
        diff = t(args[5][0, 9, 2]) - t(args[8])
        e = -torch.exp(coeff * diff * diff)
        w_k = (_ssp(e @ t(args[9]) + t(args[10])) @ t(args[11]) + t(args[12])).numpy()
        krow = args[1][0, nbr[0, 9, 2]].reshape(H, kd)
        args[0][0, 9] = (-1e11 * np.sign(w_k * krow)).reshape(-1)
    return [_t(a, dev) for a in args] + [coeff, _t(f(B, N, H * vd), dev)]


def _path_cotangent(g, ds, keep):
    """The cotangent the model path hands the kernel: zero on every padded
    row (self score -1e9; NeighborGraphMHA ends with out * node_mask), but on
    the padded rows ``keep`` [(graph, row)], whose cotangent stays."""
    padded = ds[..., 0] <= -5e8
    for b, i in keep:
        padded[b, i] = False
    return torch.where(padded[..., None], torch.zeros_like(g), g)


def _graph_list_case(dev, B, N, knn, ring, seed, pad):
    """K1b's arguments, and K7b's, on build_neighbor_graph's lists (prefix
    masks, an overflow row cut to K) with ``pad`` padded nodes in every
    graph and the path's cotangent, but on one padded row (graph 0's last):
    returns (K1b's arguments, K7b's, nbr)."""
    from singa_tpu_torch.ops.cuda.neighbor_attn import gather_rows

    k7, k8, g, nbr = _hub_graph(dev, B, N, knn, ring, seed, 0)
    q, k, v, adj, ds, dval, *w, coeff = k8
    ds = ds.clone()
    ds[:, N - pad:] = -1e9
    live = (torch.arange(N, device=dev) < N - pad)
    nbr_mask = k7[3] & live[None, :, None] & live[None, None, :].expand(B, N, N).gather(
        2, nbr.long())
    g = _path_cotangent(g, ds, [(0, N - 1)])
    k1b = [q, k, v, nbr, nbr_mask, k7[4], ds, dval, *w, coeff, g]
    k7b = [q, gather_rows(k, nbr), gather_rows(v, nbr), nbr, nbr_mask, k7[4], ds, dval, *w,
           coeff, g]
    return k1b, k7b, nbr


# K1b's cases: random lists at K 24 and 96; a row taken again whole; the
# main path's shapes (N 384, K 96, several graphs, a padded tail whose
# cotangent is zero, one padded row whose cotangent is not); deep enough
# for many rows per block (16 graphs: ~46 rows a block on 132 SMs). Then
# shapes the tensor-core kernel does not take, which the CUDA-core one
# runs: the encoder at num_heads 8 (kd 16, vd 32) and at key_channels 64
# (kd 16); ragged widths, with a row taken again whole; K 160
LIST_BWD_CASES = ["random_k24", "random_k96", "redo", "path", "deep",
                  "heads8", "key64", "ragged_redo", "k160"]


def _list_bwd_case(dev, case):
    if case == "random_k24":
        return _random_list_case(dev, 2, 64, 24, 77)
    if case == "random_k96":
        return _random_list_case(dev, 3, 50, 96, 149)
    if case == "redo":
        return _random_list_case(dev, 2, 64, 24, 151, redo=True)
    if case == "heads8":
        return _random_list_case(dev, 2, 64, 48, 167, widths=(8, 16, 32, 64))
    if case == "key64":
        return _random_list_case(dev, 2, 64, 48, 169, widths=(4, 16, 64, 64))
    if case == "ragged_redo":
        return _random_list_case(dev, 2, 40, 30, 173, redo=True, widths=(3, 12, 20, 16))
    if case == "k160":
        return _random_list_case(dev, 2, 200, 160, 179, widths=(2, 16, 16, 16))
    B = 4 if case == "path" else 16
    return _graph_list_case(dev, B, 384, 48, 110, 157 + B, PATH_PAD)[0]


def _as_hybrid(args):
    """K7b's arguments from K1b's: the neighbour rows gathered."""
    from singa_tpu_torch.ops.cuda.neighbor_attn import gather_rows

    return [args[0], gather_rows(args[1], args[3]), gather_rows(args[2], args[3]), *args[3:]]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LIST_BWD_CASES)
def test_neighbor_attn_bwd_kernel_matches_plain(dev, case):
    """K1b against the plain backward, every output, the scatter included:
    random masks, a node with no live slot, a padded node (its softmax is
    uniform over masked slots, which send dv to the rows they name), a
    repeated neighbour index; a live row whose scores leave its dead slots a
    weight; the main path's shapes with a zero cotangent on the padded
    rows; many rows per block."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _list_bwd_case(dev, case)
    n = k1.launches_bwd
    offsets, slots = k1.transpose_slots(args[3])
    got = k1.neighbor_attn_bwd_cuda(*args, offsets=offsets, slots=slots)
    assert k1.launches_bwd == n + 1
    _check_grads(got, k1.neighbor_attn_bwd_plain(*args), BWD_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["list", "hybrid"])
@pytest.mark.parametrize("case", ["random_k96", "redo", "path", "heads8"])
def test_neighbor_attn_bwd_cuda_core_instance_matches_plain(dev, case, form):
    """The CUDA-core instance of K1b's and K7b's backward (what every shape
    the tensor-core kernel does not take runs), asked for at any shape,
    against the plain backward; and it walks what the instance picked for
    these shapes walks: the same rows skipped, taken live and taken whole,
    and the same slots."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _list_bwd_case(dev, case)
    launch, plain = k1.neighbor_attn_bwd_cuda, k1.neighbor_attn_bwd_plain
    if form == "hybrid":
        args = _as_hybrid(args)
        launch, plain = k1.neighbor_attn_hybrid_bwd_cuda, k1.neighbor_attn_hybrid_bwd_plain
    offsets, slots = k1.transpose_slots(args[3])
    walked = [torch.zeros(4, dtype=torch.int32, device=dev) for _ in range(2)]
    got = launch(*args, offsets=offsets, slots=slots, cuda_cores=True, stats=walked[0])
    _check_grads(got, plain(*args), BWD_NAMES)
    launch(*args, offsets=offsets, slots=slots, stats=walked[1])
    zero, live, whole, evaluated = walked[0].tolist()
    assert walked[0].tolist() == walked[1].tolist()
    B, N, K = args[4].shape
    assert zero + live + whole == B * N
    assert whole >= (2 if case == "redo" else 1)  # the padded rows whose cotangent is not zero


@pytest.mark.cuda
def test_neighbor_attn_bwd_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K1b meets tells split TF32 from one TF32 product
    at the main path's shapes (4 graphs of 384 nodes, K 96): the kernel and
    the split rendering of its arithmetic (test_torch_tf32_split.k1b_split)
    pass it against neighbor_attn_bwd_plain; the same rendering with one
    TF32 product per EdgeMLP product fails it on at least one output."""
    from test_torch_tf32_split import k1b_split, mm_tf32

    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _list_bwd_case(dev, "path")
    offsets, slots = k1.transpose_slots(args[3])
    n = k1.launches_bwd
    got = k1.neighbor_attn_bwd_cuda(*args, offsets=offsets, slots=slots)
    assert k1.launches_bwd == n + 1
    want = k1.neighbor_attn_bwd_plain(*args)
    ratios = {"kernel": _hold_ratios(got, want, BWD_NAMES)}
    del got
    ratios["split"] = _hold_ratios(k1b_split(*args), want, BWD_NAMES)
    ratios["one_tf32"] = _hold_ratios(k1b_split(*args, mm=mm_tf32), want, BWD_NAMES)
    print(json.dumps({"hold_ratios": ratios}))
    assert max(ratios["kernel"].values()) <= 1.0, ratios
    assert max(ratios["split"].values()) <= 1.0, ratios
    assert max(ratios["one_tf32"].values()) > 1.0, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H", [(6, 37, 512), (6, 8, 40), (4, 37, 512), (4, 8, 40),
                                      (6, 2003, 512), (4, 2003, 512), (6, 1, 512), (6, 17, 40),
                                      (6, 14336, 512)])
def test_so3_gate_ffn_bwd_kernel_matches_plain(dev, lmax, N, H):
    """K2b at lmax 6 and 4 with 16 channels; N not a multiple of either
    kernel's node tile (8, 16) and H not a multiple of either's hidden chunk
    (32, 16); N 1: one node; N 2,003: several slices of the weight kernel,
    each ~30 tiles deep, added by sum_rows_kernel; N 14,336: a training
    microbatch's nodes. (At lmax 7 the card takes 8 channels in or out:
    test_so3_gate_ffn_bwd_kernel_takes_8_channels.)"""
    _check_gate_bwd(dev, lmax, N, H, 16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", [(6, 37, 512, 8, 8), (4, 2003, 512, 8, 8),
                                           (6, 37, 40, 8, 16), (6, 37, 40, 16, 8),
                                           (6, 1, 512, 8, 8), (6, 17, 40, 8, 16),
                                           (6, 14336, 512, 16, 8), (7, 37, 512, 8, 16),
                                           (7, 17, 40, 16, 8)])
def test_so3_gate_ffn_bwd_kernel_takes_8_channels(dev, lmax, N, H, C, Co):
    """K2b with 8 input or output channels, both kernels' other instances
    (their products' k and n steps are 8 wide), at the same edges: N 1, 17
    and 14,336, H 40, and lmax 7 (64 rows: up to 6 a warp in the dx kernel)."""
    _check_gate_bwd(dev, lmax, N, H, C, Co)


def _check_gate_bwd(dev, lmax, N, H, C, Co):
    """K2b against so3_gate_ffn_bwd_plain on seeded inputs, one launch."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    L = lmax + 1
    rng = np.random.default_rng(59 + N + (C != 16) + 2 * (Co != 16))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
            0.1 * f(lmax * H), 0.1 * f(L, H, Co)]
    args = [_t(a, dev) for a in args] + [lmax, _t(f(N, L * L, Co), dev)]
    n = k2.launches_bwd
    got = k2.so3_gate_ffn_bwd_cuda(*args)
    assert k2.launches_bwd == n + 1
    _check_grads(got, k2.so3_gate_ffn_bwd_plain(*args),
                 ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"])


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,lmax", SEP_CASES)
def test_s2_silu_sep_bwd_kernel_matches_plain(dev, E, C, lmax):
    """K3b on the instance K3 takes (the tensor-core kernel, or the
    CUDA-core one at C 100); row 0 of the cotangent reaches only the
    scalars."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    x, s, tg, fg, g = _sep_case(dev, E, C, lmax, 61 + E, cotangent=True)
    want = "tensor_cores" if C % 16 == 0 else "cuda_cores"
    assert k3.s2_silu_sep_instance(tg.shape[1], C, tg.shape[0]) == want
    n = k3.launches_bwd
    got = k3.s2_silu_sep_bwd_cuda(x, s, tg, fg, g)
    assert k3.launches_bwd == n + 1
    _check_grads(got, k3.s2_silu_sep_bwd_plain(x, s, tg, fg, g), ["dx", "ds"])


@pytest.mark.cuda
def test_autograd_reaches_inputs_through_every_kernel(dev):
    """loss.backward() on CUDA tensors gives every input of K1, K2 and K3 the
    gradient the CPU (plain versions) gives it: the kernels sit inside
    autograd, with nothing cut off upstream."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import s2_act as k3
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    rng = np.random.default_rng(67)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    tg, fg = _grid_mats_for(6, 2, True)
    B, N, K, H, kd, vd, De = 2, 30, 12, 4, 32, 64, 64
    nbr = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    cases = [
        (k3.s2_silu_sep, [f(20, 29, 128), f(20, 128), tg, fg], [0, 1], lambda ts: ()),
        (k2.so3_gate_ffn, [f(9, 49, 16), 0.3 * f(7, 16, 40), f(40), 0.3 * f(16, 240), f(240),
                           0.1 * f(7, 40, 16), f(16)], range(7), lambda ts: (6,)),
        (k1.neighbor_attn, [f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd), nbr,
                            rng.random((B, N, K)) > 0.4, rng.uniform(0.5, 14.0, (B, N, K)).astype(np.float32),
                            f(B, N, H), f(B, N, H * vd), np.linspace(0.0, 15.0, De, dtype=np.float32),
                            0.3 * f(De, kd), f(kd), 0.3 * f(kd, kd), f(kd), 0.3 * f(De, vd), f(vd),
                            0.3 * f(vd, vd), f(vd)], [0, 1, 2, 6, 7, *range(9, 17)],
         lambda ts: (-0.2, *k1.transpose_slots(ts[3]))),
    ]
    for fn, arrays, diff, extra in cases:
        grads = {}
        for d in ("cpu", dev):
            ts = [torch.as_tensor(np.ascontiguousarray(a)).to(d) for a in arrays]
            for i in diff:
                ts[i].requires_grad_()
            out = fn(*ts, *extra(ts))
            w = torch.as_tensor(np.random.default_rng(3).normal(size=out.shape).astype(np.float32)).to(d)
            (out * w).sum().backward()
            grads[str(d)] = [ts[i].grad for i in diff]
        for a, b in zip(grads["cuda"], grads["cpu"]):
            assert a is not None
            scale = max(1.0, b.abs().max().item())
            torch.testing.assert_close(a.cpu(), b, atol=1e-4 * scale, rtol=1e-4)


def _s2_ffn_case(dev, lmax, N, H, C, Co, seed):
    """K4's inputs at lmax (non-zero biases) with the l-primary full grid,
    and a cotangent."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for

    L = lmax + 1
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = [f(N, L * L, C), 0.2 * f(L, C, H), 0.1 * f(H), 0.2 * f(C, H), 0.1 * f(H),
            0.1 * f(L, H, Co), 0.1 * f(Co), *_grid_mats_for(lmax, lmax, False)]
    return [_t(a, dev) for a in args], _t(f(N, L * L, Co), dev)


S2_FFN_CASES = [(6, 37, 512, 16, 16), (6, 1000, 512, 16, 16), (3, 13, 40, 16, 16),
                (2, 5, 24, 8, 4), (6, 1, 512, 16, 16), (6, 14336, 512, 16, 16)]
# K4's shapes that its CUDA-core instance runs (lmax 7, C or Co above 16);
# K4b refuses lmax 7 (shared memory), so these are forward cases only
S2_FFN_CC_CASES = [(7, 9, 40, 8, 8), (3, 13, 40, 24, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", S2_FFN_CASES + S2_FFN_CC_CASES)
def test_so3_ffn_kernel_matches_plain(dev, lmax, N, H, C, Co):
    """K4 at lmax 6 (the main path's widths, G 210; N from 1 to a training
    microbatch's 14,336), 3 and 2 on the tensor-core kernel, and at lmax 7
    and 24 / 20 channels on the CUDA-core instance; N not a multiple of the
    node tile, H not always a multiple of the hidden chunk; non-zero
    biases."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    args, _ = _s2_ffn_case(dev, lmax, N, H, C, Co, 71 + N)
    n = k4.launches_s2
    got = k4.so3_ffn(*args, lmax)
    assert k4.launches_s2 == n + 1
    _check(got, k4.so3_ffn_plain(*args, lmax))


@pytest.mark.cuda
def test_so3_ffn_instance_by_shape(dev):
    """K4's tensor-core kernel takes lmax <= 6 with C and Co up to 16 (the
    model's widths among them), one block of 8 warps an SM at lmax 6; the
    CUDA-core instance takes the other shapes it took before (lmax 7, C or
    Co above 16); lmax 8 neither."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    G = {2: 42, 3: 72, 6: 210, 7: 272, 8: 342}
    takes = {(6, 16, 512, 16): "tensor_cores", (6, 8, 40, 4): "tensor_cores",
             (2, 1, 24, 4): "tensor_cores", (3, 16, 40, 16): "tensor_cores",
             (7, 8, 40, 8): "cuda_cores", (3, 24, 40, 20): "cuda_cores",
             (6, 16, 512, 20): "cuda_cores", (8, 4, 8, 4): None}
    got = {w: k4.s2_fwd_instance(w[0], w[1], w[2], w[3], G[w[0]]) for w in takes}
    assert got == takes
    res = k4.s2_fwd_residency(6, 16, 512, 16, 210)
    assert res["blocks_per_sm"] == 1 and res["threads"] == 256, res
    assert k4.s2_fwd_residency(7, 8, 40, 8, 272)["blocks_per_sm"] == -1


@pytest.mark.cuda
def test_so3_ffn_kernel_keeps_relative_precision(dev):
    """K4 with node n's x scaled by 10^(-3 .. 3) across 256 nodes: y of
    every node within 1e-4 of that node's own largest magnitude (rtol 1e-4):
    the split keeps float32's relative precision at every scale, which a
    bound on the largest output alone would not see."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    N = 256
    args, _ = _s2_ffn_case(dev, 6, N, 512, 16, 16, 77)
    args[0] = args[0] * torch.logspace(-3, 3, N, device=dev)[:, None, None]
    n = k4.launches_s2
    got = k4.so3_ffn_cuda(*args, 6)
    assert k4.launches_s2 == n + 1
    want = k4.so3_ffn_plain(*args, 6)
    node_scale = want.abs().amax(dim=(1, 2), keepdim=True)
    err = (got - want).abs() / (1e-4 * node_scale + 1e-4 * want.abs())
    assert err.max().item() <= 1.0, err.amax(dim=(1, 2))


@pytest.mark.cuda
def test_so3_ffn_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K4 meets (atol and rtol 1e-4, as chip_smoke.py
    holds it) tells split TF32 from one TF32 product at the s2 training
    microbatch's widths (N 14,336, lmax 6, H 512, C = Co = 16): the kernel
    and the split rendering of its arithmetic
    (test_torch_tf32_split.k4_split) pass it against so3_ffn_plain; the
    same rendering with one TF32 product in place of each split one fails
    it."""
    from test_torch_tf32_split import k4_split, mm_tf32

    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    args, _ = _s2_ffn_case(dev, 6, 14336, 512, 16, 16, 81)
    n = k4.launches_s2
    got = k4.so3_ffn_cuda(*args, 6)
    assert k4.launches_s2 == n + 1
    want = k4.so3_ffn_plain(*args, 6)
    ratio = lambda a: ((a - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    ratios = {"kernel": ratio(got)}
    del got
    ratios["split"] = ratio(k4_split(*args, 6))
    ratios["one_tf32"] = ratio(k4_split(*args, 6, mm=mm_tf32))
    print(json.dumps({"hold_ratios": ratios}))
    assert ratios["kernel"] <= 1.0, ratios
    assert ratios["split"] <= 1.0, ratios
    assert ratios["one_tf32"] > 1.0, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", S2_FFN_CASES)
def test_so3_ffn_bwd_kernel_matches_plain(dev, lmax, N, H, C, Co):
    """K4b against the plain backward: dx and the six weight and bias
    gradients (db1 from every row through the grid), at the same cases."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    args, dy = _s2_ffn_case(dev, lmax, N, H, C, Co, 73 + N)
    bwd_args = [*args[:6], *args[7:], lmax, dy]  # b2 gets its gradient from dy alone
    n = k4.launches_s2_bwd
    got = k4.so3_ffn_bwd_cuda(*bwd_args)
    assert k4.launches_s2_bwd == n + 1
    _check_grads(got, k4.so3_ffn_bwd_plain(*bwd_args), ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"])


def _hold_ratios(got, want, names):
    """Each output's largest |got - want| over _check_grads's allowance
    (1e-4 of the output's largest magnitude, floored at 1, plus 1e-4 of
    |want|): the hold passes where every ratio is at most 1."""
    out = {}
    for name, a, b in zip(names, got, want):
        scale = max(1.0, b.abs().max().item())
        out[name] = ((a - b).abs() / (1e-4 * scale + 1e-4 * b.abs())).max().item()
    return out


@pytest.mark.cuda
def test_so3_ffn_bwd_kernel_keeps_relative_precision(dev):
    """K4b with node n's x and dy scaled by 10^(-3 .. 3) across 256 nodes:
    dx of every node within 1e-4 of that node's own largest magnitude
    (rtol 1e-4), so a node 1e6 times smaller than the largest keeps
    float32's relative precision (the split is relative to each value; a
    bound on the largest output alone would not see the small nodes); the
    weight gradients as _check_grads holds them."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    N = 256
    args, dy = _s2_ffn_case(dev, 6, N, 512, 16, 16, 75)
    s = torch.logspace(-3, 3, N, device=dev)[:, None, None]
    args[0] = args[0] * s
    bwd_args = [*args[:6], *args[7:], 6, dy * s]
    n = k4.launches_s2_bwd
    got = k4.so3_ffn_bwd_cuda(*bwd_args)
    assert k4.launches_s2_bwd == n + 1
    want = k4.so3_ffn_bwd_plain(*bwd_args)
    node_scale = want[0].abs().amax(dim=(1, 2), keepdim=True)
    err = (got[0] - want[0]).abs() / (1e-4 * node_scale + 1e-4 * want[0].abs())
    assert err.max().item() <= 1.0, err.amax(dim=(1, 2))
    _check_grads(got[1:], want[1:], ["dw1", "db1", "dwg", "dbg", "dw2", "db2"])


@pytest.mark.cuda
def test_so3_ffn_bwd_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K4b meets tells split TF32 from one TF32 product
    at the s2 training microbatch's widths (N 14,336, lmax 6, H 512): the
    kernel and the split rendering of its arithmetic
    (test_torch_tf32_split.k4b_split) pass it against so3_ffn_bwd_plain;
    the same rendering with one TF32 product per transform fails it."""
    from test_torch_tf32_split import k4b_split, mm_tf32

    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    names = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]
    args, dy = _s2_ffn_case(dev, 6, 14336, 512, 16, 16, 79)
    bwd_args = [*args[:6], *args[7:], 6, dy]
    n = k4.launches_s2_bwd
    got = k4.so3_ffn_bwd_cuda(*bwd_args)
    assert k4.launches_s2_bwd == n + 1
    want = k4.so3_ffn_bwd_plain(*bwd_args)
    ratios = {"kernel": _hold_ratios(got, want, names)}
    del got
    ratios["split"] = _hold_ratios(k4b_split(*bwd_args), want, names)
    ratios["one_tf32"] = _hold_ratios(k4b_split(*bwd_args, mm=mm_tf32), want, names)
    print(json.dumps({"hold_ratios": ratios}))
    assert max(ratios["kernel"].values()) <= 1.0, ratios
    assert max(ratios["split"].values()) <= 1.0, ratios
    assert max(ratios["one_tf32"].values()) > 1.0, ratios


@pytest.mark.cuda
def test_so3_gate_ffn_bwd_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K2b meets tells split TF32 from one TF32 product
    at the training microbatch's widths (N 14,336, lmax 6, C = Co = 16,
    H 512): the kernel is within a tenth of the hold against
    so3_gate_ffn_bwd_plain on every output, dx included; the rendering of
    both kernels' products with one TF32 product each
    (test_torch_tf32_split.k2b_split) fails it on dx, the dx kernel's
    output."""
    from test_torch_tf32_split import k2b_split, mm_tf32

    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    names = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]
    lmax, N, H, C = 6, 14336, 512, 16
    L = lmax + 1
    rng = np.random.default_rng(83)
    f = lambda *s: _t(rng.normal(size=s).astype(np.float32), dev)
    args = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
            0.1 * f(lmax * H), 0.1 * f(L, H, C), lmax, f(N, L * L, C)]
    n = k2.launches_bwd
    got = k2.so3_gate_ffn_bwd_cuda(*args)
    assert k2.launches_bwd == n + 1
    want = k2.so3_gate_ffn_bwd_plain(*args)
    ratios = {"kernel": _hold_ratios(got, want, names)}
    del got
    ratios["one_tf32"] = _hold_ratios(k2b_split(*args, mm=mm_tf32), want, names)
    print(json.dumps({"hold_ratios": ratios}))
    assert max(ratios["kernel"].values()) <= 0.1, ratios
    assert ratios["one_tf32"]["dx"] > 1.0, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [0, 1])
def test_mma_tf32_tile_matches_float64(dev, trans):
    """One [64 x 56] . [56 x 64] product through csrc/mma_tf32.cuh's split
    TF32 mma.sync, A read row-major with paired k (trans 0, K4b's to-grid
    orientation) or transposed (trans 1, its from-grid one), against the
    float64 product: within 2e-6 of the largest output (one TF32 product:
    ~3e-4)."""
    import ctypes

    from singa_tpu_torch.ops.cuda import build

    M, K, N = 64, 56, 64
    rng = np.random.default_rng(61 + trans)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    fn = build.load("mma_tf32").mma_tf32_tile_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ta, tb = _t(a.T if trans else a, dev), _t(b, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    build.check(fn(ta.data_ptr(), tb.data_ptr(), out.data_ptr(), M, K, N, trans,
                   build.stream_ptr(out)), "mma_tf32_tile")
    torch.cuda.synchronize()
    want = a.astype(np.float64) @ b.astype(np.float64)
    err = np.abs(out.cpu().numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert err <= 2e-6, err


@pytest.mark.cuda
def test_mma_tf32_rounding_is_cvt_rna(dev):
    """csrc/mma_tf32.cuh's tf32_rna (integer operations) equals the
    cvt.rna.tf32.f32 instruction bit for bit, on 2^20 normal values of
    magnitudes 1e-30 to 1e30, signed zeros and values exactly half a TF32
    ulp above a TF32 value (the ties, which round away from zero)."""
    import ctypes

    from singa_tpu_torch.ops.cuda import build

    rng = np.random.default_rng(67)
    x = (rng.normal(size=1 << 20) * 10.0 ** rng.uniform(-30, 30, size=1 << 20)).astype(np.float32)
    ties = (x[:4096].view(np.uint32) & np.uint32(0xFFFFE000) | np.uint32(0x1000)).view(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0]), ties, -ties])
    fn = build.load("mma_tf32").mma_tf32_rna_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tx = _t(x, dev)
    bits, ptx = (torch.empty(x.shape, dtype=torch.int32, device=dev) for _ in range(2))
    build.check(fn(tx.data_ptr(), bits.data_ptr(), ptx.data_ptr(), x.size, build.stream_ptr(tx)),
                "mma_tf32_rna")
    torch.cuda.synchronize()
    assert torch.equal(bits, ptx)


# K5's and K5b's cases: C 24 and 5 on the CUDA-core instance; on the
# tensor-core kernels the s2 FFN's full lmax-6 grid (I 49, G 210, row 48
# in float32) at 16 and 512 channels, one node and a serving encode's
# hidden (3,584 nodes); the attention message's m-primary grid (I 29, G
# 70) at C 128, 50 edges and a stage-1 call's 7,936; the full lmax-5 grid
# (I 36, G 156: 6 k steps, 3 m16 tiles, no tail) and lmax-2 grid (I 9, G
# 42); N * C no multiple of the 32-column warp tile in several
K5_CASES = [(6, 6, False, 37, 24), (2, 2, False, 9, 5), (6, 6, False, 37, 16),
            (6, 6, False, 1, 16), (6, 6, False, 3584, 512), (6, 6, False, 7, 512),
            (6, 2, True, 50, 128), (6, 2, True, 7936, 128), (5, 5, False, 11, 48),
            (2, 2, False, 9, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,mmax,m_primary,N,C", K5_CASES)
def test_s2_silu_kernels_match_plain(dev, lmax, mmax, m_primary, N, C):
    """K5 and K5b on their tensor-core kernels wherever C is a multiple of
    16 (I at most 49), else on their CUDA-core instance."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import s2_act as k5

    rng = np.random.default_rng(79 + N)
    tg, fg = (_t(m, dev) for m in _grid_mats_for(lmax, mmax, m_primary))
    x = _t(rng.normal(size=(N, tg.shape[1], C)).astype(np.float32), dev)
    g = _t(rng.normal(size=(N, tg.shape[1], C)).astype(np.float32), dev)
    want = "tensor_cores" if C % 16 == 0 else "cuda_cores"
    assert k5.s2_silu_instance(tg.shape[1], C, tg.shape[0]) == want
    n, nb = k5.launches_silu, k5.launches_silu_bwd
    got = k5.s2_silu(x, tg, fg)
    dx = k5.s2_silu_bwd_cuda(x, tg, fg, g)
    assert (k5.launches_silu, k5.launches_silu_bwd) == (n + 1, nb + 1)
    _check(got, k5.s2_silu_plain(x, tg, fg))
    _check_grads([dx], [k5.s2_silu_bwd_plain(x, tg, fg, g)], ["dx"])


def _silu_case(dev, lmax, mmax, m_primary, N, C, seed):
    """x, tg, fg, g of K5 / K5b."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for

    rng = np.random.default_rng(seed)
    tg, fg = (_t(m, dev) for m in _grid_mats_for(lmax, mmax, m_primary))
    f = lambda: _t(rng.normal(size=(N, tg.shape[1], C)).astype(np.float32), dev)
    return f(), tg, fg, f()


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,mmax,m_primary,N,C", [(6, 6, False, 37, 16), (6, 2, True, 50, 128)])
def test_s2_silu_cuda_core_instance_matches_plain(dev, lmax, mmax, m_primary, N, C):
    """K5's and K5b's CUDA-core instance, which ``cuda_cores`` asks for at
    shapes the tensor-core kernels take, against the plain versions."""
    from singa_tpu_torch.ops.cuda import s2_act as k5

    x, tg, fg, g = _silu_case(dev, lmax, mmax, m_primary, N, C, 157 + N)
    n, nb = k5.launches_silu, k5.launches_silu_bwd
    got = k5.s2_silu_cuda(x, tg, fg, cuda_cores=True)
    dx = k5.s2_silu_bwd_cuda(x, tg, fg, g, cuda_cores=True)
    assert (k5.launches_silu, k5.launches_silu_bwd) == (n + 1, nb + 1)
    _check(got, k5.s2_silu_plain(x, tg, fg))
    _check_grads([dx], [k5.s2_silu_bwd_plain(x, tg, fg, g)], ["dx"])


@pytest.mark.cuda
def test_s2_silu_instance_by_shape(dev):
    """K5's and K5b's tensor-core kernels take I <= 49 and C a multiple of
    16: at the full lmax-6 grid (I 49, G 210) K5 takes 13 warps of 16
    columns (224,976 B of shared memory), K5b, tg staged once, 6 (218,304
    B); at the attention message's grid (I 29, G 70) both are K3's and
    K3b's blocks (16 warps, 219,776 B; 15 warps, 225,888 B). Every other
    shape the parent took (C 24 or 5; I 64, the full lmax-7 grid) runs the
    CUDA-core instance; I above 64 neither."""
    from singa_tpu_torch.ops.cuda import s2_act as k5

    takes = {(49, 512, 210): "tensor_cores", (49, 16, 210): "tensor_cores",
             (29, 128, 70): "tensor_cores", (36, 48, 156): "tensor_cores",
             (9, 16, 42): "tensor_cores", (49, 24, 210): "cuda_cores", (9, 5, 42): "cuda_cores",
             (64, 16, 272): "cuda_cores", (81, 16, 20): None}
    assert {w: k5.s2_silu_instance(*w) for w in takes} == takes
    assert k5.silu_residency(49, 512, 210) == {"blocks_per_sm": 1, "threads": 416,
                                               "smem_bytes": 224976}
    assert k5.silu_residency(49, 512, 210, bwd=True) == {"blocks_per_sm": 1, "threads": 192,
                                                         "smem_bytes": 218304}
    assert k5.silu_residency(29, 128, 70) == k5.sep_residency(29, 128, 70)
    assert k5.silu_residency(29, 128, 70, bwd=True) == k5.sep_residency(29, 128, 70, bwd=True)
    assert k5.silu_residency(49, 24, 210)["blocks_per_sm"] == -1


@pytest.mark.cuda
def test_s2_silu_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K5 meets (atol and rtol 1e-4, as chip_smoke.py
    holds it) tells split TF32 from one TF32 product at a serving encode's
    s2 FFN hidden (N 3,584, I 49, G 210, C 512): the kernel and the split
    rendering of its arithmetic (test_torch_tf32_split.k5_split) pass it
    against s2_silu_plain; the same rendering with one TF32 product in
    place of each split one fails it."""
    from test_torch_tf32_split import k5_split, mm_tf32

    from singa_tpu_torch.ops.cuda import s2_act as k5

    x, tg, fg, _ = _silu_case(dev, 6, 6, False, 3584, 512, 163)
    n = k5.launches_silu
    got = k5.s2_silu_cuda(x, tg, fg)
    assert k5.launches_silu == n + 1
    want = k5.s2_silu_plain(x, tg, fg)
    ratio = lambda a: ((a - want).abs() / (1e-4 + 1e-4 * want.abs())).max().item()
    ratios = {"kernel": ratio(got)}
    del got
    ratios["split"] = ratio(k5_split(x, tg, fg))
    ratios["one_tf32"] = ratio(k5_split(x, tg, fg, mm=mm_tf32))
    print(json.dumps({"hold_ratios": ratios}))
    assert ratios["kernel"] <= 1.0, ratios
    assert ratios["split"] <= 1.0, ratios
    assert ratios["one_tf32"] > 1.0, ratios


@pytest.mark.cuda
def test_s2_silu_bwd_hold_rejects_one_tf32_product(dev):
    """K5b's hold (dx within 1e-4 of its largest magnitude, as chip_smoke.py
    holds it) at the same call: the kernel's and k5b_split's dx pass it
    against s2_silu_bwd_plain; with one TF32 product in place of each split
    one, dx fails it."""
    from test_torch_tf32_split import k5b_split, mm_tf32

    from singa_tpu_torch.ops.cuda import s2_act as k5

    args = _silu_case(dev, 6, 6, False, 3584, 512, 167)
    n = k5.launches_silu_bwd
    got = k5.s2_silu_bwd_cuda(*args)
    assert k5.launches_silu_bwd == n + 1
    want = k5.s2_silu_bwd_plain(*args)
    ratio = lambda a: ((a - want).abs().max() / (1e-4 * want.abs().max())).item()
    ratios = {"kernel": ratio(got)}
    del got
    ratios["split"] = ratio(k5b_split(*args))
    ratios["one_tf32"] = ratio(k5b_split(*args, mm=mm_tf32))
    print(json.dumps({"hold_ratios": ratios}))
    assert ratios["kernel"] <= 1.0, ratios
    assert ratios["split"] <= 1.0, ratios
    assert ratios["one_tf32"] > 1.0, ratios


@pytest.mark.cuda
def test_autograd_reaches_inputs_through_k4_and_k5(dev):
    """loss.backward() through SO3FFN and S2Silu on CUDA tensors gives every
    input the gradient the CPU (plain versions) gives it."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import s2_act as k5
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    rng = np.random.default_rng(83)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    tg, fg = _grid_mats_for(6, 6, False)
    cases = [
        (k4.so3_ffn, [f(11, 49, 16), 0.2 * f(7, 16, 48), 0.1 * f(48), 0.2 * f(16, 48), 0.1 * f(48),
                      0.1 * f(7, 48, 16), 0.1 * f(16), tg, fg], range(7), (6,)),
        (k5.s2_silu, [f(10, 49, 20), tg, fg], [0], ()),
    ]
    for fn, arrays, diff, extra in cases:
        grads = {}
        for d in ("cpu", dev):
            ts = [torch.as_tensor(np.ascontiguousarray(a)).to(d) for a in arrays]
            for i in diff:
                ts[i].requires_grad_()
            out = fn(*ts, *extra)
            w = torch.as_tensor(np.random.default_rng(5).normal(size=out.shape).astype(np.float32)).to(d)
            (out * w).sum().backward()
            grads[str(d)] = [ts[i].grad for i in diff]
        for a, b in zip(grads["cuda"], grads["cpu"]):
            assert a is not None
            scale = max(1.0, b.abs().max().item())
            torch.testing.assert_close(a.cpu(), b, atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.cuda
def test_kernels_refuse_shapes_they_do_not_take(dev):
    """A shape outside a kernel's limits reaches its C entry point, which
    returns cudaErrorInvalidValue, and the wrapper raises ValueError: K1
    with one node's pair tensors over shared memory, K2 with 6 output
    channels, K3 with 36 coefficient rows, K4 and K5 with 81, K6 and K6b at
    lmax 7 (34 m-primary rows); K2b with 32 channels (its kernels take 8 or
    16), or at lmax 7 with 16 in and out (its tiles exceed shared memory),
    is refused before the launch."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import s2_act as k3
    from singa_tpu_torch.ops.cuda import so2_attn as k6
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    so2_args, so2_cts = _so2_case(dev, 3, 7, 4, 8, 4, 2, 97)
    rng = np.random.default_rng(89)
    f = lambda *s: _t(rng.normal(size=s).astype(np.float32), dev)
    H, kd, vd, De, K = 2, 32, 64, 64, 2000
    attn = [f(1, 1, H * kd), f(1, 1, H * kd), f(1, 1, H * vd), _t(np.zeros((1, 1, K), np.int32), dev),
            _t(np.ones((1, 1, K), bool), dev), f(1, 1, K), f(1, 1, H), f(1, 1, H * vd), f(De),
            f(De, kd), f(kd), f(kd, kd), f(kd), f(De, vd), f(vd), f(vd, vd), f(vd)]
    refused = [
        lambda: k1.neighbor_attn_cuda(*attn, -0.2),
        lambda: k2.so3_gate_ffn_cuda(f(3, 9, 4), f(3, 4, 8), f(8), f(4, 16), f(16), f(3, 8, 6), f(6), 2),
        lambda: k3.s2_silu_sep_cuda(f(3, 36, 8), f(3, 8), f(20, 36), f(20, 36)),
        lambda: k2.so3_ffn_cuda(f(3, 81, 4), f(9, 4, 8), f(8), f(4, 8), f(8), f(9, 8, 4), f(4),
                                f(20, 81), f(20, 81), 8),
        lambda: k3.s2_silu_cuda(f(3, 81, 8), f(20, 81), f(20, 81)),
        lambda: k6.so2_attn_cuda(*so2_args),
        lambda: k6.so2_attn_bwd_cuda(*_so2_bwd_args(so2_args, so2_cts)),
    ]
    for call in refused:
        with pytest.raises(ValueError, match="does not take these shapes"):
            call()
    # 6 input channels: neither K2b's tensor-core kernels (8 or 16) nor its
    # CUDA-core instance (a multiple of 4) takes them
    with pytest.raises(ValueError, match="6 input / 8 output channels at lmax 2 not supported"):
        k2.so3_gate_ffn_bwd_cuda(f(3, 9, 6), f(3, 6, 32), f(32), f(6, 64), f(64), f(3, 32, 8),
                                 2, f(3, 9, 8))


@pytest.mark.cuda
def test_so3_gate_ffn_at_32_channels_trains_no_step(dev):
    """The gate FFN block at sphere_channels 32 trains on the card: K2's
    forward, and K2b's backward on its CUDA-core instance (its tensor-core
    kernels take 8 or 16 channels), chosen by shape before the launch; the
    gradients equal the plain backward's to BWD tolerance (1e-4 of each
    output's largest). So do lmax 7 at 16 channels in and out, whose
    tensor-core tiles exceed shared memory. (The name is kept from when
    this width trained no step.)"""
    from singa_tpu_torch.equivariant.attention import FeedForwardNetwork
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    assert k2.so3_gate_ffn_bwd_instance(2, 32, 64, 32) == "cuda_cores"
    assert k2.so3_gate_ffn_bwd_instance(7, 16, 8, 16) == "cuda_cores"
    assert k2.so3_gate_ffn_bwd_instance(6, 16, 512, 16) == "tensor_cores"
    for C, H, lmax in ((32, 64, 2), (16, 8, 7)):
        ffn = FeedForwardNetwork(C, H, C, lmax, "gate", device=dev)
        ffn.init_params(torch.Generator().manual_seed(5))
        x = torch.randn(3, (lmax + 1) ** 2, C, generator=torch.Generator().manual_seed(6))
        x = x.to(dev).requires_grad_()
        before = k2.launches_bwd
        y = ffn(x)
        assert torch.isfinite(y).all()
        y.square().sum().backward()
        assert k2.launches_bwd == before + 1
        args = (x.detach(), ffn.w1.transpose(1, 2).contiguous(), ffn.b1, ffn.gate_kernel,
                ffn.gate_bias, ffn.w2.transpose(1, 2).contiguous())
        want = k2.so3_gate_ffn_bwd_plain(*args, lmax, 2 * y.detach())
        got = (x.grad, ffn.w1.grad.transpose(1, 2), ffn.b1.grad, ffn.gate_kernel.grad,
               ffn.gate_bias.grad, ffn.w2.grad.transpose(1, 2), ffn.b2.grad)
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


BF16_TOL = 1e-2  # chip_smoke.py's hold of a bfloat16 instance


def _check_bf16(got, want, names):
    """A bfloat16 instance against its bfloat16 plain twin, as
    ``chip_smoke.py`` holds it: the same dtype, each output within 1e-2 of
    its largest magnitude. Both round the same values at the same points and
    sum in another order, so a value on a rounding boundary lands a
    bfloat16 step (2^-8 relative) away and carries into what follows."""
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BF16_TOL * b.float().abs().max().item(), (name, err)


def _bf16(args, at):
    return [a.to(torch.bfloat16) if i in at else a for i, a in enumerate(args)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_k24", "random_k96", "path"])
def test_neighbor_attn_bf16_instance_matches_its_twin(dev, case):
    """K1's and K1b's bfloat16 instances (qt, k, v, diag_value and the
    cotangent bfloat16) against ``neighbor_attn_bf16_plain`` and its
    backward, counted in ``launches_bf16`` / ``launches_bwd_bf16`` and not in
    the float32 counters; K7's bfloat16 instance on the same rows gathered
    is held to the same twin and counted in ``launches_hybrid_bf16``."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _bf16(_list_bwd_case(dev, case), (0, 1, 2, 7, 18))
    *fwd, coeff, g = args
    n = (k1.launches, k1.launches_bwd, k1.launches_bf16, k1.launches_bwd_bf16)
    got = k1.neighbor_attn_cuda(*fwd, coeff)
    _check_bf16([got], [k1.neighbor_attn_plain(*fwd, coeff)], ["out"])
    offsets, slots = k1.transpose_slots(args[3])
    grads = k1.neighbor_attn_bwd_cuda(*args, offsets=offsets, slots=slots)
    _check_bf16(grads, k1.neighbor_attn_bwd_plain(*args), BWD_NAMES)
    assert (k1.launches, k1.launches_bwd, k1.launches_bf16, k1.launches_bwd_bf16) == (
        n[0], n[1], n[2] + 1, n[3] + 1)
    m = (k1.launches_hybrid, k1.launches_hybrid_bf16)
    got = k1.neighbor_attn_hybrid_cuda(*_as_hybrid(fwd)[:3], *fwd[4:], coeff)
    _check_bf16([got], [k1.neighbor_attn_plain(*fwd, coeff)], ["out"])
    assert (k1.launches_hybrid, k1.launches_hybrid_bf16) == (m[0], m[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C", [(6, 37, 512, 16), (6, 2003, 512, 16), (4, 8, 40, 32),
                                        (2, 3, 64, 12)])
def test_so3_gate_ffn_bf16_instance_matches_its_twin(dev, lmax, N, H, C):
    """K2's and K2b's bfloat16 instances (x, y, dy and dx bfloat16, the
    weights float32) against their bfloat16 twins: the main path's widths,
    several weight-kernel slices, 32 and 12 channels; K4 refuses a bfloat16
    x beside float32 grid matrices."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    L = lmax + 1
    rng = np.random.default_rng(83 + N)
    f = lambda *s: _t(rng.normal(size=s).astype(np.float32), dev)
    args = [f(N, L * L, C).to(torch.bfloat16), 0.3 * f(L, C, H), 0.1 * f(H),
            0.3 * f(C, lmax * H), 0.1 * f(lmax * H), 0.1 * f(L, H, C), 0.1 * f(C)]
    dy = f(N, L * L, C).to(torch.bfloat16)
    n = (k2.launches, k2.launches_bwd, k2.launches_bf16, k2.launches_bwd_bf16)
    _check_bf16([k2.so3_gate_ffn_cuda(*args, lmax)], [k2.so3_gate_ffn_plain(*args, lmax)], ["y"])
    _check_bf16(k2.so3_gate_ffn_bwd_cuda(*args[:6], lmax, dy),
                k2.so3_gate_ffn_bwd_plain(*args[:6], lmax, dy),
                ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"])
    assert (k2.launches, k2.launches_bwd, k2.launches_bf16, k2.launches_bwd_bf16) == (
        n[0], n[1], n[2] + 1, n[3] + 1)
    with pytest.raises(ValueError, match="dtype"):
        k2.so3_ffn_cuda(args[0], args[1], args[2], f(C, H), f(H), args[5], args[6],
                        f(20, L * L), f(20, L * L), lmax)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,lmax", SEP_CASES)
def test_s2_silu_sep_bf16_instance_matches_its_twin(dev, E, C, lmax):
    """K3's and K3b's bfloat16 instances (x, scalars, the grid matrices, the
    cotangent and every output bfloat16) against their bfloat16 twins."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    x, s, tg, fg, g = (a.to(torch.bfloat16) for a in _sep_case(dev, E, C, lmax, 67 + E, True))
    n = (k3.launches, k3.launches_bwd, k3.launches_bf16, k3.launches_bwd_bf16)
    _check_bf16([k3.s2_silu_sep_cuda(x, s, tg, fg)], [k3.s2_silu_sep_plain(x, s, tg, fg)],
                ["out"])
    _check_bf16(k3.s2_silu_sep_bwd_cuda(x, s, tg, fg, g), k3.s2_silu_sep_bwd_plain(x, s, tg, fg, g),
                ["dx", "ds"])
    assert (k3.launches, k3.launches_bwd, k3.launches_bf16, k3.launches_bwd_bf16) == (
        n[0], n[1], n[2] + 1, n[3] + 1)


def _trace(fn):
    """fn()'s result, the names of the device events of one trace of it
    (torch.profiler), and whether the trace holds as many device kernels as
    its host events launched (``cudaLaunchKernel`` and the like), with a
    note of what it held when it does not."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.key for e in device]
    launched = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    kernels = sum(e.count for e in device if not e.is_user_annotation
                  and not e.key.startswith(("Memcpy", "Memset")))
    host = [e.key for e in events]
    api = sorted({k for k in host if k.startswith("cu")})
    note = (f"held {kernels} device kernels of {launched} launched ({names}; {len(host)} host "
            f"events; CUDA API calls {api})")
    return out, names, bool(names) and kernels >= launched, note


def _kernels_run(fn, tries=3):
    """fn()'s result on the card, the names of the kernels it launched
    there (torch.profiler) and how many times fn ran in this process. On
    the card the profiler returns no device event at all for about one
    traced call in 450, two consecutive traces at a time, whatever the call
    (a torch elementwise op too; its host events hold the launch):
    tools/profiler_traces.py measures it; and a trace may hold some of the
    call's kernels and not others, most often late in a process that has
    traced many calls. A trace with fewer device kernels than its host
    events launched is taken again, fn with it, up to ``tries`` times, and
    each such trace is reported as a warning, with what it did hold, so
    that a run's warnings summary counts them. If every one fell short, fn
    is traced in a fresh process (``_fresh_names``: fn, a
    ``functools.partial`` of module-level functions and their arguments,
    saved with torch.save), whose names are returned."""
    for calls in range(1, tries + 1):
        out, names, whole, note = _trace(fn)
        if whole:
            return out, names, calls
        warnings.warn(f"_kernels_run: trace {calls} of {tries} {note}", stacklevel=2)
    return out, _fresh_names(fn, tries), calls


_FRESH = """
import json, sys, warnings
import torch
import test_torch_cuda as t
fn = torch.load(sys.argv[1], weights_only=False)
fn()
for i in range(1, int(sys.argv[2]) + 1):
    _, names, whole, note = t._trace(fn)
    if whole:
        break
    warnings.warn(f"fresh process: trace {i} {note}")
print(json.dumps(names))
"""


def _fresh_names(fn, tries):
    """The kernel names of a trace of fn() in a fresh Python process (after
    one untraced call there), retraced as ``_kernels_run`` retraces."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(tests), tests] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.pt")
        torch.save(fn, path)
        p = subprocess.run([sys.executable, "-c", _FRESH, path, str(tries)], capture_output=True,
                           text=True, env=env, timeout=900)
    if p.returncode:
        raise RuntimeError(f"fresh-process trace failed:\n{p.stderr[-4000:]}")
    if p.stderr.strip():
        warnings.warn(f"_kernels_run, fresh process: {p.stderr.strip()[-2000:]}", stacklevel=3)
    return json.loads(p.stdout.strip().splitlines()[-1])


def _with_stats(fn, stats, *args, **kw):
    """fn(*args, stats=stats, **kw) with ``stats`` zeroed first: a traced
    call may run more than once."""
    return fn(*args, stats=stats.zero_(), **kw)


# K3's and K3b's bfloat16 cases (E, C, lmax, tensor cores): the lmax 6 / mmax 2
# grid at 50 edges and at a training microbatch's 31,744 stage-1 edges; C
# 16 with a ragged last warp tile (37 x 16 columns: the 32-column tiles end
# half full); lmax 4 and 2 (C 64, and C 16 ragged); one edge of 16
# channels; then C 100, which only the CUDA-core instance takes
K3_BF16_CASES = [(50, 128, 6, True), (31744, 128, 6, True), (37, 16, 6, True),
                 (37, 64, 4, True), (9, 16, 2, True), (1, 16, 6, True), (9, 100, 6, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,lmax,tc", K3_BF16_CASES)
def test_s2_silu_sep_bf16_instance_by_shape_and_kernel(dev, E, C, lmax, tc):
    """K3's and K3b's bfloat16 instances against their bfloat16 twins, and
    which kernels ran: the tensor-core kernels at bfloat16 (never the
    CUDA-core instance) at the shapes they take, the CUDA-core kernels at
    bfloat16 at C 100 and, under ``cuda_cores=True``, at every case; one
    bfloat16 launch a call, none of the float32 counters."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    x, s, tg, fg, g = (a.to(torch.bfloat16) for a in _sep_case(dev, E, C, lmax, 71 + E, True))
    I, G = tg.shape[1], tg.shape[0]
    assert k3.s2_silu_sep_instance(I, C, G, bf16=True) == ("tensor_cores" if tc else "cuda_cores")
    want = k3.s2_silu_sep_plain(x, s, tg, fg)
    want_g = k3.s2_silu_sep_bwd_plain(x, s, tg, fg, g)
    for cuda_cores in (False, True):
        n = (k3.launches, k3.launches_bwd, k3.launches_bf16, k3.launches_bwd_bf16)
        got, names, calls = _kernels_run(
            functools.partial(k3.s2_silu_sep_cuda, x, s, tg, fg, cuda_cores=cuda_cores))
        _check_bf16([got], [want], ["out"])
        grads, bnames, bcalls = _kernels_run(
            functools.partial(k3.s2_silu_sep_bwd_cuda, x, s, tg, fg, g, cuda_cores=cuda_cores))
        _check_bf16(grads, want_g, ["dx", "ds"])
        assert (k3.launches, k3.launches_bwd, k3.launches_bf16, k3.launches_bwd_bf16) == (
            n[0], n[1], n[2] + calls, n[3] + bcalls)
        for ran, kernel in ((names, "s2_silu_sep_"), (bnames, "s2_silu_sep_bwd_")):
            ran = [m for m in ran if "s2_silu_sep" in m]
            ran_tc = [m for m in ran if f"{kernel}tc_kernel" in m]
            ran_cc = [m for m in ran if f"cc::{kernel}kernel" in m]
            assert all("bfloat16" in m for m in ran) and len(ran) == 1, ran
            if tc and not cuda_cores:
                assert ran_tc and not ran_cc, ran
            else:
                assert ran_cc and not ran_tc, ran


@pytest.mark.cuda
def test_s2_silu_sep_bf16_residency(dev):
    """K3's and K3b's bfloat16 tensor-core kernels take the shapes their
    float32 kernels take (lmax 6, 4, 2 at mmax 2; I 32) and no other; their
    blocks at I 29, C 128, G 70: one an SM, K3 20 warps of 32 columns in
    150,208 B of shared memory, K3b 15 warps of 32 columns in 225,888 B
    (the fragments' hi plane alone and bfloat16 raw stages: half the
    float32 kernels' bytes a column); the float32 kernels' residency is
    unchanged."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    shapes = [(29, 128, 70), (19, 64, 50), (9, 16, 42), (32, 16, 70), (29, 100, 70),
              (29, 8, 70), (9, 1, 42), (36, 128, 20), (33, 16, 70)]
    assert ({w: k3.s2_silu_sep_instance(*w, bf16=True) for w in shapes}
            == {w: k3.s2_silu_sep_instance(*w) for w in shapes})
    fwd = k3.sep_residency(29, 128, 70, bf16=True)
    bwd = k3.sep_residency(29, 128, 70, bwd=True, bf16=True)
    assert fwd == {"blocks_per_sm": 1, "threads": 640, "smem_bytes": 150208}, fwd
    assert bwd == {"blocks_per_sm": 1, "threads": 480, "smem_bytes": 225888}, bwd
    assert k3.sep_residency(29, 100, 70, bf16=True)["blocks_per_sm"] == -1
    assert k3.sep_residency(29, 128, 70) == {"blocks_per_sm": 1, "threads": 512,
                                             "smem_bytes": 219776}


@pytest.mark.cuda
def test_s2_silu_sep_bf16_takes_misaligned_inputs(dev):
    """K3's and K3b's bfloat16 instances given every tensor input as a
    contiguous view at a 2-byte offset (their 16-byte cp.async and 4-byte
    loads would fault) run through the wrappers' aligned copies, on their
    tensor-core kernels, and match their twins."""
    from singa_tpu_torch.ops.cuda import s2_act as k3

    args = [a.to(torch.bfloat16) for a in _sep_case(dev, 37, 128, 6, 99, cotangent=True)]
    mis = [_misaligned(a) for a in args]
    got, names, _ = _kernels_run(functools.partial(k3.s2_silu_sep_cuda, *mis[:4]))
    _check_bf16([got], [k3.s2_silu_sep_plain(*args[:4])], ["out"])
    grads, bnames, _ = _kernels_run(functools.partial(k3.s2_silu_sep_bwd_cuda, *mis))
    _check_bf16(grads, k3.s2_silu_sep_bwd_plain(*args), ["dx", "ds"])
    assert [m for m in names + bnames if "cc::s2_silu_sep" in m] == []
    assert len([m for m in names + bnames if "s2_silu_sep" in m and "tc_kernel" in m]) == 2


# K2b's bfloat16 cases (lmax, N, H, C, Co, tensor cores): Config()'s widths
# at 37 nodes and at 2,003 (a ragged last 16-node tile; several slices of
# the weight kernel's node tiles), lmax 2, 8 channels in; then widths only
# the CUDA-core instance takes (32 and 12 channels)
K2B_BF16_CASES = [(6, 37, 512, 16, 16, True), (6, 2003, 512, 16, 16, True),
                  (2, 9, 64, 16, 16, True), (4, 29, 48, 8, 16, True),
                  (4, 8, 40, 32, 32, False), (2, 3, 64, 12, 12, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co,tc", K2B_BF16_CASES)
def test_so3_gate_ffn_bwd_bf16_instance_by_width(dev, lmax, N, H, C, Co, tc):
    """K2b's bfloat16 instance against its bfloat16 twin, and which kernels
    ran: its tensor-core kernels at bfloat16 (never the CUDA-core instance)
    at the widths they take, the CUDA-core instance at the others and,
    under ``cuda_cores=True``, at those too; one bfloat16 launch a call."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    L = lmax + 1
    rng = np.random.default_rng(91 + N)
    f = lambda *s: _t(rng.normal(size=s).astype(np.float32), dev)
    args = [f(N, L * L, C).to(torch.bfloat16), 0.3 * f(L, C, H), 0.1 * f(H),
            0.3 * f(C, lmax * H), 0.1 * f(lmax * H), 0.1 * f(L, H, Co)]
    dy = f(N, L * L, Co).to(torch.bfloat16)
    want = k2.so3_gate_ffn_bwd_plain(*args, lmax, dy)
    assert k2.so3_gate_ffn_bwd_instance(lmax, C, H, Co) == ("tensor_cores" if tc else "cuda_cores")
    for cuda_cores in (False, True):
        n = (k2.launches_bwd, k2.launches_bwd_bf16)
        got, names, calls = _kernels_run(
            functools.partial(k2.so3_gate_ffn_bwd_cuda, *args, lmax, dy, cuda_cores=cuda_cores))
        _check_bf16(got, want, ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"])
        assert (k2.launches_bwd, k2.launches_bwd_bf16) == (n[0], n[1] + calls)
        ran_cc = [m for m in names if "cc::gate_ffn_bwd" in m]
        ran_tc = [m for m in names if "gate_ffn_bwd_dx_kernel<" in m and "cc::" not in m]
        if tc and not cuda_cores:
            assert ran_tc and not ran_cc, names
            assert all("bfloat16" in m for m in ran_tc), ran_tc
        else:
            assert ran_cc and not ran_tc, names


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_k24", "random_k96", "redo", "path", "heads8",
                                  "ragged_redo"])
def test_neighbor_attn_bwd_bf16_instance_by_width(dev, case):
    """K1b's bfloat16 instance against its bfloat16 twin on the list
    backward's cases (padded rows; a row with no live slot; a row scoring
    -1e9 throughout; a repeated neighbour; a live row taken again whole;
    the path's zero cotangents), and which pair kernel ran: the tensor-core
    one at bfloat16 at the encoder's widths, the CUDA-core one at 8 heads
    and at ragged widths and, under ``cuda_cores=True``, at every case."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    args = _bf16(_list_bwd_case(dev, case), (0, 1, 2, 7, 18))
    tc = case not in ("heads8", "ragged_redo")
    offsets, slots = k1.transpose_slots(args[3])
    want = k1.neighbor_attn_bwd_plain(*args)
    for cuda_cores in (False, True):
        n = (k1.launches_bwd, k1.launches_bwd_bf16)
        got, names, calls = _kernels_run(functools.partial(
            k1.neighbor_attn_bwd_cuda, *args, offsets=offsets, slots=slots, cuda_cores=cuda_cores))
        _check_bf16(got, want, BWD_NAMES)
        assert (k1.launches_bwd, k1.launches_bwd_bf16) == (n[0], n[1] + calls)
        ran_tc = [m for m in names if "list_bwd_pair_kernel" in m or "list_dkdv_kernel" in m]
        ran_cc = [m for m in names if "list_bwd_cc_kernel" in m or "list_dkdv_cc_kernel" in m]
        if tc and not cuda_cores:
            assert len(ran_tc) == 2 and not ran_cc, names
            assert all("bfloat16" in m for m in ran_tc), ran_tc
        else:
            assert len(ran_cc) == 2 and not ran_tc, names


# K1's bfloat16 cases (tensor cores): random lists at K 24 and 96 (non-prefix
# masks, a real row with no live slot, padded rows, a repeated neighbour);
# N 1; a live row taken again whole; the main path's shapes with 150 padded
# rows a graph; those rows as copies; 3 heads (a row taken again); then
# widths only the CUDA-core instance takes
K1_BF16_CASES = [("random_k24", True), ("random_k96", True), ("n1", True), ("redo", True),
                 ("path", True), ("copies", True), ("h3", True), ("heads8", False),
                 ("k160", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,tc", K1_BF16_CASES)
def test_neighbor_attn_bf16_fwd_instance_by_width(dev, case, tc):
    """K1's bfloat16 instance against its bfloat16 twin on the list
    forward's cases, and which kernels ran: the tensor-core plan, tile and
    copy kernels at bfloat16 at the encoder's widths, walking the rows the
    float32 kernel walks on the same mask (the live slots, the dead-weighted
    rows evaluated, the copies, the rows taken again); the CUDA-core
    attn_fwd_kernel at bfloat16 at 8 heads and at K 160 and, under
    ``cuda_cores=True``, at every case (counting nothing); one bfloat16
    launch a call."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    f32 = _list_fwd_case(dev, case)
    args = _bf16(f32, (0, 1, 2, 7))
    want = k1.neighbor_attn_plain(*args)
    assert want.dtype == torch.bfloat16
    walked32 = torch.zeros(4, dtype=torch.int32, device=dev)
    k1.neighbor_attn_cuda(*f32, stats=walked32)
    for cuda_cores in (False, True):
        n = (k1.launches, k1.launches_bf16)
        walked = torch.zeros(4, dtype=torch.int32, device=dev)
        got, names, calls = _kernels_run(functools.partial(
            _with_stats, k1.neighbor_attn_cuda, walked, *args, cuda_cores=cuda_cores))
        _check_bf16([got], [want], ["out"])
        assert (k1.launches, k1.launches_bf16) == (n[0], n[1] + calls)
        ran_tc = [m for m in names if "list_fwd_" in m]
        ran_cc = [m for m in names if "attn_fwd_kernel" in m]
        if tc and not cuda_cores:
            assert len(ran_tc) == 3 and not ran_cc, names
            assert all("bfloat16" in m for m in ran_tc), ran_tc
            assert walked.tolist() == walked32.tolist()
        else:
            assert len(ran_cc) == 1 and "bfloat16" in ran_cc[0] and not ran_tc, names
            assert walked.tolist() == [0, 0, 0, 0]


# K2's bfloat16 cases (lmax, N, H, C, Co, tensor cores): Config()'s widths at
# 37 nodes, at 2,003 (a ragged last 16-node tile) and at 1; lmax 2, 4, 5
# and 7 with 8 or 16 channels; then widths only the CUDA-core instance
# takes (32 and 12 channels)
K2_BF16_CASES = [(6, 37, 512, 16, 16, True), (6, 2003, 512, 16, 16, True),
                 (6, 1, 512, 16, 16, True), (2, 9, 64, 16, 16, True), (4, 29, 48, 8, 16, True),
                 (5, 21, 40, 16, 8, True), (7, 17, 40, 8, 8, True),
                 (4, 8, 40, 32, 32, False), (2, 3, 64, 12, 12, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co,tc", K2_BF16_CASES)
def test_so3_gate_ffn_bf16_fwd_instance_by_width(dev, lmax, N, H, C, Co, tc):
    """K2's bfloat16 instance against its bfloat16 twin, and which kernels
    ran: its tensor-core kernel and weight split at bfloat16 (never the
    CUDA-core instance) at the widths they take, the CUDA-core instance at
    the others and, under ``cuda_cores=True``, at those too; one bfloat16
    launch a call."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    x, *w = _gate_ffn_case(dev, lmax, N, H, C, Co, 101 + N)
    args = [x.to(torch.bfloat16), *w]
    want = k2.so3_gate_ffn_plain(*args, lmax)
    assert want.dtype == torch.bfloat16
    assert k2.so3_gate_ffn_instance(lmax, C, H, Co) == ("tensor_cores" if tc else "cuda_cores")
    for cuda_cores in (False, True):
        n = (k2.launches, k2.launches_bf16)
        got, names, calls = _kernels_run(
            functools.partial(k2.so3_gate_ffn_cuda, *args, lmax, cuda_cores=cuda_cores))
        _check_bf16([got], [want], ["y"])
        assert (k2.launches, k2.launches_bf16) == (n[0], n[1] + calls)
        ran_tc = [m for m in names if "gate_ffn_tc_kernel<" in m or "gate_ffn_wsplit_kernel<" in m]
        ran_cc = [m for m in names if "cc::gate_ffn_kernel<" in m]
        if tc and not cuda_cores:
            assert len(ran_tc) == 2 and not ran_cc, names
            assert all("bfloat16" in m for m in ran_tc), ran_tc
        else:
            assert len(ran_cc) == 1 and "bfloat16" in ran_cc[0] and not ran_tc, names


@pytest.mark.cuda
def test_bf16_forwards_take_misaligned_inputs(dev):
    """K1's and K2's bfloat16 instances given every tensor input as a
    contiguous view at a 2-byte offset (their 16- and 8-byte loads and
    cp.async would fault) run through the wrappers' aligned copies, on
    their tensor-core kernels, and match their twins."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    *fwd, coeff = _bf16(_list_fwd_case(dev, "random_k24"), (0, 1, 2, 7))
    got = k1.neighbor_attn_cuda(*[_misaligned(a) for a in fwd], coeff)
    _check_bf16([got], [k1.neighbor_attn_plain(*fwd, coeff)], ["out"])
    x, *w = _gate_ffn_case(dev, 6, 37, 512, 16, 16, 103)
    x = x.to(torch.bfloat16)
    got = k2.so3_gate_ffn_cuda(*[_misaligned(a) for a in (x, *w)], 6)
    _check_bf16([got], [k2.so3_gate_ffn_plain(x, *w, 6)], ["y"])


@pytest.mark.cuda
def test_bf16_backwards_take_misaligned_inputs(dev):
    """K1b's and K2b's bfloat16 instances given every tensor input as a
    contiguous view at a 2-byte offset (their 16- and 8-byte loads would
    fault) run through the wrappers' aligned copies and match their twins."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    args = _bf16(_list_bwd_case(dev, "random_k24"), (0, 1, 2, 7, 18))
    offsets, slots = k1.transpose_slots(args[3])
    got = k1.neighbor_attn_bwd_cuda(*[_misaligned(a) for a in args], offsets=offsets,
                                    slots=slots)
    _check_bf16(got, k1.neighbor_attn_bwd_plain(*args), BWD_NAMES)
    x, *w = _gate_ffn_case(dev, 6, 37, 512, 16, 16, 97)[:6]
    x = x.to(torch.bfloat16)
    dy = _t(np.random.default_rng(98).normal(size=(37, 49, 16)).astype(np.float32),
            dev).to(torch.bfloat16)
    got = k2.so3_gate_ffn_bwd_cuda(*[_misaligned(a) for a in (x, *w)], 6, _misaligned(dy))
    _check_bf16(got, k2.so3_gate_ffn_bwd_plain(x, *w, 6, dy),
                ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"])


# K4's and K4b's bfloat16 cases (lmax, N, H, C, Co): the s2 training
# microbatch's widths at 37 nodes (a ragged last tile of K4's 8 nodes and of
# K4b's 4) and at 2,003, lmax 4 and 2 (2: 8 channels, a hidden width no
# multiple of 16), lmax 3, and one node
K4_BF16_CASES = [(6, 37, 512, 16, 16), (6, 2003, 512, 16, 16), (4, 37, 512, 16, 16),
                 (2, 9, 40, 8, 8), (3, 13, 64, 16, 16), (6, 1, 512, 16, 16)]
K4_NAMES = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]


def _s2_ffn_bf16_case(dev, lmax, N, H, C, Co, seed):
    """``_s2_ffn_case`` at bfloat16: x, the grid matrices and the cotangent
    bfloat16 (as the module passes them), the weights float32; and the
    backward's arguments."""
    args, dy = _s2_ffn_case(dev, lmax, N, H, C, Co, seed)
    args = _bf16(args, (0, 7, 8))
    dy = dy.to(torch.bfloat16)
    return args, [*args[:6], *args[7:], lmax, dy]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", K4_BF16_CASES)
def test_so3_ffn_bf16_instance_by_width(dev, lmax, N, H, C, Co):
    """K4's and K4b's bfloat16 instances against their bfloat16 twins
    (``BF16_TOL`` of each output's largest; y and dx bfloat16, the six
    weight and bias gradients float32), and which kernels ran: K4's
    bfloat16 kernel and its weight kernel, K4b's kernel at bfloat16 and
    the sums' second pass, never the CUDA-core instance nor K4's float32
    tensor-core kernel; one bfloat16 launch a call, none of the float32
    counters."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    args, bwd_args = _s2_ffn_bf16_case(dev, lmax, N, H, C, Co, 131 + N)
    G = args[7].shape[0]
    assert k4.s2_fwd_instance(lmax, C, H, Co, G, bf16=True) == "tensor_cores"
    want = k4.so3_ffn_plain(*args, lmax)
    want_g = k4.so3_ffn_bwd_plain(*bwd_args)
    assert want.dtype == want_g[0].dtype == torch.bfloat16
    n = (k4.launches_s2, k4.launches_s2_bwd, k4.launches_s2_bf16, k4.launches_s2_bwd_bf16)
    got, names, calls = _kernels_run(functools.partial(k4.so3_ffn_cuda, *args, lmax))
    _check_bf16([got], [want], ["y"])
    grads, bnames, bcalls = _kernels_run(functools.partial(k4.so3_ffn_bwd_cuda, *bwd_args))
    _check_bf16(grads, want_g, K4_NAMES)
    assert (k4.launches_s2, k4.launches_s2_bwd, k4.launches_s2_bf16,
            k4.launches_s2_bwd_bf16) == (n[0], n[1], n[2] + calls, n[3] + bcalls)
    ran = [m for m in names if "ffn_" in m]
    assert len(ran) == 2, ran
    assert any("ffn_fwd_bf16_kernel<" in m for m in ran) and any(
        "ffn_wfrag_bf16_kernel" in m for m in ran), ran
    bran = [m for m in bnames if "ffn_bwd_" in m]
    assert len(bran) == 1 and "ffn_bwd_bf16_kernel<" in bran[0], bnames
    assert [m for m in names + bnames if "ffn_cc_kernel" in m] == []


@pytest.mark.cuda
def test_so3_ffn_bf16_refuses_widths_it_does_not_take(dev):
    """At a width the bfloat16 instances do not take (lmax 7; 24 sphere
    channels; 20 output channels) a bfloat16 call raises and launches
    nothing: no bfloat16 CUDA-core instance, no float32 kernel, no plain
    version takes its place; its float32 call at the same widths runs."""
    from torch.profiler import ProfilerActivity, profile

    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    for lmax, N, H, C, Co in ((7, 9, 40, 8, 8), (3, 13, 40, 24, 24), (3, 13, 40, 16, 20)):
        args, bwd_args = _s2_ffn_bf16_case(dev, lmax, N, H, C, Co, 137)
        assert k4.s2_fwd_instance(lmax, C, H, Co, args[7].shape[0], bf16=True) is None
        n = (k4.launches_s2, k4.launches_s2_bwd, k4.launches_s2_bf16, k4.launches_s2_bwd_bf16)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with pytest.raises(ValueError):
                k4.so3_ffn_cuda(*args, lmax)
            with pytest.raises(ValueError, match="not supported at bfloat16"):
                k4.so3_ffn_bwd_cuda(*bwd_args)
            torch.cuda.synchronize()
        ran = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "ffn" in e.key]
        assert ran == [], ran
        assert (k4.launches_s2, k4.launches_s2_bwd, k4.launches_s2_bf16,
                k4.launches_s2_bwd_bf16) == n
        if lmax < 7:  # K4b's float32 kernel refuses lmax 7 (shared memory)
            f32 = [a.float() if torch.is_tensor(a) else a for a in bwd_args]
            k4.so3_ffn_bwd_cuda(*f32)
        k4.so3_ffn_cuda(*[a.float() for a in args], lmax)
        assert (k4.launches_s2, k4.launches_s2_bwd) == (n[0] + 1, n[1] + (lmax < 7))


@pytest.mark.cuda
def test_so3_ffn_bf16_residency(dev):
    """K4's and K4b's bfloat16 kernels at the s2 microbatch's widths (lmax
    6, C = Co = 16, H 512, G 210): one block an SM of 512 threads each;
    K4's in 140,288 bytes (two chunks' weights, the halves' exchange, the
    gates, row 48's y sums, b2 and the degrees as float32 words, 44,640 B;
    tg, fg, h, x and mid as bfloat16, 95,648 B), less than its float32
    kernel, K4b's in 221,056 bytes (tg, fg, h^T and dmid^T as
    bfloat16 [*][56], 78,848 B; x, dy, mid, dh, the weights and the sums of
    a 32-channel chunk as float32, 142,208 B); lmax 7 refused at bfloat16;
    the float32 kernels' residency unchanged."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    widths = (6, 16, 512, 16, 210)
    fwd, fwd32 = k4.s2_fwd_residency(*widths, bf16=True), k4.s2_fwd_residency(*widths)
    bwd, bwd32 = k4.s2_bwd_residency(*widths, bf16=True), k4.s2_bwd_residency(*widths)
    assert fwd == {"blocks_per_sm": 1, "threads": 512, "smem_bytes": 140288}, fwd
    assert fwd["smem_bytes"] < fwd32["smem_bytes"], (fwd, fwd32)
    assert bwd32 == {"blocks_per_sm": 1, "threads": 512, "smem_bytes": 225792}, bwd32
    assert bwd == {"blocks_per_sm": 1, "threads": 512, "smem_bytes": 221056}, bwd
    assert fwd32["blocks_per_sm"] == 1 and fwd32["threads"] == 256, fwd32
    assert k4.s2_fwd_residency(7, 8, 40, 8, 272, bf16=True)["blocks_per_sm"] == -1
    assert k4.s2_bwd_residency(7, 8, 40, 8, 272, bf16=True)["blocks_per_sm"] == -1


@pytest.mark.cuda
def test_so3_ffn_bf16_takes_misaligned_inputs(dev):
    """K4's and K4b's bfloat16 instances given every tensor input as a
    contiguous view at a one-element offset (their 8-byte loads of x, dy
    and dx would fault) run through the wrappers' aligned copies, on their
    bfloat16 kernels, and match their twins."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    args, bwd_args = _s2_ffn_bf16_case(dev, 6, 37, 512, 16, 16, 139)
    got, names, _ = _kernels_run(
        functools.partial(k4.so3_ffn_cuda, *[_misaligned(a) for a in args], 6))
    _check_bf16([got], [k4.so3_ffn_plain(*args, 6)], ["y"])
    grads, bnames, _ = _kernels_run(
        functools.partial(k4.so3_ffn_bwd_cuda, *[_misaligned(a) for a in bwd_args]))
    _check_bf16(grads, k4.so3_ffn_bwd_plain(*bwd_args), K4_NAMES)
    ran = [m for m in names + bnames if "ffn_fwd_bf16_kernel<" in m or "ffn_bwd_" in m]
    assert len(ran) == 2, names + bnames
    assert any("ffn_bwd_bf16_kernel<" in m for m in ran), ran


# K4b·bf16's chain at every width it takes (lmax, N, H, C, Co): lmax 1..6
# (I 4 .. 49: one to three k16 steps, row 48 apart at lmax 6), C and Co of
# 4, 8 and 16, node counts no multiple of its 4-node tile, hidden widths no
# multiple of its 32-channel chunk, and no node at all
K4B_BF16_WIDTHS = [(1, 5, 24, 4, 4), (2, 7, 40, 8, 4), (3, 9, 64, 4, 16), (4, 11, 48, 16, 8),
                   (5, 13, 96, 8, 8), (6, 10, 72, 16, 4), (6, 3, 512, 4, 16),
                   (6, 0, 64, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", K4B_BF16_WIDTHS)
def test_so3_ffn_bwd_bf16_mma_chain_by_width(dev, lmax, N, H, C, Co):
    """K4b·bf16 (``ffn_bwd_bf16_kernel``, its grid chain on bfloat16
    m16n8k16 mma.sync) against ``so3_ffn_bf16_bwd_plain`` within
    ``BF16_TOL`` of each output's largest, one bfloat16 launch a call; at N
    = 0 no launch, an empty dx and zero weight and bias gradients."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    _, bwd_args = _s2_ffn_bf16_case(dev, lmax, N, H, C, Co, 149 + 7 * lmax + N)
    want = k4.so3_ffn_bwd_plain(*bwd_args)
    n = (k4.launches_s2_bwd, k4.launches_s2_bwd_bf16)
    if N == 0:
        got = k4.so3_ffn_bwd_cuda(*bwd_args)
        assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
        assert all(not bool(g.any()) for g in got[1:])
        assert (k4.launches_s2_bwd, k4.launches_s2_bwd_bf16) == n
        return
    got, names, calls = _kernels_run(functools.partial(k4.so3_ffn_bwd_cuda, *bwd_args))
    _check_bf16(got, want, K4_NAMES)
    assert (k4.launches_s2_bwd, k4.launches_s2_bwd_bf16) == (n[0], n[1] + calls)
    ran = [m for m in names if "ffn_bwd_" in m]
    assert len(ran) == 1 and "ffn_bwd_bf16_kernel<" in ran[0], names


# K4·bf16's kernel at the widths it takes (lmax, N, H, C, Co): lmax 6, 4 and
# 1 (I 49 with row 48 apart, 25, 4), C = Co of 4, 8 and 16 (x in 8-byte
# pieces at 4), node counts no multiple of its 8-node tile, hidden widths
# no multiple of its 16-channel chunk
K4_BF16_MMA_WIDTHS = [(6, 13, 72, 16, 16), (6, 21, 40, 8, 8), (6, 5, 24, 4, 4),
                      (4, 11, 48, 16, 16), (4, 9, 56, 8, 8), (4, 19, 32, 4, 4),
                      (1, 7, 40, 16, 16), (1, 3, 24, 8, 8), (1, 17, 16, 4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("lmax,N,H,C,Co", K4_BF16_MMA_WIDTHS)
def test_so3_ffn_fwd_bf16_mma_by_width(dev, lmax, N, H, C, Co):
    """K4·bf16 (``ffn_fwd_bf16_kernel``: h, the grid transforms and y on
    bfloat16 m16n8k16 mma.sync) against ``so3_ffn_bf16_plain`` within
    ``BF16_TOL`` of y's largest, its kernel and weight kernel launched
    once a call."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    args, _ = _s2_ffn_bf16_case(dev, lmax, N, H, C, Co, 151 + 5 * lmax + N)
    want = k4.so3_ffn_plain(*args, lmax)
    n = (k4.launches_s2, k4.launches_s2_bf16)
    got, names, calls = _kernels_run(functools.partial(k4.so3_ffn_cuda, *args, lmax))
    _check_bf16([got], [want], ["y"])
    assert (k4.launches_s2, k4.launches_s2_bf16) == (n[0], n[1] + calls)
    for kernel in ("ffn_fwd_bf16_kernel<", "ffn_wfrag_bf16_kernel"):
        assert len([m for m in names if kernel in m]) == 1, (kernel, names)


def _so3_ffn_bf16_float64(x, w1, b1, wg, bg, w2, b2, tg, fg, lmax):
    """``so3_ffn_bf16_plain``'s function with every sum in float64: each
    value rounded to bfloat16 where the Pallas kernel rounds (from float64
    through float32), nothing else rounded."""
    from singa_tpu_torch.dtypes import rounded
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    bf, d = torch.bfloat16, torch.float64
    r = lambda t: rounded(t.float(), bf).to(d)
    l_of = k4._l_of(lmax, x.device)
    xd, tgd, fgd = x.to(d), r(tg), r(fg)
    gate = r(torch.nn.functional.silu(xd[:, 0, :] @ r(wg) + bg.to(d)))
    h = torch.einsum("nic,ich->nih", xd, r(w1).index_select(0, l_of))
    h = r(torch.cat([h[:, :1] + b1.to(d), h[:, 1:]], dim=1))
    act = r(torch.nn.functional.silu(torch.einsum("gi,nih->ngh", tgd, h)))
    mid = torch.einsum("gi,ngh->nih", fgd, act)
    mid = r(torch.cat([gate[:, None, :], mid[:, 1:]], dim=1))
    y = torch.einsum("nih,iho->nio", mid, r(w2).index_select(0, l_of))
    return torch.cat([y[:, :1] + b2.to(d), y[:, 1:]], dim=1).float().to(bf)


@pytest.mark.cuda
def test_so3_ffn_fwd_bf16_flips_no_more_than_its_twin(dev):
    """K4·bf16 (its products on bfloat16 m16n8k16, sums in another order)
    at the s2 microbatch's widths against a float64 rendering of its
    function (``_so3_ffn_bf16_float64``): the share of y's elements a
    bfloat16 step away from it is at most twice its float32 twin's plus
    0.1 % (a sum of another order flips a rounding on a boundary; an
    error in the arithmetic would flip many), and each is within
    ``BF16_TOL`` of y's largest."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    args, _ = _s2_ffn_bf16_case(dev, 6, 2003, 512, 16, 16, 173)
    want = _so3_ffn_bf16_float64(*args, 6)
    got, twin = k4.so3_ffn_cuda(*args, 6), k4.so3_ffn_plain(*args, 6)
    torch.cuda.synchronize()
    share = lambda a: (a != want).float().mean().item()
    assert share(got) <= 2 * share(twin) + 1e-3, (share(got), share(twin))
    _check_bf16([got, twin], [want, want], ["y", "y (twin)"])


@pytest.mark.cuda
@pytest.mark.parametrize("ta,tb", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_mma_bf16_tile_matches_float64(dev, ta, tb):
    """One [48 x 64] . [64 x 32] product through csrc/mma_bf16.cuh
    (ldmatrix, .trans where A is stored [k][m] or B [k][n], bfloat16
    m16n8k16 mma.sync) against the float64 product of the same bfloat16
    values: within 2e-6 of the largest output (the products exact, the
    sums float32)."""
    import ctypes

    from singa_tpu_torch.ops.cuda import build

    M, K, N = 48, 64, 32
    rng = np.random.default_rng(71 + 2 * ta + tb)
    a = torch.as_tensor(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    b = torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32)).to(torch.bfloat16)
    fn = build.load("mma_tf32").mma_bf16_tile_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sa = (a.T if ta else a).contiguous().to(dev)
    sb = (b.T if tb else b).contiguous().to(dev)
    out = torch.full((M, N), float("nan"), dtype=torch.float32, device=dev)
    build.check(fn(sa.data_ptr(), sb.data_ptr(), out.data_ptr(), M, K, N, ta, tb,
                   build.stream_ptr(out)), "mma_bf16_tile")
    torch.cuda.synchronize()
    want = a.double() @ b.double()
    err = (out.cpu().double() - want).abs().max() / want.abs().max()
    assert err.item() <= 2e-6, err.item()


@pytest.mark.cuda
def test_bf16_kernels_issue_bf16_mma_in_sass(dev):
    """``tools/sass_mma.py``'s checks: K4·bf16's and K4b·bf16's kernels and
    the bfloat16 GEMM of K6·bf16 and K6b·bf16 issue ``HMMA.16816.F32.BF16``
    and no TF32 HMMA, K6's bfloat16 grid stages and K8b·bf16's tensor-core
    pair kernel TF32 HMMA, the float32 GEMM no bfloat16 one (cuobjdump
    -sass of the built libraries)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "sass_mma.py")
    spec = importlib.util.spec_from_file_location("sass_mma", path)
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    res = sass.check()
    assert res["ok"], [c for c in res["checks"] if not c["ok"]]


def _so2_case(dev, E, lmax, C, H, F2, alpha_ch, seed):
    """K6's arguments (mmax 2, non-zero b1 and b2, the m-primary grid of
    lmax) and the cotangents of its four outputs."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda.so2_attn import sections

    secs = sections(lmax, 2)
    n0, extra = secs[0], alpha_ch + H
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: _t((sc * rng.normal(size=s)).astype(np.float32), dev)
    w1s = [f(r * C, r * H + (extra if i == 0 else 0), sc=0.1) for i, r in enumerate(secs)]
    w2s = [f(r * H, r * F2, sc=0.05) for r in secs]
    tg, fg = (_t(m, dev) for m in _grid_mats_for(lmax, 2, True))
    args = [f(E, (lmax + 1) ** 2, C), 1.0 + f(E, sum(secs), C, sc=0.3),
            _t(rng.uniform(-np.pi, np.pi, E).astype(np.float32), dev),
            _t(rng.uniform(0, np.pi, E).astype(np.float32), dev),
            w1s, f(n0 * H + extra, sc=0.3), w2s, f(n0 * F2, sc=0.3), tg, fg, lmax, 2, H, F2, alpha_ch]
    cts = [f(E, r * F2) for r in secs] + [f(E, extra)]
    return args, cts


def _so2_bwd_args(args, cts):
    """K6b's arguments from K6's: b2 gets its gradient from dz0 alone."""
    return [*args[:7], *args[8:], *cts]


SO2_CASES = [(300, 6, 32, 128, 112, 224), (0, 6, 32, 128, 112, 224), (37, 3, 8, 40, 12, 6),
             (4000, 6, 32, 128, 112, 224)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,lmax,C,H,F2,alpha_ch", SO2_CASES)
def test_so2_attn_kernels_match_plain(dev, E, lmax, C, H, F2, alpha_ch):
    """K6 and K6b at the default Config's widths (c_in 32, H 128, F2 112,
    224 alpha channels, lmax 6) with an edge count no multiple of the GEMM
    tile, at E = 0, at lmax 3 with a hidden width no multiple of 128 (rows
    of F2 and section offsets no multiple of 4 floats), and at 4,000 edges
    (weight gradients over several edge slices); non-zero biases. K6b: dx,
    drad and every weight and bias gradient."""
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    args, cts = _so2_case(dev, E, lmax, C, H, F2, alpha_ch, 101 + E)
    n, nb = k6.launches, k6.launches_bwd
    got = k6.so2_attn_cuda(*args)
    grads = k6.so2_attn_bwd_cuda(*_so2_bwd_args(args, cts))
    launched = 0 if E == 0 else 1
    assert (k6.launches, k6.launches_bwd) == (n + launched, nb + launched)
    for g, w in zip(got, k6.so2_attn_plain(*args)):
        _check(g, w)
    _check_grads(grads, k6.so2_attn_bwd_plain(*_so2_bwd_args(args, cts)),
                 ["dx", "drad", "dw1_0", "dw1_1", "dw1_2", "db1", "dw2_0", "dw2_1", "dw2_2", "db2"])


@pytest.mark.cuda
def test_so2_attn_bwd_hold_rejects_one_tf32_product(dev):
    """The 1e-4 hold that K6b meets tells split TF32 from one TF32 product
    at the training microbatch's 31,744 stage-1 edges and the default
    widths: the kernel and the split rendering of its arithmetic
    (test_torch_tf32_split.so2_bwd_split) pass it against
    so2_attn_bwd_plain; the same rendering with one TF32 product per conv
    product fails it on at least one output."""
    from test_torch_tf32_split import SO2_GRADS, mm_tf32, so2_bwd_split

    from singa_tpu_torch.ops.cuda import so2_attn as k6

    args, cts = _so2_case(dev, 31744, 6, 32, 128, 112, 224, 107)
    bwd_args = _so2_bwd_args(args, cts)
    nb = k6.launches_bwd
    got = k6.so2_attn_bwd_cuda(*bwd_args)
    assert k6.launches_bwd == nb + 1
    want = k6.so2_attn_bwd_plain(*bwd_args)
    ratios = {"kernel": _hold_ratios(got, want, SO2_GRADS)}
    del got
    ratios["split"] = _hold_ratios(so2_bwd_split(*bwd_args), want, SO2_GRADS)
    ratios["one_tf32"] = _hold_ratios(so2_bwd_split(*bwd_args, mm=mm_tf32), want, SO2_GRADS)
    print(json.dumps({"hold_ratios": ratios}))
    assert max(ratios["kernel"].values()) <= 1.0, ratios
    assert max(ratios["split"].values()) <= 1.0, ratios
    assert max(ratios["one_tf32"].values()) > 1.0, ratios


# (orientation, M, K, N, edge slices, ragged): C [M, N] = A B, A^T B or A B^T
SO2_GEMM_CASES = [("nn", 301, 37, 83, 1, True), ("nt", 301, 37, 83, 1, True),
                  ("tn", 301, 37, 83, 3, True), ("tn", 83, 1001, 37, 3, True),
                  ("nn", 4096, 1536, 1344, 1, False), ("nt", 4096, 1536, 1344, 1, False),
                  ("tn", 1536, 4096, 1344, 3, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("orient,M,K,N,splits,ragged", SO2_GEMM_CASES)
def test_so2_gemm_matches_float64(dev, orient, M, K, N, splits, ragged):
    """The SO(2) chain's GEMM alone (csrc/so2_chain.cuh, split TF32
    mma.sync), in the three orientations the chain uses: NN with a bias
    (conv 1 and 2), NT (dmid, dmpr: B stored [N][K]) and TN with the edges
    as depth, split into 3 slices added in order (dw1, dw2). Ragged cases:
    sizes no multiple of the tile, operands 4 bytes past a 16-byte boundary
    with row strides 3 floats wider than the rows (4-byte copies), an odd
    ldc (scalar stores), and a slice left empty (K 37); the others at conv 2's
    section-1 widths. Within 2e-6 of the largest output of the float64
    product (one TF32 product: ~3e-4)."""
    import ctypes

    from singa_tpu_torch.ops.cuda import build

    rng = np.random.default_rng(109 + M + K + N)
    pad, off = (3, 1) if ragged else (0, 0)
    a_shape = (K, M) if orient == "tn" else (M, K)
    b_shape = (N, K) if orient == "nt" else (K, N)
    a, b = (rng.normal(size=s).astype(np.float32) for s in (a_shape, b_shape))
    bias = rng.normal(size=N).astype(np.float32) if orient == "nn" else None

    def stored(x):  # x at row stride width + pad, `off` floats into its buffer
        buf = np.zeros(off + x.shape[0] * (x.shape[1] + pad), np.float32)
        buf[off:].reshape(x.shape[0], -1)[:, : x.shape[1]] = x
        return _t(buf, dev)

    ta, tb = stored(a), stored(b)
    ldc = N + 1 if ragged and orient != "tn" else N
    out = torch.full((M * ldc,), float("nan"), dtype=torch.float32, device=dev)
    partial = torch.empty(splits * M * N if splits > 1 else 1, dtype=torch.float32, device=dev)
    tbias = _t(bias, dev) if bias is not None else None
    fn = build.load("so2_attn").so2_gemm_f32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    f32 = 4
    build.check(fn(ta.data_ptr() + off * f32, a_shape[1] + pad, tb.data_ptr() + off * f32,
                   b_shape[1] + pad, out.data_ptr(), ldc, M, N, K,
                   tbias.data_ptr() if tbias is not None else None,
                   {"nn": 0, "nt": 1, "tn": 2}[orient], splits, partial.data_ptr(),
                   build.stream_ptr(out)), "so2_gemm")
    torch.cuda.synchronize()
    a64, b64 = (torch.as_tensor(x).to(dev, torch.float64) for x in (a, b))
    want = (a64.T if orient == "tn" else a64) @ (b64.T if orient == "nt" else b64)
    if bias is not None:
        want += torch.as_tensor(bias).to(dev, torch.float64)
    got = out.view(M, ldc)[:, :N].double()
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= 2e-6, err


SO2_GRAD_NAMES = ["dx", "drad", "dw1_0", "dw1_1", "dw1_2", "db1", "dw2_0", "dw2_1", "dw2_2",
                  "db2"]
# K6·bf16's and K6b·bf16's kernels by name (csrc/so2_chain.cuh at T = bf16:
# the GEMM on bfloat16 operands, Bf16In<Out>; the grid stages on the tensor
# cores), each of which a forward and a backward call launch, and their
# float32 instances (the grid's CUDA-core kernels), which neither launches
SO2_BF16_FWD = ("round_weights_kernel", "rotate_fwd_kernel<__nv_bfloat16>",
                r"gemm_kernel<false, false, \w+, singa::so2::Bf16In<float> ?>",
                r"gemm_kernel<false, false, \w+, singa::so2::Bf16In<__nv_bfloat16> ?>",
                "grid_fwd_tc_kernel<")
SO2_BF16_BWD = ("round_weights_kernel", "rotate_fwd_kernel<__nv_bfloat16>",
                r"gemm_kernel<false, false, \w+, singa::so2::Bf16In<float> ?>",
                r"gemm_kernel<false, true, \w+, singa::so2::Bf16In<float> ?>",
                r"gemm_kernel<true, false, \w+, singa::so2::Bf16In<float> ?>",
                "grid_fwd_tc_kernel<", "grid_bwd_tc_kernel<",
                "col_sum_kernel<__nv_bfloat16>", "rotate_bwd_kernel<__nv_bfloat16>")
SO2_F32_KERNELS = (r"gemm_kernel<\w+, \w+, \w+, float>", "rotate_fwd_kernel<float>",
                   "rotate_bwd_kernel<float>", r"grid_fwd_kernel\(", r"grid_bwd_kernel\(")


def _so2_bf16_case(dev, E, lmax, C, H, F2, alpha_ch, seed):
    """``_so2_case`` with x, rad and the cotangents in bfloat16."""
    args, cts = _so2_case(dev, E, lmax, C, H, F2, alpha_ch, seed)
    args[0], args[1] = args[0].to(torch.bfloat16), args[1].to(torch.bfloat16)
    return args, [c.to(torch.bfloat16) for c in cts]


def _check_names(names, want, banned) -> None:
    """Each pattern of ``want`` matches one of the kernels ``names`` or more
    (re.search), each of ``banned`` none."""
    import re

    for pat in want:
        assert [m for m in names if re.search(pat, m)], (pat, names)
    for pat in banned:
        assert not [m for m in names if re.search(pat, m)], (pat, names)


# K6·bf16's cases (E, lmax, C, H, F2, alpha_ch): the default Config's widths
# at 300 edges (no multiple of the GEMM tile) and at a training
# microbatch's 31,744 stage-1 edges; lmax 3 with a hidden width no multiple
# of 128 and rows of F2 no multiple of 8 elements (the GEMM's element-wise
# copies); E = 0
SO2_BF16_CASES = [(300, 6, 32, 128, 112, 224), (31744, 6, 32, 128, 112, 224),
                  (37, 3, 8, 40, 12, 6), (0, 6, 32, 128, 112, 224)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,lmax,C,H,F2,alpha_ch", SO2_BF16_CASES)
def test_so2_attn_bf16_kernels_match_twins(dev, E, lmax, C, H, F2, alpha_ch):
    """K6·bf16 and K6b·bf16 against ``so2_attn_bf16_plain`` and
    ``so2_attn_bwd_bf16_plain`` (``BF16_TOL`` of each output's largest; z,
    extra, dx and drad bfloat16, the weight and bias gradients float32),
    counted in ``launches_bf16`` / ``launches_bwd_bf16`` and not in the
    float32 counters; by name, the stages at bfloat16 ran (the weights'
    rounding, the rotation, the GEMM on bfloat16 operands in the
    orientations each direction runs, the grid), none of their float32
    instances."""
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    args, cts = _so2_bf16_case(dev, E, lmax, C, H, F2, alpha_ch, 113 + E)
    bwd_args = _so2_bwd_args(args, cts)
    want = k6.so2_attn_plain(*args)
    want_g = k6.so2_attn_bwd_plain(*bwd_args)
    assert [w.dtype for w in want] == [torch.bfloat16] * 4
    assert [w.dtype for w in want_g] == [torch.bfloat16] * 2 + [torch.float32] * 8
    n = (k6.launches, k6.launches_bwd, k6.launches_bf16, k6.launches_bwd_bf16)
    if E == 0:  # no launch: empty outputs, zero weight and bias gradients
        got = k6.so2_attn_cuda(*args)
        grads = k6.so2_attn_bwd_cuda(*bwd_args)
        assert [(g.shape, g.dtype) for g in (*got, *grads)] == [
            (w.shape, w.dtype) for w in (*want, *want_g)]
        assert all(not bool(g.any()) for g in grads[2:])
        assert (k6.launches, k6.launches_bwd, k6.launches_bf16, k6.launches_bwd_bf16) == n
        return
    got, names, calls = _kernels_run(functools.partial(k6.so2_attn_cuda, *args))
    _check_bf16(got, want, ["z0", "z1", "z2", "extra"])
    del want
    grads, bnames, bcalls = _kernels_run(functools.partial(k6.so2_attn_bwd_cuda, *bwd_args))
    _check_bf16(grads, want_g, SO2_GRAD_NAMES)
    assert (k6.launches, k6.launches_bwd, k6.launches_bf16, k6.launches_bwd_bf16) == (
        n[0], n[1], n[2] + calls, n[3] + bcalls)
    _check_names(names, SO2_BF16_FWD, SO2_F32_KERNELS)
    _check_names(bnames, SO2_BF16_BWD, SO2_F32_KERNELS)


# K6·bf16's and K6b·bf16's stage-2 call (a training microbatch's 7,936
# edges at the default Config's widths), lmax 2 (I 9: one k step, one m16
# tile), and a hidden width whose 32-column tiles cross edges (the grid
# stages' 4-byte copies)
SO2_BF16_STAGES = [(7936, 6, 32, 128, 112, 224), (45, 2, 16, 64, 20, 8),
                   (29, 4, 8, 48, 16, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,lmax,C,H,F2,alpha_ch", SO2_BF16_STAGES)
def test_so2_attn_bf16_grid_stages_on_tensor_cores(dev, E, lmax, C, H, F2, alpha_ch):
    """K6·bf16 and K6b·bf16 with their grid stages on the tensor cores
    (``grid_fwd_tc_kernel``, ``grid_bwd_tc_kernel``) against their bfloat16
    twins, ``BF16_TOL`` of each output's largest; no CUDA-core grid kernel
    runs; the stages resident at these widths."""
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    args, cts = _so2_bf16_case(dev, E, lmax, C, H, F2, alpha_ch, 157 + E)
    bwd_args = _so2_bwd_args(args, cts)
    G = args[8].shape[0]
    got, names, _ = _kernels_run(functools.partial(k6.so2_attn_cuda, *args))
    _check_bf16(got, k6.so2_attn_plain(*args), ["z0", "z1", "z2", "extra"])
    grads, bnames, _ = _kernels_run(functools.partial(k6.so2_attn_bwd_cuda, *bwd_args))
    _check_bf16(grads, k6.so2_attn_bwd_plain(*bwd_args), SO2_GRAD_NAMES)
    _check_names(names, SO2_BF16_FWD, SO2_F32_KERNELS)
    _check_names(bnames, SO2_BF16_BWD, SO2_F32_KERNELS)
    for bwd in (False, True):
        res = k6.grid_residency(lmax, 2, C, H, F2, alpha_ch, G, bwd=bwd)
        assert res["blocks_per_sm"] >= 1 and res["threads"] >= 32, res


@pytest.mark.cuda
def test_so2_attn_bf16_takes_misaligned_inputs(dev):
    """K6·bf16 and K6b·bf16 given every tensor input as a contiguous view at
    a one-element offset run through the wrappers' aligned copies, on their
    bfloat16 stages, and match their twins."""
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    args, cts = _so2_bf16_case(dev, 300, 6, 32, 128, 112, 224, 163)
    bwd_args = _so2_bwd_args(args, cts)
    mis = lambda a: [_misaligned(t) for t in a] if isinstance(a, list) else _misaligned(a)
    got, names, _ = _kernels_run(functools.partial(k6.so2_attn_cuda, *[mis(a) for a in args]))
    _check_bf16(got, k6.so2_attn_plain(*args), ["z0", "z1", "z2", "extra"])
    grads, bnames, _ = _kernels_run(
        functools.partial(k6.so2_attn_bwd_cuda, *[mis(a) for a in bwd_args]))
    _check_bf16(grads, k6.so2_attn_bwd_plain(*bwd_args), SO2_GRAD_NAMES)
    _check_names(names, SO2_BF16_FWD, SO2_F32_KERNELS)
    _check_names(bnames, SO2_BF16_BWD, SO2_F32_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("orient,M,K,N,splits,ragged", SO2_GEMM_CASES)
def test_so2_gemm_bf16_matches_float64(dev, orient, M, K, N, splits, ragged):
    """The chain's GEMM on bfloat16 operands (K6·bf16's and K6b·bf16's: one
    TF32 mma.sync a product, exact for two bfloat16 values), the cases of
    ``test_so2_gemm_matches_float64``: ragged ones 2 bytes past a 16-byte
    boundary with row strides 3 elements wider (element-wise copies). A
    float32 output within 2e-6 of the largest output of the float64 product
    of the same bfloat16 values; a bfloat16 output (NN and NT, conv 2's)
    within half a bfloat16 step of each element (2^-8 of it at most) plus
    that."""
    import ctypes

    from singa_tpu_torch.ops.cuda import build

    rng = np.random.default_rng(127 + M + K + N)
    pad, off = (3, 1) if ragged else (0, 0)
    a_shape = (K, M) if orient == "tn" else (M, K)
    b_shape = (N, K) if orient == "nt" else (K, N)
    a, b = (torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
            for s in (a_shape, b_shape))
    bias = rng.normal(size=N).astype(np.float32) if orient == "nn" else None

    def stored(x):  # x at row stride width + pad, `off` elements into its buffer
        buf = torch.zeros(off + x.shape[0] * (x.shape[1] + pad), dtype=torch.bfloat16)
        buf[off:].view(x.shape[0], -1)[:, : x.shape[1]] = x
        return buf.to(dev)

    ta, tb = stored(a), stored(b)
    fn = build.load("so2_attn").so2_gemm_bf16
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                                               ctypes.c_void_p])
    fn.restype = ctypes.c_int
    a64, b64 = (x.to(dev, torch.float64) for x in (a, b))
    want = (a64.T if orient == "tn" else a64) @ (b64.T if orient == "nt" else b64)
    if bias is not None:
        want += torch.as_tensor(bias).to(dev, torch.float64)
    tbias = _t(bias, dev) if bias is not None else None
    for out_bf16 in ((False, True) if orient != "tn" else (False,)):
        dt = torch.bfloat16 if out_bf16 else torch.float32
        ldc = N + 1 if ragged and orient != "tn" else N
        out = torch.full((M * ldc,), float("nan"), dtype=dt, device=dev)
        partial = torch.empty(splits * M * N if splits > 1 else 1, dtype=torch.float32,
                              device=dev)
        build.check(fn(ta.data_ptr() + 2 * off, a_shape[1] + pad, tb.data_ptr() + 2 * off,
                       b_shape[1] + pad, out.data_ptr(), ldc, M, N, K,
                       tbias.data_ptr() if tbias is not None else None,
                       {"nn": 0, "nt": 1, "tn": 2}[orient], splits, partial.data_ptr(),
                       int(out_bf16), build.stream_ptr(out)), "so2_gemm_bf16")
        torch.cuda.synchronize()
        got = out.view(M, ldc)[:, :N].double()
        top = want.abs().max()
        if out_bf16:
            err = ((got - want).abs() - 2.0 ** -8 * want.abs()).max() / top
        else:
            err = (got - want).abs().max() / top
        assert err.item() <= 2e-6, (out_bf16, err.item())


@pytest.mark.cuda
def test_so2_gemm_bf16_residency(dev):
    """The bfloat16 GEMM's kernels are resident in each orientation, with
    about half the float32 kernels' shared memory a block (NN's [k][n] rows
    4 elements wider)."""
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    f32, b16 = k6.gemm_residency(), k6.gemm_residency(bf16=True)
    for orient in ("nn", "nt", "tn"):
        assert b16[orient]["blocks_per_sm"] >= 1, b16
        assert b16[orient]["threads"] == f32[orient]["threads"]
        assert b16[orient]["smem_bytes"] <= 0.51 * f32[orient]["smem_bytes"], (b16, f32)


@pytest.mark.cuda
def test_autograd_reaches_conv_parameters_through_k6(dev):
    """SO2Conv.section_weights and radial feeding so2_attn, loss.backward()
    on CUDA tensors: x, the edge features and every parameter of both
    convolutions (radial MLP included) get the gradient the CPU (plain
    versions) gives them."""
    from singa_tpu_torch.equivariant.layers import SO2Conv, _grid_mats_for
    from singa_tpu_torch.ops.cuda import so2_attn as k6
    from singa_tpu_torch.params import seeded_init

    lmax, C, H, F2, alpha_ch, De, E = 6, 16, 128, 24, 12, 8, 70
    rng = np.random.default_rng(103)
    x = rng.normal(size=(E, (lmax + 1) ** 2, C)).astype(np.float32)
    x_edge = rng.normal(size=(E, De)).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, E).astype(np.float32)
    beta = rng.uniform(0, np.pi, E).astype(np.float32)
    grads = {}
    for d in ("cpu", dev):
        conv1 = SO2Conv(C, H, lmax, 2, edge_channels=(De, 16), extra_m0_features=alpha_ch + H,
                        device="cpu")
        conv2 = SO2Conv(H, F2, lmax, 2, device="cpu")
        mods = torch.nn.ModuleList([conv1, conv2])
        seeded_init(mods, 5)
        mods.to(d)
        xt, et = _t(x, d).requires_grad_(), _t(x_edge, d).requires_grad_()
        w1s, b1 = conv1.section_weights()
        w2s, b2 = conv2.section_weights()
        tg, fg = (_t(m, d) for m in _grid_mats_for(lmax, 2, True))
        n = k6.launches_bwd
        outs = k6.so2_attn(xt, conv1.radial(et).contiguous(), _t(phi, d), _t(beta, d), w1s, b1,
                           w2s, b2, tg, fg, lmax, 2, H, F2, alpha_ch)
        loss = sum((o * _t(np.random.default_rng(7 + i).normal(size=o.shape).astype(np.float32), d)).sum()
                   for i, o in enumerate(outs))
        loss.backward()
        assert k6.launches_bwd == n + (1 if str(d) == "cuda" else 0)
        grads[str(d)] = {"x": xt.grad, "x_edge": et.grad,
                         **{name: p.grad for name, p in mods.named_parameters()}}
    assert set(grads["cpu"]) == set(grads["cuda"])
    for name, b in grads["cpu"].items():
        a = grads["cuda"][name]
        assert a is not None, name
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a.cpu(), b, atol=1e-4 * scale, rtol=1e-4, msg=name)


def _hub_graph(dev, B, N, knn, ring, seed, pad=None):
    """The encoder attention's inputs on the card (H 4, kd 32, vd 64, De 64)
    from build_neighbor_graph(with_adj_dist=True) on points where node 0 of
    graph 0 is a hub: ``ring`` points on a sphere around it each count it
    among their ``knn`` nearest, so its in-degree exceeds K = 2 knn (an
    overflow row, cut to K in the lists, whole in adj_dist). The last graph
    has ``pad`` padded nodes (self score -1e9, as the model sets it; by
    default 5 where N > 8). Returns (K7's arguments, K8's arguments, the
    cotangent, nbr)."""
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph
    from singa_tpu_torch.ops.cuda.neighbor_attn import gather_rows

    H, kd, vd, De = 4, 32, 64, 64
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    pos = rng.uniform(-12, 12, size=(B, N, 3)) + 30.0
    n = min(ring, N - 1)
    if n > 0:
        i = np.arange(n) + 0.5
        polar, azim = np.arccos(1 - 2 * i / n), np.pi * (1 + 5 ** 0.5) * i
        pos[0, 0] = 0.0
        pos[0, 1:n + 1] = 2.0 * np.stack([np.sin(polar) * np.cos(azim), np.sin(polar) * np.sin(azim),
                                          np.cos(polar)], -1)
    mask = np.ones((B, N), bool)
    pad = (5 if N > 8 else 0) if pad is None else pad
    if pad:
        mask[-1, -pad:] = False
    g = build_neighbor_graph(_t(pos.astype(np.float32), dev), _t(mask, dev), knn, 15.0, De,
                             with_adj_dist=True)
    ds = np.where(mask[..., None], f(B, N, H), np.float32(-1e9)).astype(np.float32)
    q, k, v, ds, dval = (_t(a, dev) for a in (f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd),
                                               ds, f(B, N, H * vd)))
    w = [_t(np.linspace(0.0, 15.0, De, dtype=np.float32), dev)] + [
        _t(a, dev) for a in (0.3 * f(De, kd), 0.1 * f(kd), 0.3 * f(kd, kd), 0.1 * f(kd),
                             0.3 * f(De, vd), 0.1 * f(vd), 0.3 * f(vd, vd), 0.1 * f(vd))]
    coeff = -0.5 / (15.0 / (De - 1)) ** 2
    k7 = [q, gather_rows(k, g.nbr), gather_rows(v, g.nbr), g.nbr_mask, g.dist, ds, dval, *w, coeff]
    k8 = [q, k, v, g.adj_dist, ds, dval, *w, coeff]
    if n >= 2 * knn:
        assert int(((g.adj_dist < 5e8).sum(-1) > g.nbr.shape[2]).sum()) > 0  # an overflow row
    return k7, k8, _t(f(B, N, H * vd), dev), g.nbr


# (B, N, knn, ring): overflow rows at K 12 and at the main path's K 96 (N
# 384, a multiple of K8's 96-column tile); N 100 is not a multiple; N 1
ENCODER_FORM_CASES = [(2, 100, 6, 20), (1, 384, 48, 110), (2, 1, 1, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,knn,ring,pad", [(*c, None) for c in ENCODER_FORM_CASES]
                         + [(4, 384, 48, 110, 150), (16, 384, 48, 110, 150),
                            (2, 64, 0, 0, "redo"), (4, 384, 0, 0, "copies")])
def test_neighbor_attn_hybrid_kernels_match_plain(dev, B, N, knn, ring, pad):
    """K7 and K7b against their plain versions: the lists of a graph with
    an overflow row and padded nodes, a random cotangent; K7b's dk/dv over
    the CSR transpose of nbr against the plain scatter. With ``pad``: the
    main path's shapes, ``pad`` padded nodes in every graph (dead-weighted
    in K7) and a zero cotangent on them but on one (16 graphs: many rows
    per block); "redo": random lists at K 24 with a live row whose score
    sits far below -1e9 (both kernels take it again whole); "copies": the
    main path's shapes with each graph's padded rows on one row's gathered
    rows and distances (K7 takes all but the first as copies). N 1 is among
    the graph cases."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7

    if pad in ("redo", "copies"):
        bwd_args = _as_hybrid(_list_bwd_case(dev, "redo") if pad == "redo" else _copies_case(dev))
        nbr = bwd_args[3]
        args = [*bwd_args[:3], *bwd_args[4:-1]]
    elif pad is None:
        args, _, g, nbr = _hub_graph(dev, B, N, knn, ring, 107 + N)
        bwd_args = [*args[:3], nbr, *args[3:], g]
    else:
        _, bwd_args, nbr = _graph_list_case(dev, B, N, knn, ring, 163 + B, pad)
        args = [*bwd_args[:3], *bwd_args[4:-1]]
    n, nb = k7.launches_hybrid, k7.launches_hybrid_bwd
    got = k7.neighbor_attn_hybrid_cuda(*args)
    offsets, slots = k7.transpose_slots(nbr)
    grads = k7.neighbor_attn_hybrid_bwd_cuda(*bwd_args, offsets=offsets, slots=slots)
    assert (k7.launches_hybrid, k7.launches_hybrid_bwd) == (n + 1, nb + 1)
    _check(got, k7.neighbor_attn_hybrid_plain(*args))
    _check_grads(grads, k7.neighbor_attn_hybrid_bwd_plain(*bwd_args), BWD_NAMES)


# K8's further cases (B, N, knn, ring, padded nodes of the last graph): one
# real node left (an isolated real row: live self, no live column); a graph
# whose rows are all padded
DENSE_CASES = [(*c, None) for c in ENCODER_FORM_CASES] + [(2, 12, 3, 0, 11), (3, 12, 3, 0, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,knn,ring,pad", DENSE_CASES)
def test_dense_edge_attn_kernels_match_plain(dev, B, N, knn, ring, pad):
    """K8 and K8b, over the live lists, against their plain versions (every
    column evaluated) on adj_dist of a graph with an overflow row (all its
    columns live, beyond K; at N 384 its live count exceeds a tile of K8 and
    of K8b), padded rows (a uniform softmax over all N + 1 slots, in closed
    form) and isolated or all-padded graphs, under a random cotangent. The
    public entry builds the lists itself; exactly one launch each."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    _, args, g, _ = _hub_graph(dev, B, N, knn, ring, 109 + N, pad)
    lists = k8.live_columns(args[3])
    if N == 384:
        counts = lists.row_offsets[1:] - lists.row_offsets[:-1]
        tiles = [r["tile"] for r in k8.residency(N, 4, 32, 64, 64).values()]
        assert int(counts.max()) > max(tiles)
    n, nb = k8.launches, k8.launches_bwd
    got = k8.dense_edge_attn(*args)
    grads = k8.dense_edge_attn_bwd_cuda(*args, g, lists=lists)
    assert (k8.launches, k8.launches_bwd) == (n + 1, nb + 1)
    _check(got, k8.dense_edge_attn_plain(*args))
    _check_grads(grads, k8.dense_edge_attn_bwd_plain(*args, g), BWD_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,key_channels", [(8, 128), (4, 64)])
def test_neighbor_graph_mha_trains_at_other_widths(dev, heads, key_channels):
    """NeighborGraphMHA at hidden 256 and edge 64 with num_heads 8 (kd 16,
    vd 32) or key_channels 64 (kd 16), widths the tensor-core pair kernel
    does not take: K1 and K1b (its CUDA-core instance) on the card give the
    CPU's output, input gradient and every parameter gradient (plain
    versions), each within 1e-4 of its largest magnitude."""
    from singa_tpu_torch.models.neighbor_graph import NeighborGraphMHA, build_neighbor_graph
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.params import seeded_init

    rng = np.random.default_rng(181)
    B, N, C = 2, 60, 256
    pos = (4.0 * rng.normal(size=(B, N, 3))).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 45:] = False
    x, w = (rng.normal(size=(B, N, C)).astype(np.float32) for _ in range(2))
    runs = {}
    for d in ("cpu", "cuda"):
        m = NeighborGraphMHA(C, key_channels, heads, 64, 15.0, device=d)
        seeded_init(m, 3)
        g = build_neighbor_graph(_t(pos, d), _t(mask, d), 16, 15.0, 64)
        xi = _t(x, d).requires_grad_()
        n = k1.launches_bwd
        out = m(xi, g)
        (out * _t(w, d)).sum().backward()
        runs[d] = [out.detach(), xi.grad, *(p.grad for p in m.parameters())]
        names = ["out", "x", *(name for name, _ in m.named_parameters())]
    assert k1.launches_bwd == n + 1
    for name, a, b in zip(names, runs["cuda"], runs["cpu"]):
        scale = b.abs().max().item()
        torch.testing.assert_close(a.cpu(), b, atol=1e-4 * scale, rtol=1e-4, msg=name)


@pytest.mark.cuda
def test_encoder_attn_forms_refuse_shapes_they_do_not_take(dev):
    """K7 with one node's pair tensors over shared memory and K8 with
    EdgeMLP weights over it: the C entry points return
    cudaErrorInvalidValue and the wrappers raise ValueError; K7b and K8b at
    widths whose weight gradients exceed the sums their blocks keep are
    refused before launch."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7

    rng = np.random.default_rng(113)
    f = lambda *s: _t(rng.normal(size=s).astype(np.float32), dev)

    def attn(H, kd, vd, De, K):
        return [f(1, 2, H * kd), f(1, 2, K, H * kd), f(1, 2, K, H * vd),
                _t(np.zeros((1, 2, K), np.int32), dev), _t(np.ones((1, 2, K), bool), dev),
                f(1, 2, K), f(1, 2, H), f(1, 2, H * vd), f(De), f(De, kd), f(kd), f(kd, kd), f(kd),
                f(De, vd), f(vd), f(vd, vd), f(vd)]

    big_k = attn(2, 32, 64, 64, 2000)
    k7_args = [*big_k[:3], *big_k[4:], -0.2]
    wide = attn(2, 128, 128, 128, 4)  # weight gradients 2 x 128 x 128 x 2 + ... > 12,288
    wide_bwd = [*wide[:3], wide[3], *wide[4:], -0.2, f(1, 2, 2 * 128)]
    dense = lambda a: [a[0], a[0].clone(), a[7].clone(), f(1, 2, 2), *a[6:], -0.2]
    with pytest.raises(ValueError, match="does not take these shapes"):
        k7.neighbor_attn_hybrid_cuda(*k7_args)
    wide_v = dense(attn(2, 32, 256, 256, 4))
    with pytest.raises(ValueError, match="does not take these shapes"):
        k8.dense_edge_attn_cuda(*wide_v, lists=k8.live_columns(wide_v[3]))
    off, sl = k7.transpose_slots(wide[3])
    with pytest.raises(ValueError, match="not supported"):
        k7.neighbor_attn_hybrid_bwd_cuda(*wide_bwd, offsets=off, slots=sl)
    with pytest.raises(ValueError, match="not supported"):
        k8.dense_edge_attn_bwd_cuda(*dense(wide), f(1, 2, 2 * 128),
                                    lists=k8.live_columns(dense(wide)[3]))


def _misaligned(a):
    """A copy of tensor ``a`` as a contiguous view at an offset of one
    element (4 bytes for float32 and int32) into a larger buffer: not on a
    16-byte boundary. Anything else as it is."""
    if not torch.is_tensor(a):
        return a
    out = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:].view(a.shape).copy_(a)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k1", "k7", "k8", "k2", "k4", "k3", "k5"])
def test_kernels_take_misaligned_inputs(dev, form):
    """Each forward kernel and its backward (K1/K1b, K7/K7b, K8/K8b, K2/K2b,
    K4/K4b, K3/K3b, K5/K5b) given every tensor input as a contiguous view at a 4-byte offset
    (which the kernels' 16-byte loads would fault on, and which the JAX
    package takes) runs on the card, through the wrapper's aligned copy,
    and matches its plain version on the aligned inputs."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import s2_act as k3
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    mis = lambda args: [_misaligned(a) for a in args]
    if form in ("k1", "k7"):
        bwd_args = _list_bwd_case(dev, "random_k24")
        if form == "k7":
            bwd_args = _as_hybrid(bwd_args)
        nbr = bwd_args[3]
        offsets, slots = k1.transpose_slots(nbr)
        kw = {"offsets": _misaligned(offsets), "slots": _misaligned(slots)}
        if form == "k1":
            args = bwd_args[:-1]
            got = k1.neighbor_attn_cuda(*mis(args))
            grads = k1.neighbor_attn_bwd_cuda(*mis(bwd_args), **kw)
            want, want_g = k1.neighbor_attn_plain(*args), k1.neighbor_attn_bwd_plain(*bwd_args)
        else:
            args = [*bwd_args[:3], *bwd_args[4:-1]]
            got = k1.neighbor_attn_hybrid_cuda(*mis(args))
            grads = k1.neighbor_attn_hybrid_bwd_cuda(*mis(bwd_args), **kw)
            want = k1.neighbor_attn_hybrid_plain(*args)
            want_g = k1.neighbor_attn_hybrid_bwd_plain(*bwd_args)
        names = BWD_NAMES
    elif form == "k8":
        _, args, g, _ = _hub_graph(dev, 2, 100, 6, 20, 209)
        lists = k8.DenseLists(*mis(k8.live_columns(args[3])))
        got = k8.dense_edge_attn_cuda(*mis(args), lists=lists)
        grads = k8.dense_edge_attn_bwd_cuda(*mis(args), _misaligned(g), lists=lists)
        want, want_g = k8.dense_edge_attn_plain(*args), k8.dense_edge_attn_bwd_plain(*args, g)
        names = BWD_NAMES
    elif form == "k2":
        args = _gate_ffn_case(dev, 6, 37, 512, 16, 16, 87)
        dy = _t(np.random.default_rng(88).normal(size=(37, 49, 16)).astype(np.float32), dev)
        bwd_args = [*args[:6], 6, dy]
        got = k2.so3_gate_ffn_cuda(*mis(args), 6)
        grads = k2.so3_gate_ffn_bwd_cuda(*mis(bwd_args))
        want, want_g = k2.so3_gate_ffn_plain(*args, 6), k2.so3_gate_ffn_bwd_plain(*bwd_args)
        names = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]
    elif form == "k3":
        bwd_args = _sep_case(dev, 37, 128, 6, 95, cotangent=True)
        args = bwd_args[:4]
        got = k3.s2_silu_sep_cuda(*mis(args))
        grads = k3.s2_silu_sep_bwd_cuda(*mis(bwd_args))
        want, want_g = k3.s2_silu_sep_plain(*args), k3.s2_silu_sep_bwd_plain(*bwd_args)
        names = ["dx", "ds"]
    elif form == "k5":
        bwd_args = _silu_case(dev, 6, 6, False, 37, 16, 96)
        args = bwd_args[:3]
        got = k3.s2_silu_cuda(*mis(args))
        grads = [k3.s2_silu_bwd_cuda(*mis(bwd_args))]
        want, want_g = k3.s2_silu_plain(*args), [k3.s2_silu_bwd_plain(*bwd_args)]
        names = ["dx"]
    else:
        args, dy = _s2_ffn_case(dev, 6, 37, 512, 16, 16, 89)
        bwd_args = [*args[:6], *args[7:], 6, dy]
        got = k2.so3_ffn_cuda(*mis(args), 6)
        grads = k2.so3_ffn_bwd_cuda(*mis(bwd_args))
        want, want_g = k2.so3_ffn_plain(*args, 6), k2.so3_ffn_bwd_plain(*bwd_args)
        names = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]
    _check(got, want)
    _check_grads(grads, want_g, names)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,knn,ring,pad", [(*c, None) for c in ENCODER_FORM_CASES]
                         + [(4, 384, 48, 110, 150), (2, 64, 0, 0, "redo"),
                            (4, 384, 0, 0, "copies")])
def test_neighbor_attn_hybrid_bf16_instance_matches_its_twin(dev, B, N, knn, ring, pad):
    """K7's and K7b's bfloat16 instances (qt, k_nb, v_nb, diag_value and the
    cotangent bfloat16) against their bfloat16 twins on the hybrid cases
    (an overflow row and padded nodes; the main path's shapes with padded
    rows and zero cotangents on them; a live row taken again whole; the
    padded rows as copies): the tensor-core kernels at bfloat16 at the
    encoder's widths, the CUDA-core ones under ``cuda_cores=True``; counted
    in ``launches_hybrid_bf16`` / ``launches_bwd_hybrid_bf16``, the float32
    counters untouched."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7

    if pad in ("redo", "copies"):
        bwd_args = _as_hybrid(_list_bwd_case(dev, "redo") if pad == "redo" else _copies_case(dev))
        nbr = bwd_args[3]
    elif pad is None:
        args, _, g, nbr = _hub_graph(dev, B, N, knn, ring, 107 + N)
        bwd_args = [*args[:3], nbr, *args[3:], g]
    else:
        _, bwd_args, nbr = _graph_list_case(dev, B, N, knn, ring, 163 + B, pad)
    bwd_args = _bf16(bwd_args, (0, 1, 2, 7, 18))
    args = [*bwd_args[:3], *bwd_args[4:-1]]
    offsets, slots = k7.transpose_slots(nbr)
    want, want_g = k7.neighbor_attn_hybrid_plain(*args), k7.neighbor_attn_hybrid_bwd_plain(*bwd_args)
    assert want.dtype == want_g[0].dtype == torch.bfloat16
    for cuda_cores in (False, True):
        f32 = (k7.launches, k7.launches_bwd, k7.launches_hybrid, k7.launches_hybrid_bwd)
        n = (k7.launches_hybrid_bf16, k7.launches_bwd_hybrid_bf16)
        got, names, calls = _kernels_run(
            functools.partial(k7.neighbor_attn_hybrid_cuda, *args, cuda_cores=cuda_cores))
        grads, names_b, calls_b = _kernels_run(functools.partial(
            k7.neighbor_attn_hybrid_bwd_cuda, *bwd_args, offsets=offsets, slots=slots,
            cuda_cores=cuda_cores))
        _check_bf16([got], [want], ["out"])
        _check_bf16(grads, want_g, BWD_NAMES)
        assert (k7.launches_hybrid_bf16, k7.launches_bwd_hybrid_bf16) == (n[0] + calls,
                                                                           n[1] + calls_b)
        assert (k7.launches, k7.launches_bwd, k7.launches_hybrid, k7.launches_hybrid_bwd) == f32
        fwd_k = [m for m in names if "list_fwd_tile_kernel" in m or "attn_fwd_kernel" in m]
        bwd_k = [m for m in names_b if "list_bwd_pair_kernel" in m or "list_bwd_cc_kernel" in m]
        assert len(fwd_k) == len(bwd_k) == 1, (names, names_b)
        assert "bfloat16" in fwd_k[0] and "bfloat16" in bwd_k[0], (fwd_k, bwd_k)
        assert ("attn_fwd_kernel" in fwd_k[0]) == cuda_cores, fwd_k
        assert ("list_bwd_cc_kernel" in bwd_k[0]) == cuda_cores, bwd_k


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,knn,ring,pad", DENSE_CASES)
def test_dense_edge_attn_bf16_instance_matches_its_twin(dev, B, N, knn, ring, pad):
    """K8's and K8b's bfloat16 instances (qt, k, v, diag_value and the
    cotangent bfloat16) against ``dense_edge_attn_bf16_plain`` and its
    backward on K8's cases (an overflow row over a tile, padded rows in
    closed form, an isolated real row, an all-padded graph): their kernels
    at bfloat16 storage, counted in ``launches_bf16`` / ``launches_bwd_bf16``,
    the float32 counters untouched; K8b·bf16 on the kernels
    ``bwd_bf16_instance`` picks by shape (the list kernels' dense form on
    the tensor cores where every row fits a tile, else the CUDA-core
    ones), and on its CUDA-core kernels under ``cuda_cores=True``; their
    residency that of the float32 kernels (the same shared memory: every
    buffer float32)."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    _, args, g, _ = _hub_graph(dev, B, N, knn, ring, 109 + N, pad)
    args = _bf16(args, (0, 1, 2, 5))
    g = g.to(torch.bfloat16)
    lists = k8.live_columns(args[3])
    want, want_g = k8.dense_edge_attn_plain(*args), k8.dense_edge_attn_bwd_plain(*args, g)
    assert want.dtype == want_g[0].dtype == torch.bfloat16
    f32 = (k8.launches, k8.launches_bwd)
    n = (k8.launches_bf16, k8.launches_bwd_bf16)
    got, names, calls = _kernels_run(functools.partial(k8.dense_edge_attn_cuda, *args,
                                                       lists=lists))
    _check_bf16([got], [want], ["out"])
    hits = [m for m in names if "attn_fwd_kernel" in m]
    assert len(hits) == 1 and "bfloat16" in hits[0], names
    tc_kernels = ("list_bwd_pair_kernel<2", "list_dkdv_kernel<2", "dense_plan_kernel")
    cc_kernels = ("attn_bwd_pair_kernel<2", "csr_dkdv_kernel<2")
    for cuda_cores in (False, True):
        inst = k8.bwd_bf16_instance(lists.max_live, 4, 32, 64, 64, cuda_cores=cuda_cores)
        assert inst == ("cuda_cores" if cuda_cores or lists.max_live > 128 else "tensor_cores")
        nb = k8.launches_bwd_bf16
        grads, names_b, calls_b = _kernels_run(functools.partial(
            k8.dense_edge_attn_bwd_cuda, *args, g, lists=lists, cuda_cores=cuda_cores))
        _check_bf16(grads, want_g, BWD_NAMES)
        assert k8.launches_bwd_bf16 == nb + calls_b
        ran, not_ran = ((tc_kernels, cc_kernels) if inst == "tensor_cores"
                        else (cc_kernels, tc_kernels))
        for kernel in ran:
            hits = [m for m in names_b if kernel in m]
            assert len(hits) == 1 and "bfloat16" in hits[0], (kernel, names_b)
        assert not [m for m in names_b if any(k in m for k in not_ran)], (inst, names_b)
    assert k8.launches_bf16 == n[0] + calls
    assert (k8.launches, k8.launches_bwd) == f32
    res, res16 = k8.residency(N, 4, 32, 64, 64), k8.residency(N, 4, 32, 64, 64, bf16=True)
    for key in ("fwd", "bwd"):
        assert res16[key]["smem_bytes"] == res[key]["smem_bytes"] and res16[key]["tile"] == res[
            key]["tile"] and res16[key]["blocks_per_sm"] >= 1, (res, res16)


# K8b·bf16's tensor-core cases (B, N, knn, ring, padded nodes of the last
# graph): padded rows, half of them with a zero cotangent (skipped) and half
# with a random one (closed form); an isolated real row (one real node
# left: closed form); an all-padded graph; a ring whose rows carry many live
# columns. Every case also has a real row with live columns and a zero
# cotangent (skipped, its live pairs sending nothing).
DENSE_TC_CASES = [(2, 40, 4, 0, 8), (2, 12, 3, 0, 11), (3, 12, 3, 0, 12), (2, 100, 6, 20, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,knn,ring,pad", DENSE_TC_CASES)
def test_dense_edge_attn_bwd_bf16_tensor_cores_walks(dev, B, N, knn, ring, pad):
    """K8b·bf16 on its tensor-core kernels (``list_bwd_pair_kernel`` and
    ``list_dkdv_kernel`` in their dense form, ``dense_plan_kernel``)
    against its bfloat16 twin within ``BF16_TOL``, and what the pair
    kernel walked, as it counts it (``stats``): the rows skipped for a zero
    cotangent, the rows taken with their live columns and their live pairs,
    the rows taken in closed form (no live column, a cotangent), and no
    (row, head) whose max would leave a dead column a weight."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    _, args, g, _ = _hub_graph(dev, B, N, knn, ring, 211 + N + pad, pad)
    args = _bf16(args, (0, 1, 2, 5))
    g = g.to(torch.bfloat16)
    g[-1, N - pad::2] = 0  # every other padded row: skipped
    g[0, 1] = 0  # a real row with live columns: skipped
    lists = k8.live_columns(args[3])
    counts = (lists.row_offsets[1:] - lists.row_offsets[:-1]).cpu()
    assert int(counts[1]) > 0 and lists.max_live <= 128
    assert k8.bwd_bf16_instance(lists.max_live, 4, 32, 64, 64) == "tensor_cores"
    want_g = k8.dense_edge_attn_bwd_plain(*args, g)
    stats = torch.zeros(5, dtype=torch.int32, device=dev)
    grads, names, _ = _kernels_run(functools.partial(
        _with_stats, k8.dense_edge_attn_bwd_cuda, stats, *args, g, lists=lists))
    _check_bf16(grads, want_g, BWD_NAMES)
    for kernel in ("list_bwd_pair_kernel<2", "list_dkdv_kernel<2", "dense_plan_kernel"):
        assert len([m for m in names if kernel in m]) == 1, (kernel, names)
    zero = (g.reshape(B * N, -1) == 0).all(-1).cpu()
    live = ~zero & (counts > 0)
    want = [int(zero.sum()), int(live.sum()), 0, int(counts[live].sum()),
            int((~zero & (counts == 0)).sum())]
    assert stats.tolist() == want, (stats.tolist(), want)
    assert want[0] >= 2 and want[4] >= 1, want


@pytest.mark.cuda
def test_dense_edge_attn_bwd_bf16_hub_row_runs_cuda_cores(dev):
    """A graph with a hub row live to more than 128 columns (over the
    tensor-core kernels' one tile a row): K8b·bf16 runs its CUDA-core
    kernels (``encoder_attn.cuh``'s dense pair kernel and dk/dv gather at
    bfloat16), chosen by shape before the launch, and matches its twin
    within ``BF16_TOL``; the same rows without the hub take the tensor
    cores."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    _, args, g, _ = _hub_graph(dev, 2, 200, 48, 150, 307)
    args = _bf16(args, (0, 1, 2, 5))
    g = g.to(torch.bfloat16)
    lists = k8.live_columns(args[3])
    assert lists.max_live > 128
    assert k8.bwd_bf16_instance(lists.max_live, 4, 32, 64, 64) == "cuda_cores"
    grads, names, _ = _kernels_run(functools.partial(k8.dense_edge_attn_bwd_cuda, *args, g,
                                                     lists=lists))
    _check_bf16(grads, k8.dense_edge_attn_bwd_plain(*args, g), BWD_NAMES)
    hits = [m for m in names if "attn_bwd_pair_kernel<2" in m]
    assert len(hits) == 1 and "bfloat16" in hits[0], names
    assert not [m for m in names if "list_bwd_pair_kernel" in m], names
    # the hub cut off: its row and column dead
    adj = args[3].clone()
    adj[0, 0, :] = adj[0, :, 0] = k8.BIG
    cut = [*args[:3], adj, *args[4:]]
    lists = k8.live_columns(adj)
    assert lists.max_live <= 128
    grads, names, _ = _kernels_run(functools.partial(k8.dense_edge_attn_bwd_cuda, *cut, g,
                                                     lists=lists))
    _check_bf16(grads, k8.dense_edge_attn_bwd_plain(*cut, g), BWD_NAMES)
    assert len([m for m in names if "list_bwd_pair_kernel<2" in m]) == 1, names


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k7", "k8"])
def test_bf16_forms_take_misaligned_inputs(dev, form):
    """K7's, K7b's, K8's and K8b's bfloat16 instances given every tensor
    input as a contiguous view at a 2-byte offset run through the wrappers'
    aligned copies and match their twins on the aligned inputs."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7

    mis = lambda args: [_misaligned(a) for a in args]
    if form == "k7":
        bwd_args = _bf16(_as_hybrid(_list_bwd_case(dev, "random_k24")), (0, 1, 2, 7, 18))
        offsets, slots = k7.transpose_slots(bwd_args[3])
        args = [*bwd_args[:3], *bwd_args[4:-1]]
        got = k7.neighbor_attn_hybrid_cuda(*mis(args))
        grads = k7.neighbor_attn_hybrid_bwd_cuda(*mis(bwd_args), offsets=_misaligned(offsets),
                                                 slots=_misaligned(slots))
        want, want_g = k7.neighbor_attn_hybrid_plain(*args), k7.neighbor_attn_hybrid_bwd_plain(
            *bwd_args)
    else:
        _, args, g, _ = _hub_graph(dev, 2, 100, 6, 20, 209)
        args, g = _bf16(args, (0, 1, 2, 5)), g.to(torch.bfloat16)
        lists = k8.DenseLists(*mis(k8.live_columns(args[3])))
        got = k8.dense_edge_attn_cuda(*mis(args), lists=lists)
        grads = k8.dense_edge_attn_bwd_cuda(*mis(args), _misaligned(g), lists=lists)
        want, want_g = k8.dense_edge_attn_plain(*args), k8.dense_edge_attn_bwd_plain(*args, g)
    _check_bf16([got], [want], ["out"])
    _check_bf16(grads, want_g, BWD_NAMES)
