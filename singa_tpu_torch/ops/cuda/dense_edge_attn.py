"""K8/K8b: dense-row edge-conditioned graph attention of the kNN encoder
(``SINGA_TPU_DENSE_ATTN``), and its backward.

K8 replaces ``singa_tpu/ops/pallas/dense_edge_attn.py::dense_edge_attn``
(``_dattn_fwd_kernel``) and K8b its ``_dbwd`` (``_dattn_bwd_kernel``): K1's
function (``neighbor_attn``) over every column j of a node's graph instead
of its K neighbour slots. The kNN adjacency and the pair distances travel
as one [B, N, N] tensor, ``adj_dist``: the distance where j is adjacent to
i in the symmetrised, untruncated kNN graph, ``BIG`` elsewhere (the diagonal
and padded nodes included). Scores of pairs at ``BIG / 2`` or beyond are
-1e9; the softmax runs over the N columns and the self slot. adj_dist and
centers get no gradient. ``dense_edge_attn`` goes through one
``torch.autograd.Function``: plain versions for CPU tensors, the kernels
(``csrc/dense_edge_attn.cu``, ``csrc/dense_edge_attn_bwd.cu``: the form
``kDense`` of ``csrc/encoder_attn.cuh``) for CUDA tensors. The plain
versions are the definition, K7's (``neighbor_attn_hybrid_plain``) with
every column a slot. The kernels walk each row's live columns only
(``live_columns``, built once per graph by ``build_neighbor_graph``) and
take rows with no live column in closed form; dk/dv gather over the CSR
transpose of the live pairs.

K8 and K8b have bfloat16 instances (entry points ``dense_edge_attn_bf16``
and ``dense_edge_attn_bwd_bf16``, the same kernels at bfloat16 storage),
counted in ``launches_bf16`` and ``launches_bwd_bf16``, taken for a
bfloat16 qt, k, v and diag_value (adj_dist, diag_scores, centers and the
EdgeMLP weights stay float32). They round where ``_dattn_fwd_kernel`` and
``_dattn_bwd_kernel`` round at a bfloat16 dtype, which is not where K1's
do: the TPU kernel repeats, sums and broadcasts the heads by float32 lane
operations, not matrix products, so the forward rounds only the smear, the
EdgeMLP weights and their hiddens (w_k, w_v, the score terms and the
softmax weights stay float32) and the output once; the backward also
rounds dw_k and dw_v before the EdgeMLPs' backward and dh after its sigmoid
factor, sums dk and dv in float32 and rounds them once; dqt and d
diag_value come out bfloat16, d diag_scores and the weight gradients
float32. ``dense_edge_attn_bf16_plain`` and ``dense_edge_attn_bf16_bwd_plain``
are their plain twins (every column evaluated, one graph at a time).
K8b·bf16 has two instances, chosen by shape before the launch
(``bwd_bf16_instance``): its tensor-core kernels (``csrc/neighbor_attn_bwd.cu``,
K1b·bf16's plan, pair and dk/dv kernels in their dense form: each live row's
live columns whole in one tile of at most 128, the EdgeMLPs' products as
one TF32 ``mma.sync`` each, with the dense form's roundings) wherever the
lists' largest live count (``DenseLists.max_live``, read once when
``live_columns`` builds them) is at most 128 at the encoder's widths, and
its CUDA-core kernels (``csrc/encoder_attn.cuh``'s, on
``csrc/dense_edge_attn_bwd.cu``) otherwise, or with ``cuda_cores``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from singa_tpu_torch.dtypes import rounded
from singa_tpu_torch.ops.cuda import build
from singa_tpu_torch.ops.cuda.neighbor_attn import _ssp, check_node_args, neighbor_attn_hybrid_plain

BIG = 1e9  # adj_dist's value for a pair that is not adjacent
launches = 0  # forward kernel launches through ``dense_edge_attn``
launches_bwd = 0  # backward kernel launches through ``dense_edge_attn``
launches_bf16 = 0  # K8's bfloat16 instance's launches (not in ``launches``)
launches_bwd_bf16 = 0  # K8b's bfloat16 instance's launches


class DenseLists(NamedTuple):
    """Each row's live columns of ``adj_dist`` [B, N, N] (E live pairs in
    all), as CSR lists and their transpose, int32."""

    row_offsets: torch.Tensor  # [B*N + 1]: row r's pairs are row_offsets[r]:row_offsets[r+1]
    cols: torch.Tensor  # [E] graph-local column of each pair, ascending within a row
    pair_rows: torch.Tensor  # [E] flat row b*N + i of each pair
    col_offsets: torch.Tensor  # [B*N + 1]: the pairs whose column is row j, ...
    col_pairs: torch.Tensor  # [E] ... at col_pairs[col_offsets[j]:col_offsets[j+1]], ascending
    row_order: torch.Tensor  # [B*N] rows by descending live count (stable), as the kernels go
    max_live: int  # the largest live count of any row (0 for none): what picks K8b·bf16's kernels


def live_columns(adj_dist: torch.Tensor) -> DenseLists:
    """The live pairs (adj_dist < BIG / 2) of every row, in row-major order,
    their CSR transpose (a stable sort of each pair's column as a flat row,
    as ``transpose_slots`` sorts nbr), the order in which the kernels'
    blocks take the rows (a row's work grows with its live count), and the
    largest live count, read once here (on the card one more host sync
    beside ``nonzero``'s) so that no kernel call has to."""
    B, N, _ = adj_dist.shape
    live = (adj_dist < 0.5 * BIG).reshape(B * N, N)
    rows, cols = live.nonzero(as_tuple=True)
    keys = rows.div(N, rounding_mode="floor") * N + cols  # the column's flat row
    offsets = lambda counts: torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(
        torch.int32)
    counts = live.sum(1)
    max_live = int(counts.max()) if counts.numel() else 0
    return DenseLists(
        row_offsets=offsets(counts),
        cols=cols.to(torch.int32),
        pair_rows=rows.to(torch.int32),
        col_offsets=offsets(torch.bincount(keys, minlength=B * N)),
        col_pairs=torch.sort(keys, stable=True).indices.to(torch.int32),
        row_order=torch.sort(counts, descending=True, stable=True).indices.to(torch.int32),
        max_live=max_live,
    )


def _graph_rows(qt, k, v, adj, diag_scores, diag_value):
    """One graph's arguments ([N, *]) as K7's plain version takes a batch of
    one: every column j is a slot of every row, k_nb/v_nb
    [1, N, N, *] are expanded views of k/v, a slot is live where adj is
    below BIG / 2, and adj is its distance."""
    N = qt.shape[0]
    return (qt[None], k.expand(N, *k.shape)[None], v.expand(N, *v.shape)[None],
            (adj < 0.5 * BIG)[None], adj[None], diag_scores[None], diag_value[None])


def dense_edge_attn_plain(
    qt, k, v, adj_dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
) -> torch.Tensor:
    """qt/k [B, N, H*kd]; v [B, N, H*vd]; adj_dist [B, N, N]; diag_scores
    [B, N, H]; diag_value [B, N, H*vd]; centers [De]; EdgeMLP weights in the
    flax ``[in, out]`` layout; coeff = -0.5/width^2. Returns agg
    [B, N, H*vd]. One graph at a time, so that the [N, N, *] pair tensors
    of one graph are alive at once. A bfloat16 ``k`` takes the kernel's
    bfloat16 function (``dense_edge_attn_bf16_plain``)."""
    if k.dtype == torch.bfloat16:
        return dense_edge_attn_bf16_plain(qt, k, v, adj_dist, diag_scores, diag_value,
                                          centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff)
    B, N, _ = qt.shape
    weights = (centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    outs = [neighbor_attn_hybrid_plain(*_graph_rows(qt[b], k[b], v[b], adj_dist[b],
                                                    diag_scores[b], diag_value[b]),
                                       *weights, coeff)[0] for b in range(B)]
    return torch.stack(outs) if outs else qt.new_zeros((0, N, v.shape[2]))


def dense_edge_attn_bwd_plain(*args):
    """``(dqt, dk, dv, d diag_scores, d diag_value, dwk1, dbk1, dwk2, dbk2,
    dwv1, dbv1, dwv2, dbv2)`` of ``dense_edge_attn_plain``: ``args`` are its
    arguments followed by the cotangent ``g``. One graph at a time; the
    weight gradients are summed over the graphs in order. At a bfloat16
    ``k``, ``dense_edge_attn_bf16_bwd_plain``."""
    if args[1].dtype == torch.bfloat16:
        return dense_edge_attn_bf16_bwd_plain(*args)
    *inputs, coeff, g = args
    B = inputs[0].shape[0]
    weights = inputs[6:]
    per_graph = []  # (dqt, dk, dv, dds, ddv) of each graph
    wgrads = [torch.zeros_like(w) for w in weights[1:]]
    with torch.enable_grad():
        ws = [w.detach().requires_grad_() for w in weights[1:]]
        for b in range(B):
            rows = [t[b].detach().requires_grad_() for t in (inputs[0], inputs[1], inputs[2])]
            diag = [inputs[4][b].detach().requires_grad_(), inputs[5][b].detach().requires_grad_()]
            out = neighbor_attn_hybrid_plain(*_graph_rows(*rows, inputs[3][b], *diag),
                                             weights[0], *ws, coeff)[0]
            grads = torch.autograd.grad(out, [*rows, *diag, *ws], g[b])
            per_graph.append(grads[:5])
            for acc, gw in zip(wgrads, grads[5:]):
                acc += gw
    if B:
        node_grads = [torch.stack(parts) for parts in zip(*per_graph)]
    else:
        node_grads = [torch.zeros_like(inputs[i]) for i in (0, 1, 2, 4, 5)]
    return (*node_grads, *wgrads)


def _bf16_graph(qt, k, v, adj, diag_scores, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                coeff):
    """What K8's bfloat16 instance computes over one graph's N x N pairs
    (qt, k, v [N, *] bfloat16; adj [N, N]), as float32 tensors, rounding
    where ``_dattn_fwd_kernel`` rounds: the smear ``e`` (a dead column's is
    -0), the EdgeMLPs' pre-activations, their rounded hiddens and their
    outputs ``w_k``, ``w_v`` (float32, from the rounded weights); the rows
    widened; the scores (float32 products summed over each head's lanes,
    -1e9 on dead columns) and the softmax weights over the N columns and the
    self slot."""
    dt = k.dtype
    N, HK = qt.shape
    H = diag_scores.shape[1]
    kd = HK // H
    vd = v.shape[1] // H
    diff = adj[..., None] - centers
    e = rounded(-torch.exp(coeff * diff * diff), dt)  # [N, N, De]
    pre_k = e @ rounded(wk1, dt) + bk1
    hid_k = rounded(_ssp(pre_k), dt)
    w_k = hid_k @ rounded(wk2, dt) + bk2  # [N, N, kd]
    pre_v = e @ rounded(wv1, dt) + bv1
    hid_v = rounded(_ssp(pre_v), dt)
    w_v = hid_v @ rounded(wv2, dt) + bv2  # [N, N, vd]
    k_all = k.float().reshape(1, N, H, kd)
    v_all = v.float().reshape(1, N, H, vd)
    q = qt.float().reshape(N, 1, H, kd)
    kw = w_k[:, :, None, :] * k_all  # [N, N, H, kd]
    live = adj < 0.5 * BIG
    s_off = torch.where(live[..., None], (kw * q).sum(-1) * (1.0 / math.sqrt(kd)), -1e9)
    s_diag = diag_scores.float()
    m = torch.maximum(s_off.amax(dim=1), s_diag)  # [N, H]
    p_off = torch.exp(s_off - m[:, None])
    p_diag = torch.exp(s_diag - m)
    den = p_off.sum(dim=1) + p_diag
    return dict(e=e, pre_k=pre_k, hid_k=hid_k, w_k=w_k, pre_v=pre_v, hid_v=hid_v, w_v=w_v,
                k_all=k_all, v_all=v_all, q=q, kw=kw, live=live,
                a_off=p_off / den[:, None], a_diag=p_diag / den)


def dense_edge_attn_bf16_plain(qt, k, v, adj_dist, diag_scores, diag_value,
                               centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff):
    """K8's bfloat16 instance in plain PyTorch (bfloat16 qt, k, v,
    diag_value; the rest float32), one graph at a time: ``_bf16_graph``'s
    softmax weights on w_v v, plus a_self diag_value, in float32, the
    output rounded once."""
    B, N, HV = v.shape
    H = diag_scores.shape[2]
    outs = []
    for b in range(B):
        p = _bf16_graph(qt[b], k[b], v[b], adj_dist[b], diag_scores[b], centers,
                        wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff)
        wvv = p["w_v"][:, :, None, :] * p["v_all"]  # [N, N, H, vd]
        agg = (p["a_off"][..., None] * wvv).sum(dim=1)
        agg = agg + p["a_diag"][..., None] * diag_value[b].float().reshape(N, H, HV // H)
        outs.append(agg.reshape(N, HV).to(v.dtype))
    return torch.stack(outs) if outs else v.new_zeros((0, N, HV))


def dense_edge_attn_bf16_bwd_plain(qt, k, v, adj_dist, diag_scores, diag_value,
                                   centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, g):
    """K8b's bfloat16 instance in plain PyTorch, one graph at a time, as
    ``_dattn_bwd_kernel`` computes at a bfloat16 dtype: da, the softmax
    backward, dsc, dqt, dk_nb, dv_nb, dw_k and dw_v in float32 from the
    forward ``_bf16_graph`` recomputes; dw_k and dw_v rounded, dh =
    round((dw W2^T) sigmoid(pre)) from the rounded W2; the weight gradients
    summed in float32 over the graphs in order; dk and dv the float32 column
    sums, rounded once; dqt and d diag_value bfloat16, d diag_scores
    float32."""
    dt = k.dtype
    B, N, HK = qt.shape
    H = diag_scores.shape[2]
    kd, vd = HK // H, v.shape[2] // H
    scale = 1.0 / math.sqrt(kd)
    weights = (wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    wgrads = [torch.zeros_like(w) for w in weights]
    node = []  # (dqt, dk, dv, dds, ddv) of each graph
    for b in range(B):
        p = _bf16_graph(qt[b], k[b], v[b], adj_dist[b], diag_scores[b], centers, *weights, coeff)
        gb = g[b].float().reshape(N, 1, H, vd)
        dval = diag_value[b].float().reshape(N, H, vd)
        w_k, w_v = p["w_k"][:, :, None, :], p["w_v"][:, :, None, :]  # [N, N, 1, d]
        a_off, a_diag = p["a_off"], p["a_diag"]
        da_off = (gb * (w_v * p["v_all"])).sum(-1)  # [N, N, H]
        da_diag = (gb[:, 0] * dval).sum(-1)  # [N, H]
        a_t = a_off[..., None]
        dwv3 = (a_t * gb * p["v_all"]).sum(2)  # [N, N, vd]
        dv_nb = a_t * w_v * gb
        ddv = (a_diag[..., None] * gb[:, 0]).reshape(N, H * vd).to(dt)
        dot = (a_off * da_off).sum(dim=1) + a_diag * da_diag
        dds = a_diag * (da_diag - dot)
        ds_off = torch.where(p["live"][..., None], a_off * (da_off - dot[:, None]), 0.0) * scale
        ds_t = ds_off[..., None]
        dqt = (ds_t * p["kw"]).sum(dim=1).reshape(N, HK).to(dt)
        dk_nb = ds_t * w_k * p["q"]
        dwk3 = (ds_t * p["k_all"] * p["q"]).sum(2)  # [N, N, kd]
        for i, (dw3, pre, hid, w2) in enumerate(((dwk3, p["pre_k"], p["hid_k"], wk2),
                                                 (dwv3, p["pre_v"], p["hid_v"], wv2))):
            dw3 = rounded(dw3, dt)
            dh = rounded((dw3 @ rounded(w2, dt).t()) * torch.sigmoid(pre), dt)
            for j, gw in enumerate((torch.einsum("nme,nmh->eh", p["e"], dh), dh.sum((0, 1)),
                                    torch.einsum("nmh,nmo->ho", hid, dw3), dw3.sum((0, 1)))):
                wgrads[4 * i + j] += gw
        dk = dk_nb.sum(dim=0).reshape(N, HK).to(dt)
        dv = dv_nb.sum(dim=0).reshape(N, H * vd).to(dt)
        node.append((dqt, dk, dv, dds, ddv))
    if B:
        node_grads = [torch.stack(parts) for parts in zip(*node)]
    else:
        node_grads = [torch.zeros_like(t) for t in (qt, k, v, diag_scores, diag_value)]
    return (*node_grads, *wgrads)


def _fn(bf16: bool = False):
    fn = getattr(build.load("dense_edge_attn"), "dense_edge_attn_bf16" if bf16
                 else "dense_edge_attn_f32")
    fn.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_float] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


# K8b·bf16's tensor-core kernels take the encoder's widths (kd, vd, De),
# at most TC_MAX_HEADS heads, and lists whose every row fits one tile
TC_WIDTHS = (32, 64, 64)
TC_MAX_HEADS = 4
TC_MAX_LIVE = 128


def bwd_bf16_instance(max_live: int, H: int, kd: int, vd: int, De: int,
                      cuda_cores: bool = False) -> str:
    """Which of K8b·bf16's instances a call runs, by shape, before the
    launch: "tensor_cores" (``csrc/neighbor_attn_bwd.cu``'s list kernels in
    their dense form) at the encoder's widths, H <= 4 and lists whose
    largest live count (``DenseLists.max_live``) is at most 128, so that
    every live row sits whole in one tile; else, or with ``cuda_cores``,
    "cuda_cores" (``csrc/encoder_attn.cuh``'s dense kernels). Nothing is
    retried after a failure."""
    takes = ((kd, vd, De) == TC_WIDTHS and 1 <= H <= TC_MAX_HEADS
             and 0 <= max_live <= TC_MAX_LIVE)
    return "tensor_cores" if takes and not cuda_cores else "cuda_cores"


def _bwd_tc_fns():
    """(blocks, launch) of K8b·bf16's tensor-core entry points."""
    lib = build.load("neighbor_attn_bwd")
    blocks = lib.dense_edge_attn_bwd_tc_blocks
    blocks.argtypes = [ctypes.c_int] * 7
    blocks.restype = ctypes.c_int
    fn = lib.dense_edge_attn_bwd_tc
    fn.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_float] + [ctypes.c_void_p] * 21
        + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return blocks, fn


def bwd_tc_residency() -> dict:
    """K8b·bf16's tensor-core pair kernel: resident blocks per SM (-1:
    refused), threads and dynamic shared memory per block. For reports;
    launches nothing."""
    fn = build.load("neighbor_attn_bwd").dense_edge_attn_bwd_tc_residency
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def _bwd_fns(bf16: bool = False):
    lib = build.load("dense_edge_attn_bwd")
    blocks = lib.dense_edge_attn_bwd_blocks
    blocks.argtypes = [ctypes.c_int] * 7
    blocks.restype = ctypes.c_int
    fn = lib.dense_edge_attn_bwd_bf16 if bf16 else lib.dense_edge_attn_bwd_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_float] + [ctypes.c_void_p] * 21
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return blocks, fn


def _check_args(qt, k, v, adj_dist, diag_scores, diag_value,
                centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, lists):
    """Device, dtype, shape and contiguity of every kernel argument; returns
    (B, N, H, kd, vd, De, lists as ``DenseLists``). qt, k, v and diag_value
    are float32, or bfloat16 all four for the bfloat16 instance; adj_dist,
    diag_scores, centers and the weights float32."""
    B, N, HK = qt.shape
    H = diag_scores.shape[2]
    kd = HK // H
    vd = v.shape[2] // H
    De = centers.shape[0]
    dev = qt.device
    f32 = torch.float32
    act = torch.bfloat16 if qt.dtype == torch.bfloat16 else f32
    build.require(qt, "qt", (B, N, H * kd), act, dev)
    build.require(k, "k", (B, N, H * kd), act, dev)
    build.require(v, "v", (B, N, H * vd), act, dev)
    build.require(adj_dist, "adj_dist", (B, N, N), f32, dev)
    check_node_args(qt, diag_scores, diag_value, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                    vd, act)
    lists = DenseLists(*lists)
    E = lists.cols.shape[0]
    for name, shape in (("row_offsets", B * N + 1), ("cols", E), ("pair_rows", E),
                        ("col_offsets", B * N + 1), ("col_pairs", E), ("row_order", B * N)):
        build.require(getattr(lists, name), name, (shape,), torch.int32, dev)
    return B, N, H, kd, vd, De, lists


def _aligned(tensors, lists):
    """``build.aligned`` of each tensor and of each of the lists' tensors."""
    return ([build.aligned(t) for t in tensors],
            DenseLists(*(build.aligned(t) for t in lists[:6]), lists.max_live))


def dense_edge_attn_cuda(
    qt, k, v, adj_dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float, *, lists,
) -> torch.Tensor:
    """The K8 kernel (at a bfloat16 qt, k, v and diag_value its bfloat16
    instance); arguments and result as ``dense_edge_attn_plain``, plus
    ``lists = live_columns(adj_dist)``."""
    global launches, launches_bf16
    args = (qt, k, v, adj_dist, diag_scores, diag_value,
            centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    B, N, H, kd, vd, De, lists = _check_args(*args, lists)
    args, lists = _aligned(args, lists)
    bf16 = qt.dtype == torch.bfloat16
    out = torch.empty((B, N, H * vd), dtype=qt.dtype, device=qt.device)
    if B * N == 0:
        return out
    vsum = torch.empty((B, H * vd), dtype=torch.float32, device=qt.device)
    status = _fn(bf16)(*(t.data_ptr() for t in args), float(coeff), lists.row_offsets.data_ptr(),
                       lists.cols.data_ptr(), lists.row_order.data_ptr(), vsum.data_ptr(),
                       out.data_ptr(), B, N, H, kd, vd, De, build.stream_ptr(qt))
    build.check(status, "dense_edge_attn")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def dense_edge_attn_bwd_cuda(*args, lists, cuda_cores: bool = False, stats=None):
    """The K8b kernels (at a bfloat16 qt its bfloat16 instance, whose
    kernels ``bwd_bf16_instance`` picks by shape: its tensor-core ones, or
    ``cuda_cores`` its CUDA-core ones at any shape, to time the two);
    arguments and result as ``dense_edge_attn_bwd_plain``, plus ``lists =
    live_columns(adj_dist)``. Scratch: the four numbers per live pair that
    the dk/dv gather reads, [E, kd + vd + 2H] floats, and per graph v's
    column sums and the closed-form rows' cotangent sum (the tensor-core
    kernels: each row's plan too). ``stats``: None, or an int32 tensor [5]
    of zeros on the card, to which the tensor-core kernels add what they
    walked: rows skipped for a zero cotangent, rows taken with their live
    columns, (row, head) pairs whose max would leave a dead column a weight
    (none on any real input), live pairs evaluated, rows in closed form."""
    global launches_bwd, launches_bwd_bf16
    *inputs, coeff, g = args
    B, N, H, kd, vd, De, lists = _check_args(*inputs, lists)
    qt = inputs[0]
    dev = qt.device
    f32 = torch.float32
    bf16 = qt.dtype == torch.bfloat16
    build.require(g, "g", (B, N, H * vd), qt.dtype, dev)
    if stats is not None:
        build.require(stats, "stats", (5,), torch.int32, dev)
    (*inputs, g), lists = _aligned((*inputs, g), lists)
    empty = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    act = lambda *shape: torch.empty(shape, dtype=qt.dtype, device=dev)
    dqt, dk = act(B, N, H * kd), act(B, N, H * kd)
    dv, dds, ddv = act(B, N, H * vd), empty(B, N, H), act(B, N, H * vd)
    sizes = (De * kd, kd, kd * kd, kd, De * vd, vd, vd * vd, vd)
    grads = torch.zeros(sum(sizes), dtype=f32, device=dev)
    tc = bf16 and bwd_bf16_instance(lists.max_live, H, kd, vd, De, cuda_cores) == "tensor_cores"
    if B * N and tc:
        blocks_fn, fn = _bwd_tc_fns()
        blocks = blocks_fn(B, N, H, kd, vd, De, lists.max_live)
        if blocks < 1:
            raise ValueError(f"dense_edge_attn backward tensor-core kernels: shapes "
                             f"{(H, kd, vd, De)} or largest live count {lists.max_live} "
                             "not supported")
        E = lists.cols.shape[0]
        scratch = (empty(E, kd), empty(E, vd), empty(E, H), empty(E, H), empty(B * N, H),
                   empty(B, H * vd), empty(B, H * vd),
                   torch.empty(B * N, dtype=torch.int32, device=dev),
                   empty(blocks + 1, sum(sizes)))
        status = fn(
            *(t.data_ptr() for t in inputs), float(coeff), g.data_ptr(),
            lists.row_offsets.data_ptr(), lists.cols.data_ptr(), lists.pair_rows.data_ptr(),
            lists.col_offsets.data_ptr(), lists.col_pairs.data_ptr(),
            dqt.data_ptr(), dk.data_ptr(), dv.data_ptr(), dds.data_ptr(), ddv.data_ptr(),
            *(t.data_ptr() for t in scratch), grads.data_ptr(),
            B, N, H, kd, vd, De, lists.max_live, blocks,
            None if stats is None else stats.data_ptr(), build.stream_ptr(qt),
        )
        build.check(status, "dense_edge_attn_bwd")
        launches_bwd_bf16 += 1
    elif B * N:
        blocks_fn, fn = _bwd_fns(bf16)
        blocks = blocks_fn(B, N, H, kd, vd, De, int(bf16))
        if blocks < 1:
            raise ValueError(f"dense_edge_attn backward kernel: shapes {(H, kd, vd, De)} not "
                             "supported or one tile's pair tensors exceed shared memory")
        E = lists.cols.shape[0]
        scratch = (empty(E, kd), empty(E, vd), empty(E, H), empty(E, H), empty(B * N, H),
                   empty(B, H * vd), empty(B, H * vd), empty(blocks + 1, sum(sizes)))
        status = fn(
            *(t.data_ptr() for t in inputs), float(coeff), g.data_ptr(),
            lists.row_offsets.data_ptr(), lists.cols.data_ptr(), lists.pair_rows.data_ptr(),
            lists.col_offsets.data_ptr(), lists.col_pairs.data_ptr(), lists.row_order.data_ptr(),
            dqt.data_ptr(), dk.data_ptr(), dv.data_ptr(), dds.data_ptr(), ddv.data_ptr(),
            *(t.data_ptr() for t in scratch), grads.data_ptr(),
            B, N, H, kd, vd, De, blocks, build.stream_ptr(qt),
        )
        build.check(status, "dense_edge_attn_bwd")
        if bf16:
            launches_bwd_bf16 += 1
        else:
            launches_bwd += 1
    weights = inputs[7:]
    wgrads = [p.view(w.shape) for p, w in zip(torch.split(grads, sizes), weights)]
    return (dqt, dk, dv, dds, ddv, *wgrads)


def residency(N: int, H: int, kd: int, vd: int, De: int, bf16: bool = False) -> dict:
    """K8's kernel and K8b's pair kernel at these widths (``bf16``: their
    bfloat16 instances): live columns per tile, resident blocks per SM and
    dynamic shared memory per block (-1 blocks: over the card's limit). For
    reports; launches nothing."""
    out = {}
    for key, lib in (("fwd", "dense_edge_attn"), ("bwd", "dense_edge_attn_bwd")):
        fn = getattr(build.load(lib), f"{lib}_residency")
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        smem, tile = ctypes.c_int(0), ctypes.c_int(0)
        per_sm = fn(N, H, kd, vd, De, int(bf16), ctypes.byref(smem), ctypes.byref(tile))
        out[key] = {"tile": tile.value, "blocks_per_sm": per_sm, "smem_bytes": smem.value}
    return out


class DenseEdgeAttn(torch.autograd.Function):
    """K8 forward and K8b backward. ``ctx`` keeps the inputs only, as
    ``_dfwd`` does; the backward recomputes every pair tensor. The last
    seven arguments are the live lists (None on CPU tensors)."""

    @staticmethod
    def forward(ctx, *args):
        *inputs, coeff = args[:-7]
        lists = args[-7:]
        ctx.coeff = coeff
        ctx.on_cpu = inputs[0].device.type == "cpu"
        ctx.max_live = lists[6]
        ctx.save_for_backward(*inputs, *(() if ctx.on_cpu else lists[:6]))
        if ctx.on_cpu:
            return dense_edge_attn_plain(*inputs, coeff)
        return dense_edge_attn_cuda(*inputs, coeff, lists=lists)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs, lists = saved[:15], DenseLists(*saved[15:], ctx.max_live) if saved[15:] else None
        args = (*inputs, ctx.coeff, g.contiguous())
        if ctx.on_cpu:
            grads = dense_edge_attn_bwd_plain(*args)
        else:
            grads = dense_edge_attn_bwd_cuda(*args, lists=lists)
        dqt, dk, dv, dds, ddv, *wgrads = grads
        # adj_dist, centers, coeff and the lists get none, as in the JAX _dbwd
        return (dqt, dk, dv, None, dds, ddv, None, *wgrads, None, *(None,) * 7)


def dense_edge_attn(
    qt, k, v, adj_dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
    lists: DenseLists | None = None,
) -> torch.Tensor:
    """Plain versions for CPU tensors, the CUDA kernels for CUDA tensors.
    ``lists``: ``live_columns(adj_dist)``, built here when not given (the
    encoder builds them once per graph, beside adj_dist)."""
    if qt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_edge_attn runs on cpu or cuda, not {qt.device}")
    if qt.device.type == "cpu":
        lists = (None,) * 7
    elif lists is None:
        lists = live_columns(adj_dist)
    return DenseEdgeAttn.apply(qt, k, v, adj_dist, diag_scores, diag_value,
                               centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, *lists)
