"""K1: neighbour-list graph attention of every kNN encoder layer.

Replaces ``singa_tpu/ops/pallas/neighbor_attn.py::neighbor_attn_fused``
(forward, ``_attn_fwd_kernel``). Per node i and in-neighbour k: RBF smear of
the distance, the k- and v-EdgeMLPs (shifted softplus) on ``-smear``, the
per-head score ``sum_d qt * w_k * k_nb / sqrt(kd)``, a softmax over the K
neighbours plus the self slot (``diag_scores``), and the aggregate
``sum_k a * w_v * v_nb + a_self * diag_value``. The CUDA kernel
(``csrc/neighbor_attn.cu``) gathers neighbour rows by index and keeps every
pair tensor out of device memory.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from singa_tpu_torch.ops.cuda import build

launches = 0  # kernel launches through ``neighbor_attn``
SMEM_LIMIT = 227 * 1024


def _ssp(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - math.log(2.0)


def neighbor_attn_plain(
    qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
) -> torch.Tensor:
    """qt/k [B, N, H*kd]; v [B, N, H*vd]; nbr/nbr_mask/dist [B, N, K];
    diag_scores [B, N, H]; diag_value [B, N, H*vd]; centers [De]; EdgeMLP
    weights in the flax ``[in, out]`` layout; coeff = -0.5/width^2.
    Returns agg [B, N, H*vd]."""
    B, N, HK = qt.shape
    K = nbr.shape[2]
    H = diag_scores.shape[2]
    kd = HK // H
    vd = v.shape[2] // H
    diff = dist[..., None] - centers
    e = -torch.exp(coeff * diff * diff)  # [B, N, K, De]
    w_k = _ssp(e @ wk1 + bk1) @ wk2 + bk2  # [B, N, K, kd]
    w_v = _ssp(e @ wv1 + bv1) @ wv2 + bv2  # [B, N, K, vd]
    idx = nbr.long().reshape(B, N * K, 1)
    k_nb = torch.gather(k, 1, idx.expand(-1, -1, HK)).reshape(B, N, K, H, kd)
    v_nb = torch.gather(v, 1, idx.expand(-1, -1, H * vd)).reshape(B, N, K, H, vd)
    s_off = (qt.reshape(B, N, 1, H, kd) * w_k[:, :, :, None, :] * k_nb).sum(-1)
    s_off = torch.where(nbr_mask[..., None], s_off / math.sqrt(kd), -1e9)
    a = torch.softmax(torch.cat([s_off, diag_scores[:, :, None, :]], dim=2), dim=2)
    agg = (a[:, :, :K, :, None] * w_v[:, :, :, None, :] * v_nb).sum(dim=2)
    agg = agg + a[:, :, K, :, None] * diag_value.reshape(B, N, H, vd)
    return agg.reshape(B, N, H * vd)


def _fn():
    fn = build.load("neighbor_attn").neighbor_attn_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 17 + [ctypes.c_float] + [ctypes.c_void_p]
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(K: int, H: int, kd: int, vd: int, De: int) -> int:
    """Dynamic shared memory of one block (mirrors csrc/neighbor_attn.cu)."""
    floats = De * kd + kd + kd * kd + kd + De * vd + vd + vd * vd + vd + De  # weights
    floats += K * max(De, vd) + 2 * K * kd + K * vd  # pair buffers
    floats += K * H + H + H * kd + 3 * K  # scores, self weight, q row, nbr/mask/dist
    return 4 * floats


def neighbor_attn_cuda(
    qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
) -> torch.Tensor:
    global launches
    B, N, HK = qt.shape
    K = nbr.shape[2]
    H = diag_scores.shape[2]
    kd = HK // H
    vd = v.shape[2] // H
    De = centers.shape[0]
    dev = qt.device
    f32 = torch.float32
    build.require(qt, "qt", (B, N, H * kd), f32, dev)
    build.require(k, "k", (B, N, H * kd), f32, dev)
    build.require(v, "v", (B, N, H * vd), f32, dev)
    build.require(nbr, "nbr", (B, N, K), torch.int32, dev)
    build.require(nbr_mask, "nbr_mask", (B, N, K), torch.bool, dev)
    build.require(dist, "dist", (B, N, K), f32, dev)
    build.require(diag_scores, "diag_scores", (B, N, H), f32, dev)
    build.require(diag_value, "diag_value", (B, N, H * vd), f32, dev)
    build.require(centers, "centers", (De,), f32, dev)
    for name, t, shape in (
        ("wk1", wk1, (De, kd)), ("bk1", bk1, (kd,)), ("wk2", wk2, (kd, kd)),
        ("bk2", bk2, (kd,)), ("wv1", wv1, (De, vd)), ("bv1", bv1, (vd,)),
        ("wv2", wv2, (vd, vd)), ("bv2", bv2, (vd,)),
    ):
        build.require(t, name, shape, f32, dev)
    if smem_bytes(K, H, kd, vd, De) > SMEM_LIMIT:
        raise ValueError("neighbor_attn kernel: one node's pair tensors do not fit in shared memory")
    out = torch.empty((B, N, H * vd), dtype=f32, device=dev)
    if B * N == 0:
        return out
    status = _fn()(
        qt.data_ptr(), k.data_ptr(), v.data_ptr(), nbr.data_ptr(), nbr_mask.data_ptr(),
        dist.data_ptr(), diag_scores.data_ptr(), diag_value.data_ptr(), centers.data_ptr(),
        wk1.data_ptr(), bk1.data_ptr(), wk2.data_ptr(), bk2.data_ptr(),
        wv1.data_ptr(), bv1.data_ptr(), wv2.data_ptr(), bv2.data_ptr(),
        float(coeff), out.data_ptr(), B, N, K, H, kd, vd, De, build.stream_ptr(qt),
    )
    build.check(status, "neighbor_attn")
    launches += 1
    return out


def neighbor_attn(
    qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    args = (qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
            centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff)
    if qt.device.type == "cpu":
        return neighbor_attn_plain(*args)
    if qt.device.type == "cuda":
        return neighbor_attn_cuda(*args)
    raise ValueError(f"neighbor_attn runs on cpu or cuda, not {qt.device}")
