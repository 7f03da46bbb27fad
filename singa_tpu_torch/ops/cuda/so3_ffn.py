"""K2: the gate-activation feed-forward network of every TransBlock.

Replaces ``singa_tpu/ops/pallas/so3_ffn.py::so3_gate_ffn_fused`` (forward,
``_gate_ffn_fwd_kernel``): per-degree linear C -> H; row l=0 becomes
``silu(h + b1)``, rows of degree l >= 1 become ``h * sigmoid(x0 @ wg + bg)``
over column block ``(l-1)H : lH``; per-degree linear H -> Co, ``b2`` on row 0
only. The CUDA kernel (``csrc/so3_gate_ffn.cu``) keeps the ``[N, I, H]``
hidden out of device memory.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch.ops.cuda import build

launches = 0  # kernel launches through ``so3_gate_ffn``
# mirrors of csrc/so3_gate_ffn.cu's constants
NODE_GROUPS = 2  # groups of four nodes per block
HIDDEN_CHUNK = 16  # hidden channels per shared-memory chunk
ROW_PAD = 8  # floats added to each row block of the x tile and the hidden slice
THREADS = 256  # threads per block
MAX_OUT_TILES = 2  # output micro-tiles (4 nodes x 4 channels) per thread
SMEM_LIMIT = 227 * 1024


def _l_of(lmax: int, device) -> torch.Tensor:
    l_of = np.asarray([l for l in range(lmax + 1) for _ in range(2 * l + 1)])
    return torch.as_tensor(l_of, dtype=torch.long, device=device)


def so3_gate_ffn_plain(x, w1, b1, wg, bg, w2, b2, lmax: int) -> torch.Tensor:
    """x [N, I, C]; w1 [L, C, H]; b1 [H]; wg [C, lmax*H]; bg [lmax*H];
    w2 [L, H, Co]; b2 [Co] -> [N, I, Co]."""
    N = x.shape[0]
    H = w1.shape[2]
    l_of = _l_of(lmax, x.device)
    h = torch.einsum("nic,ich->nih", x, w1.index_select(0, l_of))
    gates = torch.sigmoid(x[:, 0, :] @ wg + bg).reshape(N, lmax, H)
    mid = torch.cat(
        [F.silu(h[:, :1] + b1), h[:, 1:] * gates.index_select(1, l_of[1:] - 1)], dim=1
    )
    y = torch.einsum("nih,iho->nio", mid, w2.index_select(0, l_of))
    return torch.cat([y[:, :1] + b2, y[:, 1:]], dim=1)


def _fn():
    fn = build.load("so3_gate_ffn").so3_gate_ffn_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(lmax: int, C: int, Co: int) -> int:
    """Dynamic shared memory of one block (mirrors csrc/so3_gate_ffn.cu)."""
    L, I, TN, HC = lmax + 1, (lmax + 1) ** 2, 4 * NODE_GROUPS, HIDDEN_CHUNK
    floats = I * (C * TN + ROW_PAD) + lmax * HC * TN + I * (HC * TN + ROW_PAD)  # x, gates, hidden
    floats += L * C * HC + C * lmax * HC + L * HC * Co  # the chunk's weight slices
    return 4 * floats


def so3_gate_ffn_cuda(x, w1, b1, wg, bg, w2, b2, lmax: int) -> torch.Tensor:
    global launches
    N, I, C = x.shape
    L = lmax + 1
    H = w1.shape[2]
    Co = w2.shape[2]
    dev = x.device
    if I != L * L:
        raise ValueError(f"x has {I} coefficient rows, expected {(L * L)} at lmax {lmax}")
    build.require(x, "x", (N, I, C), torch.float32, dev)
    build.require(w1, "w1", (L, C, H), torch.float32, dev)
    build.require(b1, "b1", (H,), torch.float32, dev)
    build.require(wg, "wg", (C, lmax * H), torch.float32, dev)
    build.require(bg, "bg", (lmax * H,), torch.float32, dev)
    build.require(w2, "w2", (L, H, Co), torch.float32, dev)
    build.require(b2, "b2", (Co,), torch.float32, dev)
    if smem_bytes(lmax, C, Co) > SMEM_LIMIT:
        raise ValueError("so3_gate_ffn kernel: tile does not fit in shared memory")
    if Co % 4 or NODE_GROUPS * I * (Co // 4) > MAX_OUT_TILES * THREADS:
        raise ValueError(f"so3_gate_ffn kernel: {Co} output channels at lmax {lmax} not supported")
    out = torch.empty((N, I, Co), dtype=x.dtype, device=dev)
    if N == 0:
        return out
    status = _fn()(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wg.data_ptr(), bg.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), N, lmax, C, H, Co,
        build.stream_ptr(x),
    )
    build.check(status, "so3_gate_ffn")
    launches += 1
    return out


def so3_gate_ffn(x, w1, b1, wg, bg, w2, b2, lmax: int) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return so3_gate_ffn_plain(x, w1, b1, wg, bg, w2, b2, lmax)
    if x.device.type == "cuda":
        return so3_gate_ffn_cuda(x, w1, b1, wg, bg, w2, b2, lmax)
    raise ValueError(f"so3_gate_ffn runs on cpu or cuda, not {x.device}")
