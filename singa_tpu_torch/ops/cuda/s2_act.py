"""K3: the separable S2 SiLU activation of every SO(2) graph attention.

Replaces ``singa_tpu/ops/pallas/s2_act.py::s2_silu_sep`` (forward,
``_sep_fwd_kernel``). Rows ``i >= 1`` of the output are
``sum_g fg[g, i] * silu(sum_j tg[g, j] * x[j, c])``; row 0 is
``silu(scalars[c])``. The CUDA kernel (``csrc/s2_act.cu``) keeps the
``[E, G, C]`` grid tensor out of device memory.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from singa_tpu_torch.ops.cuda import build

launches = 0  # kernel launches through ``s2_silu_sep``
MAX_I = 32  # coefficient rows a thread keeps in registers (csrc/s2_act.cu)


def s2_silu_sep_plain(
    x: torch.Tensor, scalars: torch.Tensor, to_grid: torch.Tensor, from_grid: torch.Tensor
) -> torch.Tensor:
    """x [E, I, C], scalars [E, C], to_grid/from_grid [G, I] -> [E, I, C]."""
    g = F.silu(torch.einsum("gi,eic->egc", to_grid, x))
    out = torch.einsum("gi,egc->eic", from_grid, g)
    return torch.cat([F.silu(scalars)[:, None, :], out[:, 1:]], dim=1)


def _fn():
    fn = build.load("s2_act").s2_silu_sep_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def s2_silu_sep_cuda(x, scalars, to_grid, from_grid) -> torch.Tensor:
    global launches
    E, I, C = x.shape
    G = to_grid.shape[0]
    dev = x.device
    build.require(x, "x", (E, I, C), torch.float32, dev)
    build.require(scalars, "scalars", (E, C), torch.float32, dev)
    build.require(to_grid, "to_grid", (G, I), torch.float32, dev)
    build.require(from_grid, "from_grid", (G, I), torch.float32, dev)
    if I > MAX_I:
        raise ValueError(f"s2_silu_sep kernel takes at most {MAX_I} coefficient rows, got {I}")
    out = torch.empty_like(x)
    if E == 0:
        return out
    status = _fn()(
        x.data_ptr(), scalars.data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(),
        out.data_ptr(), E, I, C, G, build.stream_ptr(x),
    )
    build.check(status, "s2_silu_sep")
    launches += 1
    return out


def s2_silu_sep(x, scalars, to_grid, from_grid) -> torch.Tensor:
    """Plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return s2_silu_sep_plain(x, scalars, to_grid, from_grid)
    if x.device.type == "cuda":
        return s2_silu_sep_cuda(x, scalars, to_grid, from_grid)
    raise ValueError(f"s2_silu_sep runs on cpu or cuda, not {x.device}")
