"""K3/K3b: the separable S2 SiLU activation of every SO(2) graph attention,
and its backward; K5/K5b: the S2 SiLU on all rows, and its backward.

K3 replaces ``singa_tpu/ops/pallas/s2_act.py::s2_silu_sep`` (forward,
``_sep_fwd_kernel``). Rows ``i >= 1`` of the output are
``sum_g fg[g, i] * silu(sum_j tg[g, j] * x[j, c])``; row 0 is
``silu(scalars[c])``. K3b replaces ``_sep_bwd`` (``_sep_bwd_kernel``): the
gradients of ``x`` and ``scalars``; row 0 of the cotangent reaches only
``scalars``. Both CUDA kernels (``csrc/s2_act.cu``) keep the ``[E, G, C]``
grid tensor out of device memory: as split-TF32 ``mma.sync`` chains on the
tensor cores where they take the shapes (``I <= 32``, ``C`` a multiple of
16), else on the CUDA cores (``s2_silu_sep_instance`` says which), at
either dtype.
``s2_silu_sep`` goes through one ``torch.autograd.Function``: plain versions
for CPU tensors, the kernels for CUDA tensors.

K3 and K3b have bfloat16 instances (the bfloat16 training path's) at
bfloat16 storage of x, scalars, the grid matrices (cast to bfloat16 by the
caller, as the TPU kernel casts them to ``x.dtype``) and the outputs,
counted in ``launches_bf16`` and ``launches_bwd_bf16``: their tensor-core
kernels at bfloat16, one TF32 product where float32 takes three (a
bfloat16 value is a TF32 value), at the shapes they take, else their
CUDA-core kernels at bfloat16; ``cuda_cores`` as at float32. They are the
function ``_sep_fwd_kernel`` and ``_sep_bwd_kernel`` compute at a bfloat16
x and round where those round: products summed in float32, ``silu(grid)``
rounded before the from-grid product, the row-0 gate ``silu(scalars)`` in
float32; backward, ``h = silu'(v) u`` rounded before ``dx = tg^T h``;
every output rounded once. ``s2_silu_sep_bf16_plain`` and
``s2_silu_sep_bf16_bwd_plain`` are their plain twins. K5 has no bfloat16
instance (it is on no path).

K5 replaces ``s2_act.py::s2_silu`` (``s2_silu_pallas``, ``_fwd_kernel``):
``from_grid . silu(to_grid . x)`` on every row, for any ``I`` up to 64. K5b
replaces ``_bwd`` (``_bwd_kernel``): ``dx = to_grid^T (silu'(to_grid . x) *
from_grid . g)``, with no row-0 case. Both run K3's and K3b's tensor-core
chains without the row-0 case where they take the shapes (``I <= 49``, the
full lmax-6 grid with its row 48 in float32; ``C`` a multiple of 16), else
K4's CUDA-core grid chain (``csrc/s2_grid.cuh``); ``s2_silu_instance`` says
which. ``s2_silu`` goes through ``S2Silu``. The TPU wrapper's 128-channel
padding and tile sizing are Mosaic's and are not carried over.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from singa_tpu_torch.dtypes import rounded
from singa_tpu_torch.ops.cuda import build

launches = 0  # forward kernel launches through ``s2_silu_sep``
launches_bwd = 0  # backward kernel launches through ``s2_silu_sep``
launches_bf16 = 0  # its bfloat16 instance's forward launches (not in ``launches``)
launches_bwd_bf16 = 0  # its bfloat16 instance's backward launches
launches_silu = 0  # forward kernel launches through ``s2_silu``
launches_silu_bwd = 0  # backward kernel launches through ``s2_silu``


def _silu_grad(v: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(v)
    return s * (1.0 + v * (1.0 - s))


def s2_silu_sep_plain(
    x: torch.Tensor, scalars: torch.Tensor, to_grid: torch.Tensor, from_grid: torch.Tensor
) -> torch.Tensor:
    """x [E, I, C], scalars [E, C], to_grid/from_grid [G, I] -> [E, I, C].
    A bfloat16 ``x`` takes the kernel's bfloat16 function
    (``s2_silu_sep_bf16_plain``)."""
    if x.dtype == torch.bfloat16:
        return s2_silu_sep_bf16_plain(x, scalars, to_grid, from_grid)
    g = F.silu(torch.einsum("gi,eic->egc", to_grid, x))
    out = torch.einsum("gi,egc->eic", from_grid, g)
    return torch.cat([F.silu(scalars)[:, None, :], out[:, 1:]], dim=1)


def s2_silu_sep_bf16_plain(x, scalars, to_grid, from_grid) -> torch.Tensor:
    """K3's bfloat16 instance in plain PyTorch, rounding where
    ``_sep_fwd_kernel`` rounds at a bfloat16 ``x``: the grid matrices in
    bfloat16, both products summed in float32, ``silu(grid)`` rounded, the
    row-0 gate ``silu(scalars)`` in float32, the output rounded."""
    dt = x.dtype
    grid = torch.einsum("gi,eic->egc", rounded(to_grid, dt), x.float())
    out = torch.einsum("gi,egc->eic", rounded(from_grid, dt), rounded(F.silu(grid), dt))
    return torch.cat([F.silu(scalars.float())[:, None, :], out[:, 1:]], dim=1).to(dt)


def s2_silu_sep_bf16_bwd_plain(x, scalars, to_grid, from_grid, g):
    """K3b's bfloat16 instance in plain PyTorch (``_sep_bwd_kernel``):
    ``ds = silu'(s) g[:, 0]`` rounded to the scalars' dtype; the cotangent's
    row 0 zeroed; ``h = silu'(tg x) (fg g)`` rounded before ``dx = tg^T h``,
    which is rounded."""
    dt = x.dtype
    tg, fg = rounded(to_grid, dt), rounded(from_grid, dt)
    gf = g.float()
    ds = (_silu_grad(scalars.float()) * gf[:, 0]).to(scalars.dtype)
    gf = torch.cat([torch.zeros_like(gf[:, :1]), gf[:, 1:]], dim=1)
    grid = torch.einsum("gi,eic->egc", tg, x.float())
    h = rounded(_silu_grad(grid) * torch.einsum("gi,eic->egc", fg, gf), dt)
    return torch.einsum("gi,egc->eic", tg, h).to(dt), ds


def s2_silu_sep_bwd_plain(x, scalars, to_grid, from_grid, g):
    """(dx, dscalars) of ``s2_silu_sep_plain`` at cotangent ``g``; at a
    bfloat16 ``x``, ``s2_silu_sep_bf16_bwd_plain``."""
    if x.dtype == torch.bfloat16:
        return s2_silu_sep_bf16_bwd_plain(x, scalars, to_grid, from_grid, g)
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        scalars = scalars.detach().requires_grad_()
        out = s2_silu_sep_plain(x, scalars, to_grid, from_grid)
        return torch.autograd.grad(out, (x, scalars), g)


@functools.cache
def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.load("s2_act"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def s2_silu_sep_instance(I: int, C: int, G: int, bf16: bool = False) -> str | None:
    """Which of K3's (and K3b's) kernels runs these shapes (any E; ``bf16``:
    their bfloat16 instances): "tensor_cores", "cuda_cores", or None for a
    shape neither takes. Launches nothing."""
    fn = build.load("s2_act").s2_silu_sep_instance
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return {1: "tensor_cores", 0: "cuda_cores"}.get(fn(I, C, G, int(bf16)))


def sep_residency(I: int, C: int, G: int, bwd: bool = False, bf16: bool = False) -> dict:
    """K3's tensor-core kernel (``bwd``: K3b's; ``bf16``: its bfloat16
    instance) at these shapes: resident blocks per SM (-1: shapes it does
    not take), threads and dynamic shared memory per block. For reports;
    launches nothing."""
    fn = build.load("s2_act").s2_silu_sep_residency
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(I, C, G, int(bwd), int(bf16), ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def _check_args(x, scalars, to_grid, from_grid):
    """Shapes, devices and dtypes: every tensor float32, or (the bfloat16
    instance) every one bfloat16."""
    E, I, C = x.shape
    G = to_grid.shape[0]
    dev = x.device
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    build.require(x, "x", (E, I, C), dt, dev)
    build.require(scalars, "scalars", (E, C), dt, dev)
    build.require(to_grid, "to_grid", (G, I), dt, dev)
    build.require(from_grid, "from_grid", (G, I), dt, dev)
    return E, I, C, G


def s2_silu_sep_cuda(x, scalars, to_grid, from_grid, cuda_cores: bool = False) -> torch.Tensor:
    """The K3 kernel (at a bfloat16 x its bfloat16 instance): the
    tensor-core one where it takes the shapes (``s2_silu_sep_instance``),
    else the CUDA-core one; ``cuda_cores``: the CUDA-core one wherever it
    takes them (to time the two)."""
    global launches, launches_bf16
    E, I, C, G = _check_args(x, scalars, to_grid, from_grid)
    x, scalars, to_grid, from_grid = (build.aligned(t) for t in (x, scalars, to_grid, from_grid))
    out = torch.empty_like(x)
    if E == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    status = _fn("s2_silu_sep", 5, 6)(
        x.data_ptr(), scalars.data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(),
        out.data_ptr(), E, I, C, G, int(cuda_cores), int(bf16), build.stream_ptr(x))
    build.check(status, "s2_silu_sep")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def s2_silu_sep_bwd_cuda(x, scalars, to_grid, from_grid, g, cuda_cores: bool = False):
    """(dx, dscalars) from the K3b kernel, chosen as ``s2_silu_sep_cuda``
    chooses K3's."""
    global launches_bwd, launches_bwd_bf16
    E, I, C, G = _check_args(x, scalars, to_grid, from_grid)
    build.require(g, "g", (E, I, C), x.dtype, x.device)
    x, scalars, to_grid, from_grid, g = (build.aligned(t)
                                         for t in (x, scalars, to_grid, from_grid, g))
    dx = torch.empty_like(x)
    ds = torch.empty_like(scalars)
    if E == 0:
        return dx, ds
    bf16 = x.dtype == torch.bfloat16
    status = _fn("s2_silu_sep_bwd", 7, 6)(
        x.data_ptr(), scalars.data_ptr(), g.data_ptr(), to_grid.data_ptr(),
        from_grid.data_ptr(), dx.data_ptr(), ds.data_ptr(), E, I, C, G, int(cuda_cores),
        int(bf16), build.stream_ptr(x))
    build.check(status, "s2_silu_sep_bwd")
    if bf16:
        launches_bwd_bf16 += 1
    else:
        launches_bwd += 1
    return dx, ds


class S2SiluSep(torch.autograd.Function):
    """K3 forward and K3b backward. ``ctx`` keeps the inputs only; the
    backward recomputes the grid. ``to_grid``/``from_grid`` are constants
    and get no gradient, as in the JAX ``_sep_bwd``."""

    @staticmethod
    def forward(ctx, x, scalars, to_grid, from_grid):
        ctx.save_for_backward(x, scalars, to_grid, from_grid)
        if x.device.type == "cpu":
            return s2_silu_sep_plain(x, scalars, to_grid, from_grid)
        return s2_silu_sep_cuda(x, scalars, to_grid, from_grid)

    @staticmethod
    def backward(ctx, g):
        x, scalars, to_grid, from_grid = ctx.saved_tensors
        g = g.contiguous()
        if x.device.type == "cpu":
            dx, ds = s2_silu_sep_bwd_plain(x, scalars, to_grid, from_grid, g)
        else:
            dx, ds = s2_silu_sep_bwd_cuda(x, scalars, to_grid, from_grid, g)
        return dx, ds, None, None


def s2_silu_sep(x, scalars, to_grid, from_grid) -> torch.Tensor:
    """Plain versions for CPU tensors, the CUDA kernels for CUDA tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"s2_silu_sep runs on cpu or cuda, not {x.device}")
    return S2SiluSep.apply(x, scalars, to_grid, from_grid)


def s2_silu_plain(x: torch.Tensor, to_grid: torch.Tensor, from_grid: torch.Tensor) -> torch.Tensor:
    """x [N, I, C], to_grid/from_grid [G, I] -> [N, I, C]."""
    return torch.einsum("gi,ngc->nic", from_grid, F.silu(torch.einsum("gi,nic->ngc", to_grid, x)))


def s2_silu_bwd_plain(x, to_grid, from_grid, g):
    """dx of ``s2_silu_plain`` at cotangent ``g``."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        (dx,) = torch.autograd.grad(s2_silu_plain(x, to_grid, from_grid), (x,), g)
        return dx


def s2_silu_instance(I: int, C: int, G: int) -> str | None:
    """Which of K5's (and K5b's) kernels runs these shapes (any N):
    "tensor_cores", "cuda_cores", or None for a shape neither takes.
    Launches nothing."""
    fn = build.load("s2_act").s2_silu_instance
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return {1: "tensor_cores", 0: "cuda_cores"}.get(fn(I, C, G))


def silu_residency(I: int, C: int, G: int, bwd: bool = False) -> dict:
    """K5's tensor-core kernel (``bwd``: K5b's) at these shapes: resident
    blocks per SM (-1: shapes it does not take), threads and dynamic shared
    memory per block. For reports; launches nothing."""
    fn = build.load("s2_act").s2_silu_residency
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(I, C, G, int(bwd), ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def _check_silu_args(x, to_grid, from_grid):
    N, I, C = x.shape
    G = to_grid.shape[0]
    dev = x.device
    build.require(x, "x", (N, I, C), torch.float32, dev)
    build.require(to_grid, "to_grid", (G, I), torch.float32, dev)
    build.require(from_grid, "from_grid", (G, I), torch.float32, dev)
    return N, I, C, G


def s2_silu_cuda(x, to_grid, from_grid, cuda_cores: bool = False) -> torch.Tensor:
    """The K5 kernel: the tensor-core one where it takes the shapes
    (``s2_silu_instance``), else the CUDA-core one; ``cuda_cores``: the
    CUDA-core one wherever it takes them (to time the two)."""
    global launches_silu
    N, I, C, G = _check_silu_args(x, to_grid, from_grid)
    x, to_grid, from_grid = (build.aligned(t) for t in (x, to_grid, from_grid))
    out = torch.empty_like(x)
    if N * C == 0:
        return out
    status = _fn("s2_silu_f32", 4, 5)(
        x.data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(), out.data_ptr(), N, I, C, G,
        int(cuda_cores), build.stream_ptr(x),
    )
    build.check(status, "s2_silu")
    launches_silu += 1
    return out


def s2_silu_bwd_cuda(x, to_grid, from_grid, g, cuda_cores: bool = False) -> torch.Tensor:
    """dx from the K5b kernel, chosen as ``s2_silu_cuda`` chooses K5's."""
    global launches_silu_bwd
    N, I, C, G = _check_silu_args(x, to_grid, from_grid)
    build.require(g, "g", (N, I, C), torch.float32, x.device)
    x, to_grid, from_grid, g = (build.aligned(t) for t in (x, to_grid, from_grid, g))
    dx = torch.empty_like(x)
    if N * C == 0:
        return dx
    status = _fn("s2_silu_bwd_f32", 5, 5)(
        x.data_ptr(), g.data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(), dx.data_ptr(),
        N, I, C, G, int(cuda_cores), build.stream_ptr(x),
    )
    build.check(status, "s2_silu_bwd")
    launches_silu_bwd += 1
    return dx


class S2Silu(torch.autograd.Function):
    """K5 forward and K5b backward. ``ctx`` keeps the inputs only; the
    backward recomputes the grid. The grid matrices get no gradient, as in
    the JAX ``_bwd``."""

    @staticmethod
    def forward(ctx, x, to_grid, from_grid):
        ctx.save_for_backward(x, to_grid, from_grid)
        if x.device.type == "cpu":
            return s2_silu_plain(x, to_grid, from_grid)
        return s2_silu_cuda(x, to_grid, from_grid)

    @staticmethod
    def backward(ctx, g):
        x, to_grid, from_grid = ctx.saved_tensors
        g = g.contiguous()
        if x.device.type == "cpu":
            return s2_silu_bwd_plain(x, to_grid, from_grid, g), None, None
        return s2_silu_bwd_cuda(x, to_grid, from_grid, g), None, None


def s2_silu(x, to_grid, from_grid) -> torch.Tensor:
    """Plain versions for CPU tensors, the CUDA kernels for CUDA tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"s2_silu runs on cpu or cuda, not {x.device}")
    return S2Silu.apply(x, to_grid, from_grid)
