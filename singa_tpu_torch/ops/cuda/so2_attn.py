"""K6/K6b: the fused SO(2) edge-attention chain of every GraphAttention
under ``SINGA_TPU_FUSED_SO2``, and its backward.

K6 replaces ``singa_tpu/ops/pallas/so2_attn.py::so2_attn_fused``
(``_fwd_kernel``). Per edge: the edge-frame rotation
``D = J Z(-beta) J^T Z(-phi)`` of ``x`` to the m-primary truncated rows,
times the radial modulation ``rad``; the SO(2) convolution 1, one product
per m-primary section (``b1`` on section 0), giving the hidden ``h``
``[n_trunc, H]`` and the invariant ``extra`` channels; the separable S2
activation ``mid = from_grid . silu(to_grid . h)`` per hidden channel with
row 0 replaced by ``silu(extra[alpha_ch:])``; the SO(2) convolution 2 per
section (``b2`` on section 0). K6b replaces ``_bwd`` (``_bwd_kernel``):
``dx``, ``drad`` and the gradients of every conv weight and bias; ``phi``,
``beta`` and the grid matrices get none (positions are data).

Layouts are the JAX function's: ``x`` ``[E, (lmax+1)^2, c_in]`` l-primary,
``rad`` ``[E, n_trunc, c_in]`` m-primary, ``phi``/``beta`` ``[E]``, ``w1s``
the unpadded section weights ``[rows*c_in, rows*H (+extra on section 0)]``,
``b1`` ``[n0*H + extra]``, ``w2s`` ``[rows*H, rows*F2]``, ``b2``
``[n0*F2]``, ``to_grid``/``from_grid`` the m-primary ``[G, n_trunc]``
grids; the outputs are ``(z0, z1, z2, extra)``, ``z_s`` ``[E, rows_s*F2]``.
The TPU wrapper's 128-lane channel padding of conv 1, its edge padding and
its transposed weight copies exist for Mosaic and are not carried over.

``so2_attn`` goes through one ``torch.autograd.Function``: the plain
versions for CPU tensors, the CUDA kernels (``csrc/so2_attn.cu``,
``csrc/so2_attn_bwd.cu``) for CUDA tensors, no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from singa_tpu_torch.equivariant import so3
from singa_tpu_torch.ops.cuda import build
from singa_tpu_torch.ops.cuda.s2_act import s2_silu_sep_plain

launches = 0  # forward kernel launches through ``so2_attn``
launches_bwd = 0  # backward kernel launches through ``so2_attn``


def sections(lmax: int, mmax: int) -> list[int]:
    """Rows of each m-primary section: the m=0 rows, then the cos and sin
    rows of each m >= 1."""
    m_size = so3.CoefficientMapping(lmax, mmax).m_size
    return [m_size[0]] + [2 * s for s in m_size[1:]]


def so2_attn_plain(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
                   lmax: int, mmax: int, H: int, F2: int, alpha_ch: int):
    """The chain composed of the port's rotation, per-section products and
    K3's plain version; returns (z0, .., z_mmax, extra)."""
    secs = sections(lmax, mmax)
    n0 = secs[0]
    E, _, c_in = x.shape
    mp = so3.rotate(so3.EdgeFrame(phi=phi, beta=beta), x, lmax, mmax, m_primary=True)
    flat = (mp * rad).reshape(E, sum(secs) * c_in)
    ys, off = [], 0
    for w, rows in zip(w1s, secs):
        ys.append(flat[:, off : off + rows * c_in] @ w)
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
        zs.append(mid[:, off : off + rows * H] @ w)
        off += rows * H
    zs[0] = zs[0] + b2
    return (*zs, extra)


def so2_attn_bwd_plain(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                       lmax: int, mmax: int, H: int, F2: int, alpha_ch: int, *cts):
    """(dx, drad, *dw1s, db1, *dw2s, db2) of ``so2_attn_plain`` at the
    cotangents ``cts`` = (dz0, .., dz_mmax, dextra)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, rad, *w1s, b1, *w2s)]
        n1 = len(w1s)
        b2 = x.new_zeros((w2s[0].shape[1],), requires_grad=True)
        out = so2_attn_plain(leaves[0], leaves[1], phi, beta, leaves[2 : 2 + n1],
                             leaves[2 + n1], leaves[3 + n1 :], b2, to_grid, from_grid,
                             lmax, mmax, H, F2, alpha_ch)
        return torch.autograd.grad(out, (*leaves, b2), cts)


def _check_args(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid, lmax, mmax, H, F2):
    """Device, dtype, shape and contiguity of K6's and K6b's common
    arguments; returns (E, c_in, extra, G)."""
    E, _, c_in = x.shape
    secs = sections(lmax, mmax)
    n0, n_trunc = secs[0], sum(secs)
    extra = b1.shape[0] - n0 * H
    G = to_grid.shape[0]
    dev, f32 = x.device, torch.float32
    if len(w1s) != len(secs) or len(w2s) != len(secs):
        raise ValueError(f"{len(w1s)} / {len(w2s)} section weights, expected {len(secs)}")
    build.require(x, "x", (E, (lmax + 1) ** 2, c_in), f32, dev)
    build.require(rad, "rad", (E, n_trunc, c_in), f32, dev)
    build.require(phi, "phi", (E,), f32, dev)
    build.require(beta, "beta", (E,), f32, dev)
    for i, (w, rows) in enumerate(zip(w1s, secs)):
        build.require(w, f"w1s[{i}]", (rows * c_in, rows * H + (extra if i == 0 else 0)), f32, dev)
    build.require(b1, "b1", (n0 * H + extra,), f32, dev)
    for i, (w, rows) in enumerate(zip(w2s, secs)):
        build.require(w, f"w2s[{i}]", (rows * H, rows * F2), f32, dev)
    build.require(to_grid, "to_grid", (G, n_trunc), f32, dev)
    build.require(from_grid, "from_grid", (G, n_trunc), f32, dev)
    return E, c_in, extra, G


def _dims(E, lmax, mmax, c_in, H, F2, extra, alpha_ch, G):
    return [ctypes.c_int(v) for v in (E, lmax, mmax, c_in, H, F2, extra, alpha_ch, G)]


def _lib(name: str, n_ptr: int):
    """(``<name>_scratch_floats``, ``<name>_f32``) of ``csrc/<name>.cu``."""
    lib = build.load(name)
    scratch = getattr(lib, f"{name}_scratch_floats")
    scratch.argtypes = [ctypes.c_int] * 9
    scratch.restype = ctypes.c_longlong
    fn = getattr(lib, f"{name}_f32")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return scratch, fn


def gemm_residency() -> dict:
    """The chain's GEMM kernel (``csrc/so2_chain.cuh``) in each orientation
    it runs (NN: conv 1 and 2; NT: dmid, dmpr; TN: dw1, dw2): resident
    blocks per SM (-1: the card refused it), threads and dynamic shared
    memory per block. For reports; launches nothing."""
    fn = build.load("so2_attn").so2_gemm_residency
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out = {}
    for orient, name in enumerate(("nn", "nt", "tn")):
        smem, threads = ctypes.c_int(0), ctypes.c_int(0)
        per_sm = fn(orient, ctypes.byref(smem), ctypes.byref(threads))
        out[name] = {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}
    return out


def _rotation_blocks(lmax: int, mmax: int, device) -> torch.Tensor:
    """The block-diagonal J ``[(lmax+1)^2, (lmax+1)^2]``; the kernels read
    its diagonal blocks."""
    return so3.as_const(so3._JLayout(lmax, mmax).J, device)


def so2_attn_cuda(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
                  lmax: int, mmax: int, H: int, F2: int, alpha_ch: int):
    global launches
    E, c_in, extra, G = _check_args(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                                    lmax, mmax, H, F2)
    dev = x.device
    secs = sections(lmax, mmax)
    build.require(b2, "b2", (secs[0] * F2,), torch.float32, dev)
    x, rad, phi, beta, b1, b2, to_grid, from_grid = (
        build.aligned(t) for t in (x, rad, phi, beta, b1, b2, to_grid, from_grid))
    w1s, w2s = [build.aligned(w) for w in w1s], [build.aligned(w) for w in w2s]
    zs = [torch.empty((E, rows * F2), dtype=x.dtype, device=dev) for rows in secs]
    ext = torch.empty((E, extra), dtype=x.dtype, device=dev)
    if E == 0:
        return (*zs, ext)
    scratch_fn, fn = _lib("so2_attn", 20)
    dims = _dims(E, lmax, mmax, c_in, H, F2, extra, alpha_ch, G)
    n_scratch = scratch_fn(*dims)
    if n_scratch < 0:
        build.check(build.INVALID_VALUE, "so2_attn")
    scratch = torch.empty(n_scratch, dtype=x.dtype, device=dev)
    status = fn(
        x.data_ptr(), rad.data_ptr(), phi.data_ptr(), beta.data_ptr(),
        *[w.data_ptr() for w in w1s], b1.data_ptr(), *[w.data_ptr() for w in w2s], b2.data_ptr(),
        _rotation_blocks(lmax, mmax, dev).data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(),
        *[z.data_ptr() for z in zs], ext.data_ptr(), scratch.data_ptr(), *dims, build.stream_ptr(x),
    )
    build.check(status, "so2_attn")
    launches += 1
    return (*zs, ext)


def so2_attn_bwd_cuda(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                      lmax: int, mmax: int, H: int, F2: int, alpha_ch: int, *cts):
    """(dx, drad, *dw1s, db1, *dw2s, db2) from the K6b kernels."""
    global launches_bwd
    E, c_in, extra, G = _check_args(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                                    lmax, mmax, H, F2)
    dev = x.device
    secs = sections(lmax, mmax)
    if len(cts) != len(secs) + 1:
        raise ValueError(f"{len(cts)} cotangents, expected {len(secs) + 1}")
    for i, (dz, rows) in enumerate(zip(cts, secs)):
        build.require(dz, f"dz{i}", (E, rows * F2), torch.float32, dev)
    build.require(cts[-1], "dextra", (E, extra), torch.float32, dev)
    x, rad, phi, beta, b1, to_grid, from_grid = (
        build.aligned(t) for t in (x, rad, phi, beta, b1, to_grid, from_grid))
    w1s, w2s, cts = ([build.aligned(t) for t in ts] for ts in (w1s, w2s, cts))
    dx, drad = torch.empty_like(x), torch.empty_like(rad)
    shapes = ([tuple(w.shape) for w in w1s] + [tuple(b1.shape)]
              + [tuple(w.shape) for w in w2s] + [(secs[0] * F2,)])
    sizes = [torch.Size(s).numel() for s in shapes]
    grads = torch.empty(sum(sizes), dtype=x.dtype, device=dev)
    if E == 0:
        for out in (dx, drad, grads):
            out.zero_()
    else:
        scratch_fn, fn = _lib("so2_attn_bwd", 22)
        dims = _dims(E, lmax, mmax, c_in, H, F2, extra, alpha_ch, G)
        n_scratch = scratch_fn(*dims)
        if n_scratch < 0:
            build.check(build.INVALID_VALUE, "so2_attn_bwd")
        scratch = torch.empty(n_scratch, dtype=x.dtype, device=dev)
        status = fn(
            x.data_ptr(), rad.data_ptr(), phi.data_ptr(), beta.data_ptr(),
            *[w.data_ptr() for w in w1s], b1.data_ptr(), *[w.data_ptr() for w in w2s],
            _rotation_blocks(lmax, mmax, dev).data_ptr(), to_grid.data_ptr(),
            from_grid.data_ptr(), *[c.data_ptr() for c in cts], dx.data_ptr(), drad.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), *dims, build.stream_ptr(x),
        )
        build.check(status, "so2_attn_bwd")
        launches_bwd += 1
    parts = [g.view(s) for g, s in zip(torch.split(grads, sizes), shapes)]
    return (dx, drad, *parts)


class SO2Attn(torch.autograd.Function):
    """K6 forward and K6b backward. ``ctx`` keeps the inputs only, as
    ``_fwd`` does; the backward recomputes the chain up to ``mid``. ``phi``,
    ``beta`` and the grid matrices get no gradient, as in the JAX ``_bwd``.
    The section weights come flattened: ``n_sec`` conv-1 weights, ``b1``,
    ``n_sec`` conv-2 weights, ``b2``."""

    @staticmethod
    def forward(ctx, meta, x, rad, phi, beta, to_grid, from_grid, *weights):
        n = meta[0]
        w1s, b1, w2s, b2 = list(weights[:n]), weights[n], list(weights[n + 1 : 2 * n + 1]), weights[-1]
        ctx.meta = meta
        ctx.save_for_backward(x, rad, phi, beta, to_grid, from_grid, *weights[:-1])
        args = (x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid, *meta[1:])
        if x.device.type == "cpu":
            return so2_attn_plain(*args)
        return so2_attn_cuda(*args)

    @staticmethod
    def backward(ctx, *cts):
        n = ctx.meta[0]
        x, rad, phi, beta, to_grid, from_grid, *weights = ctx.saved_tensors
        w1s, b1, w2s = weights[:n], weights[n], weights[n + 1 :]
        cts = [c.contiguous() for c in cts]
        args = (x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid, *ctx.meta[1:], *cts)
        if x.device.type == "cpu":
            grads = so2_attn_bwd_plain(*args)
        else:
            grads = so2_attn_bwd_cuda(*args)
        return (None, grads[0], grads[1], None, None, None, None, *grads[2:])


def so2_attn(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
             lmax: int, mmax: int, H: int, F2: int, alpha_ch: int):
    """Plain versions for CPU tensors, the CUDA kernels for CUDA tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"so2_attn runs on cpu or cuda, not {x.device}")
    meta = (len(w1s), lmax, mmax, H, F2, alpha_ch)
    return SO2Attn.apply(meta, x, rad, phi, beta, to_grid, from_grid, *w1s, b1, *w2s, b2)
