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

K6·bf16 and K6b·bf16, the Pallas kernel's function at a bfloat16 ``x``
(``x``, ``rad``, the outputs, the cotangents, ``dx`` and ``drad``
bfloat16; the weights, biases, angles and grid matrices float32, the
weight and bias gradients float32), are the same stages at bfloat16
storage (the GEMM on bfloat16 ``mma.sync``, the grid stages on the tensor
cores, ``grid_residency``), counted in ``launches_bf16`` and
``launches_bwd_bf16``; ``so2_attn_bf16_plain`` and
``so2_attn_bwd_bf16_plain`` are their plain twins, which round where
``_fwd_kernel`` and ``_bwd_kernel`` round.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from singa_tpu_torch.dtypes import rounded
from singa_tpu_torch.equivariant import so3
from singa_tpu_torch.ops.cuda import build
from singa_tpu_torch.ops.cuda.s2_act import _silu_grad, s2_silu_sep_plain

launches = 0  # forward kernel launches through ``so2_attn``
launches_bwd = 0  # backward kernel launches through ``so2_attn``
launches_bf16 = 0  # its bfloat16 instance's forward launches (not in ``launches``)
launches_bwd_bf16 = 0  # its bfloat16 instance's backward launches


def sections(lmax: int, mmax: int) -> list[int]:
    """Rows of each m-primary section: the m=0 rows, then the cos and sin
    rows of each m >= 1."""
    m_size = so3.CoefficientMapping(lmax, mmax).m_size
    return [m_size[0]] + [2 * s for s in m_size[1:]]


def so2_attn_plain(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
                   lmax: int, mmax: int, H: int, F2: int, alpha_ch: int):
    """The chain composed of the port's rotation, per-section products and
    K3's plain version; returns (z0, .., z_mmax, extra). A bfloat16 ``x``
    takes the kernel's bfloat16 function (``so2_attn_bf16_plain``)."""
    if x.dtype == torch.bfloat16:
        return so2_attn_bf16_plain(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
                                   lmax, mmax, H, F2, alpha_ch)
    secs = sections(lmax, mmax)
    E, _, c_in = x.shape
    mp = so3.rotate(so3.EdgeFrame(phi=phi, beta=beta), x, lmax, mmax, m_primary=True)
    ys, h = _conv1((mp * rad).reshape(E, sum(secs) * c_in), w1s, b1, secs, H)
    extra = ys[0][:, secs[0] * H :]
    mid = s2_silu_sep_plain(h, extra[:, alpha_ch:], to_grid, from_grid).reshape(E, sum(secs) * H)
    return (*_conv2(mid, w2s, b2, secs, H), extra)


def _sections_of(t, secs, width: int):
    """The column blocks of ``t`` [E, sum(secs) * width], one a section."""
    out, off = [], 0
    for rows in secs:
        out.append(t[:, off : off + rows * width])
        off += rows * width
    return out


def _conv1(flat, w1s, b1, secs, H: int):
    """(ys, h): SO2 conv 1's section outputs of the m-primary message
    ``flat`` [E, n_trunc * c_in] (b1 on section 0) and their hidden rows
    [E, n_trunc, H]."""
    E, n0 = flat.shape[0], secs[0]
    ys = [f @ w for f, w in zip(_sections_of(flat, secs, flat.shape[1] // sum(secs)), w1s)]
    ys[0] = ys[0] + b1
    h = torch.cat([ys[0][:, : n0 * H].reshape(E, n0, H)]
                  + [y.reshape(E, rows, H) for y, rows in zip(ys[1:], secs[1:])], dim=1)
    return ys, h


def _conv2(mid, w2s, b2, secs, H: int):
    """SO2 conv 2's section outputs of ``mid`` [E, n_trunc * H] (b2 on
    section 0)."""
    zs = [m @ w for m, w in zip(_sections_of(mid, secs, H), w2s)]
    zs[0] = zs[0] + b2
    return zs


def so2_attn_bwd_plain(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                       lmax: int, mmax: int, H: int, F2: int, alpha_ch: int, *cts):
    """(dx, drad, *dw1s, db1, *dw2s, db2) of ``so2_attn_plain`` at the
    cotangents ``cts`` = (dz0, .., dz_mmax, dextra); at a bfloat16 ``x``,
    ``so2_attn_bwd_bf16_plain``."""
    if x.dtype == torch.bfloat16:
        return so2_attn_bwd_bf16_plain(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                                       lmax, mmax, H, F2, alpha_ch, *cts)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, rad, *w1s, b1, *w2s)]
        n1 = len(w1s)
        b2 = x.new_zeros((w2s[0].shape[1],), requires_grad=True)
        out = so2_attn_plain(leaves[0], leaves[1], phi, beta, leaves[2 : 2 + n1],
                             leaves[2 + n1], leaves[3 + n1 :], b2, to_grid, from_grid,
                             lmax, mmax, H, F2, alpha_ch)
        return torch.autograd.grad(out, (*leaves, b2), cts)


def _rotation_mats(lmax: int, mmax: int, device, dt):
    """The Pallas kernel's rotation constants rounded to ``dt`` as it rounds
    them, float32 storage: J^T, J^T FLIP, the kept rows of J (m-primary)
    and those times FLIP; and the signed m of every coefficient."""
    lay = so3._JLayout(lmax, mmax)
    jt, jk = lay.J.T, lay.J_kept_m
    mats = [rounded(torch.as_tensor(a, device=device), dt)
            for a in (jt, jt[:, lay.flip], jk, jk[:, lay.flip])]
    return mats, so3.as_const(lay.m_of, device)


def _rot_tables(phi, beta, m_of):
    """cos and sin of m(-phi) and m(-beta) [E, (lmax+1)^2], float32."""
    ap, ab = m_of[None] * (-phi)[:, None], m_of[None] * (-beta)[:, None]
    return torch.cos(ap), torch.sin(ap), torch.cos(ab), torch.sin(ab)


def _rotate_bf16(x, tabs, mats, dt):
    """``_rotate_fwd``: x [E, (lmax+1)^2, C] (float32 of bfloat16 values)
    -> the float32 edge-frame message [E, n_trunc, C]; x cos and x sin
    rounded apart before J^T, each z(-beta) term rounded before J_kept."""
    cmp_, smp, cmb, smb = tabs
    jt, jtf, jk, jkf = mats
    t = rounded(x * cmp_[:, :, None], dt)
    s = rounded(x * smp[:, :, None], dt)
    t2 = torch.einsum("eic,ai->eca", t, jt) + torch.einsum("eic,ai->eca", s, jtf)
    u = rounded(t2 * cmb[:, None, :], dt)
    v = rounded(t2 * smb[:, None, :], dt)
    mp = torch.einsum("eca,oa->eco", u, jk) + torch.einsum("eca,oa->eco", v, jkf)
    return mp.transpose(1, 2)


def _conv1_bf16(x, rad, tabs, mats, w1s, b1, secs, H, dt):
    """(mp0, flat, ys, h): the float32 rotated message, its modulation by
    ``rad`` rounded (conv 1's input, flat [E, n_trunc * C]), conv 1's
    float32 section outputs (b1 on section 0) and its hidden rows
    [E, n_trunc, H]."""
    mp0 = _rotate_bf16(x.float(), tabs, mats, dt)
    flat = rounded(mp0 * rad.float(), dt).flatten(1)
    ys, h = _conv1(flat, [rounded(w, dt) for w in w1s], b1, secs, H)
    return mp0, flat, ys, h


def _s2_bf16(h, gate_in, tg, fg, dt):
    """(grid, mid): the separable S2 activation of the hidden rows ``h``
    [E, n_trunc, H] as ``_fwd_kernel`` forms it at bfloat16, the grid
    [E, H, G] from the rounded hidden (float32), silu of it rounded, mid
    with row 0 the gate silu(gate_in) (float32), rounded."""
    grid = torch.einsum("eih,gi->ehg", rounded(h, dt), tg)
    mid = torch.einsum("ehg,gi->eih", rounded(F.silu(grid), dt), fg)
    return grid, rounded(torch.cat([F.silu(gate_in)[:, None], mid[:, 1:]], dim=1), dt)


def so2_attn_bf16_plain(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
                        lmax: int, mmax: int, H: int, F2: int, alpha_ch: int):
    """K6·bf16 in plain PyTorch, rounding where ``_fwd_kernel`` rounds at a
    bfloat16 ``x`` (float32 weights, biases, angles and grids, as the model
    passes them): the rotation constants, the grids and the weights
    rounded; the rotation as ``_rotate_bf16``; the modulated message
    rounded once; conv 1 summed in float32 plus b1; the S2 activation as
    ``_s2_bf16``, its gate silu(extra[alpha_ch:]) from conv 1's float32
    output; conv 2 summed in float32 plus b2; z and extra rounded once.
    Every product sums in float32."""
    dt = x.dtype
    secs = sections(lmax, mmax)
    n0 = secs[0]
    mats, m_of = _rotation_mats(lmax, mmax, x.device, dt)
    tabs = _rot_tables(phi, beta, m_of)
    tg, fg = rounded(to_grid, dt), rounded(from_grid, dt)
    _, _, ys, h = _conv1_bf16(x, rad, tabs, mats, w1s, b1, secs, H, dt)
    extra = ys[0][:, n0 * H :]
    _, mid = _s2_bf16(h, extra[:, alpha_ch:], tg, fg, dt)
    zs = _conv2(mid.flatten(1), [rounded(w, dt) for w in w2s], b2, secs, H)
    return (*(z.to(dt) for z in zs), extra.to(dt))


def so2_attn_bwd_bf16_plain(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                            lmax: int, mmax: int, H: int, F2: int, alpha_ch: int, *cts):
    """K6b·bf16 in plain PyTorch, written out as ``_bwd_kernel`` is (not
    the autograd of the rounded forward): the forward recomputed up to mid
    as ``so2_attn_bf16_plain`` (the rotated message mp0 kept in float32);
    dmid = dz w2^T in float32, dgate = silu'(gate) dmid[0] from its float32
    row 0, then the row zeroed and dmid rounded; silu'(grid) times the
    lifted cotangent rounded; dh in float32; dy = [dh | dextra + dgate]
    summed unrounded into db1 and db2 = sum dz0, then rounded for the
    products; dw1 = flat^T dy and dw2 = mid^T dz summed in float32 and
    returned float32; drad = dmpr mp0 rounded once; the rotation's
    transpose rounds dmpr rad before J_kept^T and the z(-beta)^T term
    before J, and dx once. dx and drad bfloat16, the rest float32."""
    dt = x.dtype
    E = x.shape[0]
    secs = sections(lmax, mmax)
    n0 = secs[0]
    mats, m_of = _rotation_mats(lmax, mmax, x.device, dt)
    cmp_, smp, cmb, smb = tabs = _rot_tables(phi, beta, m_of)
    jt, jtf, jk, jkf = mats
    tg, fg = rounded(to_grid, dt), rounded(from_grid, dt)
    mp0, flat, ys, h = _conv1_bf16(x, rad, tabs, mats, w1s, b1, secs, H, dt)
    gate_in = ys[0][:, n0 * H + alpha_ch :]
    grid, mid = _s2_bf16(h, gate_in, tg, fg, dt)

    dzs = [c.float() for c in cts[:-1]]
    dw2s = [m.t() @ dz for m, dz in zip(_sections_of(mid.flatten(1), secs, H), dzs)]
    dmid = torch.cat([dz @ rounded(w, dt).t() for dz, w in zip(dzs, w2s)], dim=1)
    dmid = dmid.reshape(E, sum(secs), H)
    dgate = dmid[:, 0] * _silu_grad(gate_in)
    dmid = rounded(torch.cat([torch.zeros_like(dmid[:, :1]), dmid[:, 1:]], dim=1), dt)
    dgrid = rounded(_silu_grad(grid) * torch.einsum("eih,gi->ehg", dmid, fg), dt)
    dh = torch.einsum("ehg,gi->eih", dgrid, tg)
    dextra = cts[-1].float() + F.pad(dgate, (alpha_ch, 0))
    dys = [torch.cat([dh[:, :n0].flatten(1), dextra], dim=1)]
    dys += [d.flatten(1) for d in torch.split(dh[:, n0:], secs[1:], dim=1)]
    db1 = dys[0].sum(0)
    dys = [rounded(d, dt) for d in dys]
    c_in = x.shape[2]
    dw1s = [f.t() @ d for f, d in zip(_sections_of(flat, secs, c_in), dys)]
    dmod = torch.cat([d @ rounded(w, dt).t() for d, w in zip(dys, w1s)], dim=1)
    dmod = dmod.reshape(E, sum(secs), c_in)
    drad = (dmod * mp0).to(dt)
    # _rotate_bwd on dmpT = (dmod * rad)^T [E, C, n_trunc]
    dmpT = rounded((dmod * rad.float()).transpose(1, 2), dt)
    du = torch.einsum("eco,oa->eca", dmpT, jk)
    dv = torch.einsum("eco,oa->eca", dmpT, jkf)
    dt2 = rounded(du * cmb[:, None, :] + dv * smb[:, None, :], dt)
    dxT = (torch.einsum("eca,ai->eci", dt2, jt) * cmp_[:, None, :]
           + torch.einsum("eca,ai->eci", dt2, jtf) * smp[:, None, :])
    return (dxT.transpose(1, 2).to(dt), drad, *dw1s, db1, *dw2s, dzs[0].sum(0))


def _check_args(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid, lmax, mmax, H, F2):
    """Device, dtype, shape and contiguity of K6's and K6b's common
    arguments (``x`` and ``rad`` float32, or bfloat16 for K6·bf16 and
    K6b·bf16; the rest float32); returns (E, c_in, extra, G)."""
    E, _, c_in = x.shape
    secs = sections(lmax, mmax)
    n0, n_trunc = secs[0], sum(secs)
    extra = b1.shape[0] - n0 * H
    G = to_grid.shape[0]
    dev, f32 = x.device, torch.float32
    act = torch.bfloat16 if x.dtype == torch.bfloat16 else f32
    if len(w1s) != len(secs) or len(w2s) != len(secs):
        raise ValueError(f"{len(w1s)} / {len(w2s)} section weights, expected {len(secs)}")
    build.require(x, "x", (E, (lmax + 1) ** 2, c_in), act, dev)
    build.require(rad, "rad", (E, n_trunc, c_in), act, dev)
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


def _lib(name: str, n_ptr: int, bf16: bool):
    """(``<name>_scratch_floats``, ``<name>_f32``) of ``csrc/<name>.cu``;
    ``bf16``: (``<name>_bf16_scratch_bytes``, ``<name>_bf16``)."""
    lib = build.load(name)
    scratch = getattr(lib, f"{name}_bf16_scratch_bytes" if bf16 else f"{name}_scratch_floats")
    scratch.argtypes = [ctypes.c_int] * 9
    scratch.restype = ctypes.c_longlong
    fn = getattr(lib, f"{name}_bf16" if bf16 else f"{name}_f32")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return scratch, fn


def _scratch(lib: str, n_ptr: int, dims, x):
    """The kernel entry of ``lib`` at ``x``'s dtype and its scratch (float32
    elements, or bytes for the bfloat16 instance)."""
    bf16 = x.dtype == torch.bfloat16
    scratch_fn, fn = _lib(lib, n_ptr, bf16)
    n = scratch_fn(*dims)
    if n < 0:
        build.check(build.INVALID_VALUE, lib)
    return fn, torch.empty(n, dtype=torch.uint8 if bf16 else torch.float32, device=x.device)


def gemm_residency(bf16: bool = False) -> dict:
    """The chain's GEMM kernel (``csrc/so2_chain.cuh``) in each orientation
    it runs (NN: conv 1 and 2; NT: dmid, dmpr; TN: dw1, dw2; ``bf16``: its
    instance on bfloat16 operands, K6·bf16's and K6b·bf16's): resident
    blocks per SM (-1: the card refused it), threads and dynamic shared
    memory per block. For reports; launches nothing."""
    lib = build.load("so2_attn")
    fn = lib.so2_gemm_bf16_residency if bf16 else lib.so2_gemm_residency
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out = {}
    for orient, name in enumerate(("nn", "nt", "tn")):
        smem, threads = ctypes.c_int(0), ctypes.c_int(0)
        per_sm = fn(orient, ctypes.byref(smem), ctypes.byref(threads))
        out[name] = {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}
    return out


def grid_residency(lmax: int, mmax: int, C: int, H: int, F2: int, alpha_ch: int, G: int,
                   bwd: bool = False) -> dict:
    """K6·bf16's grid stage on the tensor cores (``bwd``: K6b·bf16's
    backward one; ``csrc/so2_chain.cuh``) at these widths: resident blocks
    per SM (-1: a shape it does not take), threads and dynamic shared
    memory per block. For reports; launches nothing."""
    lib = build.load("so2_attn_bwd" if bwd else "so2_attn")
    fn = lib.so2_grid_bwd_bf16_residency if bwd else lib.so2_grid_bf16_residency
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(lmax, mmax, C, H, F2, alpha_ch + H, alpha_ch, G, ctypes.byref(smem),
                ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def _rotation_blocks(lmax: int, mmax: int, device) -> torch.Tensor:
    """The block-diagonal J ``[(lmax+1)^2, (lmax+1)^2]``; the kernels read
    its diagonal blocks."""
    return so3.as_const(so3._JLayout(lmax, mmax).J, device)


def so2_attn_cuda(x, rad, phi, beta, w1s, b1, w2s, b2, to_grid, from_grid,
                  lmax: int, mmax: int, H: int, F2: int, alpha_ch: int):
    """The K6 kernels (at a bfloat16 ``x`` and ``rad``, K6·bf16: bfloat16
    outputs); arguments and result as ``so2_attn_plain``."""
    global launches, launches_bf16
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
    dims = _dims(E, lmax, mmax, c_in, H, F2, extra, alpha_ch, G)
    fn, scratch = _scratch("so2_attn", 20, dims, x)
    status = fn(
        x.data_ptr(), rad.data_ptr(), phi.data_ptr(), beta.data_ptr(),
        *[w.data_ptr() for w in w1s], b1.data_ptr(), *[w.data_ptr() for w in w2s], b2.data_ptr(),
        _rotation_blocks(lmax, mmax, dev).data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(),
        *[z.data_ptr() for z in zs], ext.data_ptr(), scratch.data_ptr(), *dims, build.stream_ptr(x),
    )
    build.check(status, "so2_attn")
    if x.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return (*zs, ext)


def so2_attn_bwd_cuda(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                      lmax: int, mmax: int, H: int, F2: int, alpha_ch: int, *cts):
    """(dx, drad, *dw1s, db1, *dw2s, db2) from the K6b kernels (at a
    bfloat16 ``x``, K6b·bf16: ``rad``, the cotangents, dx and drad
    bfloat16, the weight and bias gradients float32)."""
    global launches_bwd, launches_bwd_bf16
    E, c_in, extra, G = _check_args(x, rad, phi, beta, w1s, b1, w2s, to_grid, from_grid,
                                    lmax, mmax, H, F2)
    dev = x.device
    secs = sections(lmax, mmax)
    if len(cts) != len(secs) + 1:
        raise ValueError(f"{len(cts)} cotangents, expected {len(secs) + 1}")
    for i, (dz, rows) in enumerate(zip(cts, secs)):
        build.require(dz, f"dz{i}", (E, rows * F2), x.dtype, dev)
    build.require(cts[-1], "dextra", (E, extra), x.dtype, dev)
    x, rad, phi, beta, b1, to_grid, from_grid = (
        build.aligned(t) for t in (x, rad, phi, beta, b1, to_grid, from_grid))
    w1s, w2s, cts = ([build.aligned(t) for t in ts] for ts in (w1s, w2s, cts))
    dx, drad = torch.empty_like(x), torch.empty_like(rad)
    shapes = ([tuple(w.shape) for w in w1s] + [tuple(b1.shape)]
              + [tuple(w.shape) for w in w2s] + [(secs[0] * F2,)])
    sizes = [torch.Size(s).numel() for s in shapes]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    if E == 0:
        for out in (dx, drad, grads):
            out.zero_()
    else:
        dims = _dims(E, lmax, mmax, c_in, H, F2, extra, alpha_ch, G)
        fn, scratch = _scratch("so2_attn_bwd", 22, dims, x)
        status = fn(
            x.data_ptr(), rad.data_ptr(), phi.data_ptr(), beta.data_ptr(),
            *[w.data_ptr() for w in w1s], b1.data_ptr(), *[w.data_ptr() for w in w2s],
            _rotation_blocks(lmax, mmax, dev).data_ptr(), to_grid.data_ptr(),
            from_grid.data_ptr(), *[c.data_ptr() for c in cts], dx.data_ptr(), drad.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), *dims, build.stream_ptr(x),
        )
        build.check(status, "so2_attn_bwd")
        if x.dtype == torch.bfloat16:
            launches_bwd_bf16 += 1
        else:
            launches_bwd += 1
    parts = [g.view(s) for g, s in zip(torch.split(grads, sizes), shapes)]
    return (dx, drad, *parts)


class SO2Attn(torch.autograd.Function):
    """K6 forward and K6b backward (at a bfloat16 ``x``, K6·bf16 and
    K6b·bf16 or their twins). ``ctx`` keeps the inputs only, as ``_fwd``
    does; the backward recomputes the chain up to ``mid``. ``phi``,
    ``beta`` and the grid matrices get no gradient, as in the JAX ``_bwd``.
    The section weights come flattened: ``n_sec`` conv-1 weights, ``b1``,
    ``n_sec`` conv-2 weights, ``b2``; they stay the float32 parameters (the
    kernels and twins round them), so their gradients are float32."""

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
