"""K2/K2b and K4/K4b: the feed-forward network of every TransBlock, under the
gate activation and under the S2 activation, and their backwards.

K2 replaces ``singa_tpu/ops/pallas/so3_ffn.py::so3_gate_ffn_fused`` (forward,
``_gate_ffn_fwd_kernel``): per-degree linear C -> H; row l=0 becomes
``silu(h + b1)``, rows of degree l >= 1 become ``h * sigmoid(x0 @ wg + bg)``
over column block ``(l-1)H : lH``; per-degree linear H -> Co, ``b2`` on row 0
only. K2b replaces ``_gate_bwd`` (``_gate_ffn_bwd_kernel``): dx and the six
weight and bias gradients. The CUDA kernels (``csrc/so3_gate_ffn.cu``,
``csrc/so3_gate_ffn_bwd.cu``) keep the ``[N, I, H]`` hidden and its cotangent
out of device memory. K2's tensor-core kernel forms h, the gates and y,
K2b's dx kernel h, dmid, dx and the row-0 gate term, and its weight-gradient
kernel h, dmid, dw1 and dw2, on the tensor cores as split-TF32 products
(``csrc/mma_tf32.cuh``, ``csrc/gate_ffn_tc.cuh``), which agree with float32
products to float32 round-off; all take C and Co of 8 or 16. Every other
shape K2 took before runs its CUDA-core instance (``so3_gate_ffn_instance``
says which).

K4 replaces ``so3_ffn.py::so3_ffn_fused`` (``_ffn_fwd_kernel``), the FFN of
``ffn_activation: s2``: ``gate = silu(x0 @ wg + bg)``; per-degree linear
C -> H with ``b1`` on row 0; ``mid = from_grid . silu(to_grid . h)`` per
hidden channel, row 0 replaced by ``gate``; per-degree linear H -> Co, ``b2``
on row 0. K4b replaces ``_bwd`` (``_ffn_bwd_kernel``): dx and the six weight
and bias gradients; ``b1`` reaches every output row through the grid. The
CUDA kernels (``csrc/so3_ffn.cu``, ``csrc/so3_ffn_bwd.cu``) keep the hidden
and the ``[N, G, H]`` grid out of device memory. K4 forms its two grid
transforms and both per-degree products, and K4b its four grid transforms,
on the tensor cores as split-TF32 products (``csrc/mma_tf32.cuh``), which
agree with float32 products to float32 round-off; K4's tensor-core kernel
takes lmax <= 6 and C, Co <= 16, and every other shape it took before runs
its CUDA-core instance (``s2_fwd_instance`` says which). The TPU kernel's
L-padded coefficient layout, 128-wide hidden chunks, node padding,
transposed weight copies and tanh-form sigmoid exist for Mosaic and are not
carried over.

K2b also keeps the CUDA-core instance it had before its tensor-core
kernels (``so3_gate_ffn_bwd_cc`` in ``csrc/so3_gate_ffn_bwd.cu``), chosen
by shape before the launch (``so3_gate_ffn_bwd_instance``): it runs the
widths the tensor-core kernels refuse (32 sphere channels; lmax 7 at 16
channels), at either dtype.

K2 and K2b have bfloat16 instances (the bfloat16 training path's), at a
bfloat16 x and y (dy and dx), the weights and biases float32, counted in
``launches_bf16`` and ``launches_bwd_bf16``: each is its tensor-core
kernels at bfloat16 storage (K2's product kernel and weight split; K2b's
dx, weight and split kernels), one TF32 product where float32 takes three
(a bfloat16 value is a TF32 value), at the widths they take, else its
CUDA-core instance; ``cuda_cores`` as at float32. They are
the function ``_gate_ffn_fwd_kernel`` and ``_gate_ffn_bwd_kernel`` compute
at a bfloat16 x and round where those round: w1, wg and w2 cast to
bfloat16 (the biases not); every product summed in float32; the gates
``sigmoid(x0 wg + bg)`` rounded where they scale h and dmid (float32 in
sigmoid'); the hidden after its activation rounded before the second
product; dh rounded before dx and dw1 (db1 sums it unrounded); dg0
rounded; y and dx rounded once. The six weight and bias gradients are
float32, as in JAX. ``so3_gate_ffn_bf16_plain`` and
``so3_gate_ffn_bf16_bwd_plain`` are their plain twins.

K4 and K4b have bfloat16 instances too, at a bfloat16 x, dy and grid
matrices (as the module passes them, and the Pallas kernel casts them to
x.dtype), y and dx bfloat16, the weights and biases and the six weight
and bias gradients float32, counted in ``launches_s2_bf16`` and
``launches_s2_bwd_bf16``: K4's bfloat16 kernel and its weight kernel
(``ffn_fwd_bf16_kernel``, ``ffn_wfrag_bf16_kernel``: h, the grid chain and
y on bfloat16 m16n8k16 ``mma.sync``, no barrier inside the chain) and
K4b's (``ffn_bwd_bf16_kernel``: its grid chain on bfloat16 m16n8k16
``mma.sync``, no barrier inside it), at lmax 1..6 and C, Co multiples of
4 up to 16; no CUDA-core instance runs bfloat16, so any other width
raises.
They round where ``_ffn_fwd_kernel`` and ``_ffn_bwd_kernel`` round:
``so3_ffn_bf16_plain`` and ``so3_ffn_bf16_bwd_plain`` are their plain
twins (``s2_bf16_takes`` says which widths, for the trainer's choice of
precision, which is made without the card).

``so3_gate_ffn`` and ``so3_ffn`` each go through one
``torch.autograd.Function``: plain versions for CPU tensors, the kernels for
CUDA tensors. Each kernel's C entry point refuses a shape it does not take
(``build.check`` raises).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch.dtypes import rounded
from singa_tpu_torch.ops.cuda import build

launches = 0  # forward kernel launches through ``so3_gate_ffn``
launches_bwd = 0  # backward kernel launches through ``so3_gate_ffn``
launches_bf16 = 0  # its bfloat16 instance's forward launches (not in ``launches``)
launches_bwd_bf16 = 0  # its bfloat16 instance's backward launches
launches_s2 = 0  # forward kernel launches through ``so3_ffn``
launches_s2_bwd = 0  # backward kernel launches through ``so3_ffn``
launches_s2_bf16 = 0  # its bfloat16 instance's forward launches (not in ``launches_s2``)
launches_s2_bwd_bf16 = 0  # its bfloat16 instance's backward launches


def s2_bf16_takes(lmax: int, C: int, Co: int) -> bool:
    """Whether K4's and K4b's bfloat16 instances take an s2 FFN of these
    widths: lmax 1..6 and C, Co multiples of 4 up to 16 (what the C entry
    points take at bfloat16; they refuse the rest themselves). The trainer
    reads it to choose its precision before it launches anything."""
    return 1 <= lmax <= 6 and all(4 <= c <= 16 and c % 4 == 0 for c in (C, Co))


def _l_of(lmax: int, device) -> torch.Tensor:
    l_of = np.asarray([l for l in range(lmax + 1) for _ in range(2 * l + 1)])
    return torch.as_tensor(l_of, dtype=torch.long, device=device)


def so3_gate_ffn_plain(x, w1, b1, wg, bg, w2, b2, lmax: int) -> torch.Tensor:
    """x [N, I, C]; w1 [L, C, H]; b1 [H]; wg [C, lmax*H]; bg [lmax*H];
    w2 [L, H, Co]; b2 [Co] -> [N, I, Co]. A bfloat16 ``x`` takes the
    kernel's bfloat16 function (``so3_gate_ffn_bf16_plain``)."""
    if x.dtype == torch.bfloat16:
        return so3_gate_ffn_bf16_plain(x, w1, b1, wg, bg, w2, b2, lmax)
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


def so3_gate_ffn_bf16_plain(x, w1, b1, wg, bg, w2, b2, lmax: int) -> torch.Tensor:
    """K2's bfloat16 instance in plain PyTorch, rounding where
    ``_gate_ffn_fwd_kernel`` rounds at a bfloat16 ``x``: w1, wg and w2 cast
    to bfloat16 (the biases stay float32), products summed in float32, the
    gates ``sigmoid(x0 wg + bg)`` rounded, the hidden after its activation
    rounded before the second product, the output rounded."""
    dt = x.dtype
    N = x.shape[0]
    H = w1.shape[2]
    l_of = _l_of(lmax, x.device)
    xf = x.float()
    gates = rounded(torch.sigmoid(xf[:, 0, :] @ rounded(wg, dt) + bg), dt).reshape(N, lmax, H)
    h = torch.einsum("nic,ich->nih", xf, rounded(w1, dt).index_select(0, l_of))
    mid = torch.cat(
        [F.silu(h[:, :1] + b1), h[:, 1:] * gates.index_select(1, l_of[1:] - 1)], dim=1
    )
    y = torch.einsum("nih,iho->nio", rounded(mid, dt), rounded(w2, dt).index_select(0, l_of))
    return torch.cat([y[:, :1] + b2, y[:, 1:]], dim=1).to(dt)


def so3_gate_ffn_bwd_plain(x, w1, b1, wg, bg, w2, lmax: int, dy):
    """(dx, dw1, db1, dwg, dbg, dw2, db2) of ``so3_gate_ffn_plain`` at
    cotangent ``dy``; at a bfloat16 ``x``, ``so3_gate_ffn_bf16_bwd_plain``."""
    if x.dtype == torch.bfloat16:
        return so3_gate_ffn_bf16_bwd_plain(x, w1, b1, wg, bg, w2, lmax, dy)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, w1, b1, wg, bg, w2)]
        b2 = x.new_zeros((w2.shape[2],), requires_grad=True)
        y = so3_gate_ffn_plain(*leaves, b2, lmax)
        return torch.autograd.grad(y, (*leaves, b2), dy)


def so3_gate_ffn_bf16_bwd_plain(x, w1, b1, wg, bg, w2, lmax: int, dy):
    """K2b's bfloat16 instance in plain PyTorch, rounding where
    ``_gate_ffn_bwd_kernel`` rounds: the weights cast to bfloat16; h and
    dmid = dy w2^T in float32; the gates rounded where they scale h and
    dmid, but float32 in sigmoid'; mid and dh rounded before their products
    (db1 sums dh unrounded); dg0 rounded. dx is bfloat16, the six weight and
    bias gradients float32."""
    dt = x.dtype
    N = x.shape[0]
    L, _, H = w1.shape
    l_of = _l_of(lmax, x.device)
    xf, dyf = x.float(), dy.float()
    w1e = rounded(w1, dt).index_select(0, l_of)  # [I, C, H]
    w2e = rounded(w2, dt).index_select(0, l_of)  # [I, H, Co]
    wgr = rounded(wg, dt)
    x0 = xf[:, 0, :]
    gf = torch.sigmoid(x0 @ wgr + bg)  # [N, lmax*H] float32
    g_rows = rounded(gf, dt).reshape(N, lmax, H).index_select(1, l_of[1:] - 1)
    h = torch.einsum("nic,ich->nih", xf, w1e)
    dmid = torch.einsum("nio,iho->nih", dyf, w2e)
    hb = h[:, 0] + b1
    s = torch.sigmoid(hb)
    mid = rounded(torch.cat([F.silu(hb)[:, None], h[:, 1:] * g_rows], dim=1), dt)
    dh = torch.cat([(s * (1.0 + hb * (1.0 - s)) * dmid[:, 0])[:, None], dmid[:, 1:] * g_rows],
                   dim=1)
    dgates = torch.zeros((N, lmax, H), device=x.device).index_add_(
        1, l_of[1:] - 1, dmid[:, 1:] * h[:, 1:])
    dg0 = rounded(gf * (1.0 - gf) * dgates.reshape(N, lmax * H), dt)
    dhc = rounded(dh, dt)
    dw1 = torch.zeros_like(w1).index_add_(0, l_of, torch.einsum("nic,nih->ich", xf, dhc))
    dw2 = torch.zeros_like(w2).index_add_(0, l_of, torch.einsum("nih,nio->iho", mid, dyf))
    dx = torch.einsum("nih,ich->nic", dhc, w1e)
    dx = torch.cat([dx[:, :1] + (dg0 @ wgr.t())[:, None], dx[:, 1:]], dim=1)
    return (dx.to(dt), dw1, dh[:, 0].sum(0), x0.t() @ dg0, dg0.sum(0), dw2,
            dyf[:, 0].sum(0))


def _fns():
    """(words, launch) of K2's C entry points."""
    lib = build.load("so3_gate_ffn")
    words = lib.so3_gate_ffn_words
    words.argtypes = [ctypes.c_int] * 5
    words.restype = ctypes.c_longlong
    fn = lib.so3_gate_ffn
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return words, fn


def so3_gate_ffn_instance(lmax: int, C: int, H: int, Co: int) -> str | None:
    """Which of K2's kernels runs these widths (any N): "tensor_cores",
    "cuda_cores", or None for a shape neither takes. Launches nothing."""
    fn = build.load("so3_gate_ffn").so3_gate_ffn_instance
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return {1: "tensor_cores", 0: "cuda_cores"}.get(fn(lmax, C, H, Co))


def gate_fwd_residency(lmax: int, C: int, H: int, Co: int, bf16: bool = False) -> dict:
    """K2's tensor-core kernel at these widths (``bf16``: its bfloat16
    instance): resident blocks per SM (-1: a shape it does not take),
    threads and dynamic shared memory per block. For reports; launches
    nothing."""
    fn = build.load("so3_gate_ffn").so3_gate_ffn_residency
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(lmax, C, H, Co, int(bf16), ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def _bwd_fns():
    lib = build.load("so3_gate_ffn_bwd")
    slices = lib.so3_gate_ffn_bwd_slices
    slices.argtypes = [ctypes.c_int] * 6
    slices.restype = ctypes.c_int
    words = lib.so3_gate_ffn_bwd_dx_words
    words.argtypes = [ctypes.c_int] * 5
    words.restype = ctypes.c_longlong
    fn = lib.so3_gate_ffn_bwd_tc
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return slices, words, fn


def gate_bwd_residency(lmax: int, C: int, H: int, Co: int, dx: bool = False,
                       bf16: bool = False) -> dict:
    """K2b's weight-gradient kernel (``dx``: its dx kernel; ``bf16``: its
    bfloat16 instance) at these widths: resident blocks per SM (-1: a shape
    it does not take), threads and dynamic shared memory per block. For
    reports; launches nothing."""
    fn = build.load("so3_gate_ffn_bwd").so3_gate_ffn_bwd_residency
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(lmax, C, H, Co, int(dx), int(bf16), ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def so3_gate_ffn_cuda(x, w1, b1, wg, bg, w2, b2, lmax: int,
                      cuda_cores: bool = False) -> torch.Tensor:
    """The K2 kernels (at a bfloat16 x its bfloat16 instance); arguments and
    result as ``so3_gate_ffn_plain``. The tensor-core kernel runs where it
    takes the widths (``so3_gate_ffn_instance``, at either dtype), else the
    CUDA-core one; ``cuda_cores``: the CUDA-core one wherever it takes them
    (to time the two)."""
    global launches, launches_bf16
    N, I, C = x.shape
    L = lmax + 1
    H = w1.shape[2]
    Co = w2.shape[2]
    dev = x.device
    if I != L * L:
        raise ValueError(f"x has {I} coefficient rows, expected {(L * L)} at lmax {lmax}")
    bf16 = x.dtype == torch.bfloat16
    build.require(x, "x", (N, I, C), torch.bfloat16 if bf16 else torch.float32, dev)
    build.require(w1, "w1", (L, C, H), torch.float32, dev)
    build.require(b1, "b1", (H,), torch.float32, dev)
    build.require(wg, "wg", (C, lmax * H), torch.float32, dev)
    build.require(bg, "bg", (lmax * H,), torch.float32, dev)
    build.require(w2, "w2", (L, H, Co), torch.float32, dev)
    build.require(b2, "b2", (Co,), torch.float32, dev)
    x, w1, b1, wg, bg, w2, b2 = (build.aligned(t) for t in (x, w1, b1, wg, bg, w2, b2))
    out = torch.empty((N, I, Co), dtype=x.dtype, device=dev)
    if N == 0:
        return out
    words_fn, fn = _fns()
    # the tensor-core kernel's weights, split into TF32 fragments once a call
    # (at bfloat16 their hi alone; none for the CUDA-core instance; -1: a
    # shape no kernel takes, which the launch refuses)
    words = 0 if cuda_cores else words_fn(lmax, C, H, Co, int(bf16))
    wfrag = torch.empty(max(words, 4), dtype=torch.int32, device=dev)
    status = fn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wg.data_ptr(), bg.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), wfrag.data_ptr(), N, lmax, C, H, Co,
        int(cuda_cores), int(bf16), build.stream_ptr(x),
    )
    build.check(status, "so3_gate_ffn")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def so3_gate_ffn_bwd_instance(lmax: int, C: int, H: int, Co: int) -> str | None:
    """Which of K2b's kernels runs these widths, at float32 and at bfloat16
    alike (any N): "tensor_cores", "cuda_cores", or None for a shape
    neither takes. Launches nothing."""
    fn = build.load("so3_gate_ffn_bwd").so3_gate_ffn_bwd_instance
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return {1: "tensor_cores", 0: "cuda_cores"}.get(fn(lmax, C, H, Co))


def _bwd_cc(x, w1, b1, wg, bg, w2, lmax, dy, dx, grads):
    """K2b's CUDA-core instance (float32, or bfloat16 at a bfloat16 x) into
    ``dx`` and the flat ``grads``."""
    N, _, C = x.shape
    H, Co = w1.shape[2], w2.shape[2]
    bf16 = int(x.dtype == torch.bfloat16)
    lib = build.load("so3_gate_ffn_bwd")
    slices_fn = lib.so3_gate_ffn_bwd_cc_slices
    slices_fn.argtypes = [ctypes.c_int] * 6
    slices_fn.restype = ctypes.c_int
    slices = slices_fn(N, lmax, C, H, Co, bf16)
    if slices < 1:
        raise ValueError(f"so3_gate_ffn backward kernel: {C} input / {Co} output channels at "
                         f"lmax {lmax} not supported or its tiles exceed shared memory")
    partial = torch.empty((slices, grads.numel()), dtype=torch.float32, device=x.device)
    fn = lib.so3_gate_ffn_bwd_cc
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(), wg.data_ptr(),
                bg.data_ptr(), w2.data_ptr(), dx.data_ptr(), partial.data_ptr(), grads.data_ptr(),
                N, lmax, C, H, Co, slices, bf16, build.stream_ptr(x))
    build.check(status, "so3_gate_ffn_bwd")


def so3_gate_ffn_bwd_cuda(x, w1, b1, wg, bg, w2, lmax: int, dy, cuda_cores: bool = False):
    """(dx, dw1, db1, dwg, dbg, dw2, db2) from the K2b kernels, at float32
    or (x, dy and dx bfloat16) at bfloat16: the tensor-core ones where they
    take the widths (``so3_gate_ffn_bwd_instance``), else the CUDA-core
    instance; ``cuda_cores``: the CUDA-core one at any width it takes (to
    time the two)."""
    global launches_bwd, launches_bwd_bf16
    N, _, C = x.shape
    L = lmax + 1
    H = w1.shape[2]
    Co = w2.shape[2]
    dev = x.device
    f32 = torch.float32
    act = torch.bfloat16 if x.dtype == torch.bfloat16 else f32
    build.require(x, "x", (N, L * L, C), act, dev)
    build.require(dy, "dy", (N, L * L, Co), act, dev)
    build.require(w1, "w1", (L, C, H), f32, dev)
    build.require(b1, "b1", (H,), f32, dev)
    build.require(wg, "wg", (C, lmax * H), f32, dev)
    build.require(bg, "bg", (lmax * H,), f32, dev)
    build.require(w2, "w2", (L, H, Co), f32, dev)
    x, w1, b1, wg, bg, w2, dy = (build.aligned(t) for t in (x, w1, b1, wg, bg, w2, dy))
    dx = torch.empty_like(x)
    sizes = (L * C * H, H, C * lmax * H, lmax * H, L * H * Co, Co)
    grads = torch.empty(sum(sizes), dtype=f32, device=dev)
    if N == 0:
        grads.zero_()
    elif cuda_cores or so3_gate_ffn_bwd_instance(lmax, C, H, Co) != "tensor_cores":
        _bwd_cc(x, w1, b1, wg, bg, w2, lmax, dy, dx, grads)
    else:
        bf16 = int(act != f32)
        slices_fn, words_fn, fn = _bwd_fns()
        slices = slices_fn(N, lmax, C, H, Co, bf16)
        if slices < 1:
            raise ValueError(f"so3_gate_ffn backward kernel: {C} input / {Co} output channels at "
                             f"lmax {lmax} not supported or its tiles exceed shared memory")
        partial = torch.empty((slices, sum(sizes)), dtype=f32, device=dev)
        # the dx kernel's weights, split into TF32 fragments (bfloat16: rounded) once a call
        wfrag = torch.empty(words_fn(lmax, C, H, Co, bf16), dtype=torch.int32, device=dev)
        status = fn(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(), wg.data_ptr(),
            bg.data_ptr(), w2.data_ptr(), dx.data_ptr(), partial.data_ptr(), grads.data_ptr(),
            wfrag.data_ptr(), N, lmax, C, H, Co, slices, bf16, build.stream_ptr(x),
        )
        build.check(status, "so3_gate_ffn_bwd")
    if N and act == f32:
        launches_bwd += 1
    elif N:
        launches_bwd_bf16 += 1
    dw1, db1, dwg, dbg, dw2, db2 = torch.split(grads, sizes)
    return (dx, dw1.view(L, C, H), db1, dwg.view(C, lmax * H), dbg, dw2.view(L, H, Co), db2)


class SO3GateFFN(torch.autograd.Function):
    """K2 forward and K2b backward. ``ctx`` keeps the inputs only, as
    ``_gate_fwd`` does; the backward recomputes the hidden."""

    @staticmethod
    def forward(ctx, x, w1, b1, wg, bg, w2, b2, lmax):
        ctx.lmax = lmax
        ctx.save_for_backward(x, w1, b1, wg, bg, w2)
        if x.device.type == "cpu":
            return so3_gate_ffn_plain(x, w1, b1, wg, bg, w2, b2, lmax)
        return so3_gate_ffn_cuda(x, w1, b1, wg, bg, w2, b2, lmax)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, wg, bg, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cpu":
            grads = so3_gate_ffn_bwd_plain(x, w1, b1, wg, bg, w2, ctx.lmax, dy)
        else:
            grads = so3_gate_ffn_bwd_cuda(x, w1, b1, wg, bg, w2, ctx.lmax, dy)
        return (*grads, None)


def so3_gate_ffn(x, w1, b1, wg, bg, w2, b2, lmax: int) -> torch.Tensor:
    """Plain versions for CPU tensors, the CUDA kernels for CUDA tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"so3_gate_ffn runs on cpu or cuda, not {x.device}")
    return SO3GateFFN.apply(x, w1, b1, wg, bg, w2, b2, lmax)


def so3_ffn_plain(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax: int) -> torch.Tensor:
    """x [N, I, C]; w1 [L, C, H]; b1 [H]; wg [C, H]; bg [H]; w2 [L, H, Co];
    b2 [Co]; to_grid/from_grid [G, I] (l-primary) -> [N, I, Co]. A bfloat16
    ``x`` takes the kernel's bfloat16 function (``so3_ffn_bf16_plain``)."""
    if x.dtype == torch.bfloat16:
        return so3_ffn_bf16_plain(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax)
    l_of = _l_of(lmax, x.device)
    gate = F.silu(x[:, 0, :] @ wg + bg)
    h = torch.einsum("nic,ich->nih", x, w1.index_select(0, l_of))
    h = torch.cat([h[:, :1] + b1, h[:, 1:]], dim=1)
    grid = F.silu(torch.einsum("gi,nih->ngh", to_grid, h))
    mid = torch.einsum("gi,ngh->nih", from_grid, grid)
    mid = torch.cat([gate[:, None, :], mid[:, 1:]], dim=1)
    y = torch.einsum("nih,iho->nio", mid, w2.index_select(0, l_of))
    return torch.cat([y[:, :1] + b2, y[:, 1:]], dim=1)


def so3_ffn_bf16_plain(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid,
                       lmax: int) -> torch.Tensor:
    """K4's bfloat16 instance in plain PyTorch, rounding where
    ``_ffn_fwd_kernel`` rounds at a bfloat16 ``x`` (the grid matrices
    bfloat16 too, as the module passes them): w1, wg and w2 cast to bfloat16
    (the biases stay float32); every product summed in float32; the gates
    ``silu(x0 wg + bg)`` rounded; h rounded after b1; silu of the grid
    rounded before the from-grid product; mid (row 0 the gates) rounded
    before the second product; the output rounded."""
    dt = x.dtype
    l_of = _l_of(lmax, x.device)
    xf, tg, fg = x.float(), rounded(to_grid, dt), rounded(from_grid, dt)
    gate = rounded(F.silu(xf[:, 0, :] @ rounded(wg, dt) + bg), dt)
    h = torch.einsum("nic,ich->nih", xf, rounded(w1, dt).index_select(0, l_of))
    h = rounded(torch.cat([h[:, :1] + b1, h[:, 1:]], dim=1), dt)
    act = rounded(F.silu(torch.einsum("gi,nih->ngh", tg, h)), dt)
    mid = torch.einsum("gi,ngh->nih", fg, act)
    mid = rounded(torch.cat([gate[:, None, :], mid[:, 1:]], dim=1), dt)
    y = torch.einsum("nih,iho->nio", mid, rounded(w2, dt).index_select(0, l_of))
    return torch.cat([y[:, :1] + b2, y[:, 1:]], dim=1).to(dt)


def _silu_grad(v: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(v)
    return s * (1.0 + v * (1.0 - s))


def so3_ffn_bwd_plain(x, w1, b1, wg, bg, w2, to_grid, from_grid, lmax: int, dy):
    """(dx, dw1, db1, dwg, dbg, dw2, db2) of ``so3_ffn_plain`` at cotangent
    ``dy``; the grid matrices are constants. At a bfloat16 ``x``,
    ``so3_ffn_bf16_bwd_plain``."""
    if x.dtype == torch.bfloat16:
        return so3_ffn_bf16_bwd_plain(x, w1, b1, wg, bg, w2, to_grid, from_grid, lmax, dy)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, w1, b1, wg, bg, w2)]
        b2 = x.new_zeros((w2.shape[2],), requires_grad=True)
        y = so3_ffn_plain(*leaves, b2, to_grid, from_grid, lmax)
        return torch.autograd.grad(y, (*leaves, b2), dy)


def so3_ffn_bf16_bwd_plain(x, w1, b1, wg, bg, w2, to_grid, from_grid, lmax: int, dy):
    """K4b's bfloat16 instance in plain PyTorch, rounding where
    ``_ffn_bwd_kernel`` rounds: the weights and grid matrices cast to
    bfloat16; h rounded after b1; dmid = dy w2^T in float32, dg0 =
    silu'(g0) dmid[0] from its float32 row 0, then the row zeroed and dmid
    rounded; silu of the grid rounded, mid (row 0 the gates) rounded;
    silu'(grid) times the lifted cotangent rounded before dh's product; db1
    sums dh unrounded, then dh is rounded before dw1 and dx; dg0 rounded
    (dbg sums it rounded); dx summed over the whole hidden in float32 and
    rounded once. dx is bfloat16, the six weight and bias gradients
    float32."""
    dt = x.dtype
    l_of = _l_of(lmax, x.device)
    xf, dyf = x.float(), dy.float()
    tg, fg = rounded(to_grid, dt), rounded(from_grid, dt)
    w1e = rounded(w1, dt).index_select(0, l_of)  # [I, C, H]
    w2e = rounded(w2, dt).index_select(0, l_of)  # [I, H, Co]
    wgr = rounded(wg, dt)
    x0 = xf[:, 0, :]
    g0 = x0 @ wgr + bg
    h = torch.einsum("nic,ich->nih", xf, w1e)
    h = rounded(torch.cat([h[:, :1] + b1, h[:, 1:]], dim=1), dt)
    dmid = torch.einsum("nio,iho->nih", dyf, w2e)
    dg0 = _silu_grad(g0) * dmid[:, 0]
    dmid = rounded(torch.cat([torch.zeros_like(dmid[:, :1]), dmid[:, 1:]], dim=1), dt)
    grid = torch.einsum("gi,nih->ngh", tg, h)
    act = rounded(F.silu(grid), dt)
    mid = torch.einsum("gi,ngh->nih", fg, act)
    mid = rounded(torch.cat([rounded(F.silu(g0), dt)[:, None], mid[:, 1:]], dim=1), dt)
    dgrid = rounded(_silu_grad(grid) * torch.einsum("gi,nih->ngh", fg, dmid), dt)
    del grid, act
    dh = torch.einsum("gi,ngh->nih", tg, dgrid)
    db1 = dh[:, 0].sum(0)
    dhc = rounded(dh, dt)
    dg0 = rounded(dg0, dt)
    dw1 = torch.zeros_like(w1).index_add_(0, l_of, torch.einsum("nic,nih->ich", xf, dhc))
    dw2 = torch.zeros_like(w2).index_add_(0, l_of, torch.einsum("nih,nio->iho", mid, dyf))
    dx = torch.einsum("nih,ich->nic", dhc, w1e)
    dx = torch.cat([dx[:, :1] + (dg0 @ wgr.t())[:, None], dx[:, 1:]], dim=1)
    return (dx.to(dt), dw1, db1, x0.t() @ dg0, dg0.sum(0), dw2, dyf[:, 0].sum(0))


def _s2_fns():
    lib = build.load("so3_ffn")
    words = lib.so3_ffn_words
    words.argtypes = [ctypes.c_int] * 6
    words.restype = ctypes.c_longlong
    fn = lib.so3_ffn
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return words, fn


def _s2_bwd_fns():
    lib = build.load("so3_ffn_bwd")
    blocks = lib.so3_ffn_bwd_blocks
    blocks.argtypes = [ctypes.c_int] * 7
    blocks.restype = ctypes.c_int
    fn = lib.so3_ffn_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return blocks, fn


def s2_fwd_instance(lmax: int, C: int, H: int, Co: int, G: int, bf16: bool = False) -> str | None:
    """Which of K4's kernels runs these widths (any N; ``bf16``: its
    bfloat16 instance's, the tensor-core kernel alone): "tensor_cores",
    "cuda_cores", or None for a shape neither takes. Launches nothing."""
    fn = build.load("so3_ffn").so3_ffn_instance
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return {1: "tensor_cores", 0: "cuda_cores"}.get(fn(lmax, C, H, Co, G, int(bf16)))


def _residency(fn, *widths) -> dict:
    fn.argtypes = [ctypes.c_int] * len(widths) + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(*widths, ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def s2_fwd_residency(lmax: int, C: int, H: int, Co: int, G: int, bf16: bool = False) -> dict:
    """K4's tensor-core kernel at these widths (``bf16``: its bfloat16
    instance): resident blocks per SM (-1: a shape it does not take),
    threads and dynamic shared memory per block. For reports; launches
    nothing."""
    return _residency(build.load("so3_ffn").so3_ffn_residency, lmax, C, H, Co, G, int(bf16))


def s2_bwd_residency(lmax: int, C: int, H: int, Co: int, G: int, bf16: bool = False) -> dict:
    """K4b's kernel at these widths (``bf16``: its bfloat16 instance):
    resident blocks per SM (-1: a shape it does not take), threads and
    dynamic shared memory per block. For reports; launches nothing."""
    return _residency(build.load("so3_ffn_bwd").so3_ffn_bwd_residency, lmax, C, H, Co, G,
                      int(bf16))


def _check_s2_args(x, w1, b1, wg, bg, w2, to_grid, from_grid, lmax: int):
    """Device, dtype, shape and contiguity of K4's and K4b's common
    arguments (x and the grid matrices float32, or all three bfloat16; the
    weights float32); returns (N, L, C, H, Co, G)."""
    N, I, C = x.shape
    L = lmax + 1
    H = w1.shape[2]
    Co = w2.shape[2]
    G = to_grid.shape[0]
    dev = x.device
    f32 = torch.float32
    act = torch.bfloat16 if x.dtype == torch.bfloat16 else f32
    if I != L * L:
        raise ValueError(f"x has {I} coefficient rows, expected {L * L} at lmax {lmax}")
    build.require(x, "x", (N, I, C), act, dev)
    build.require(w1, "w1", (L, C, H), f32, dev)
    build.require(b1, "b1", (H,), f32, dev)
    build.require(wg, "wg", (C, H), f32, dev)
    build.require(bg, "bg", (H,), f32, dev)
    build.require(w2, "w2", (L, H, Co), f32, dev)
    build.require(to_grid, "to_grid", (G, I), act, dev)
    build.require(from_grid, "from_grid", (G, I), act, dev)
    return N, L, C, H, Co, G


def so3_ffn_cuda(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax: int) -> torch.Tensor:
    """The K4 kernels (at a bfloat16 x, with bfloat16 grid matrices, its
    bfloat16 instance); arguments and result as ``so3_ffn_plain``."""
    global launches_s2, launches_s2_bf16
    N, L, C, H, Co, G = _check_s2_args(x, w1, b1, wg, bg, w2, to_grid, from_grid, lmax)
    build.require(b2, "b2", (Co,), torch.float32, x.device)
    x, w1, b1, wg, bg, w2, b2, to_grid, from_grid = (
        build.aligned(t) for t in (x, w1, b1, wg, bg, w2, b2, to_grid, from_grid))
    out = torch.empty((N, L * L, Co), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    bf16 = int(x.dtype == torch.bfloat16)
    words_fn, fn = _s2_fns()
    # the tensor-core kernel's weights, split into TF32 fragments once a call
    # (at bfloat16 rounded into m16n8k16 fragments; none for the CUDA-core
    # instance; -1: a shape no kernel takes, which the launch refuses)
    wfrag = torch.empty(max(words_fn(lmax, C, H, Co, G, bf16), 4), dtype=torch.int32,
                        device=x.device)
    status = fn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wg.data_ptr(), bg.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(), out.data_ptr(),
        wfrag.data_ptr(), N, lmax, C, H, Co, G, bf16, build.stream_ptr(x),
    )
    build.check(status, "so3_ffn")
    if bf16:
        launches_s2_bf16 += 1
    else:
        launches_s2 += 1
    return out


def so3_ffn_bwd_cuda(x, w1, b1, wg, bg, w2, to_grid, from_grid, lmax: int, dy):
    """(dx, dw1, db1, dwg, dbg, dw2, db2) from the K4b kernel (at a bfloat16
    x: x, dy, the grid matrices and dx bfloat16, its bfloat16 instance)."""
    global launches_s2_bwd, launches_s2_bwd_bf16
    N, L, C, H, Co, G = _check_s2_args(x, w1, b1, wg, bg, w2, to_grid, from_grid, lmax)
    dev = x.device
    f32 = torch.float32
    bf16 = int(x.dtype == torch.bfloat16)
    build.require(dy, "dy", (N, L * L, Co), x.dtype, dev)
    x, w1, b1, wg, bg, w2, to_grid, from_grid, dy = (
        build.aligned(t) for t in (x, w1, b1, wg, bg, w2, to_grid, from_grid, dy))
    dx = torch.empty_like(x)
    sizes = (L * C * H, H, C * H, H, L * H * Co, Co)
    grads = torch.empty(sum(sizes), dtype=f32, device=dev)
    if N == 0:
        grads.zero_()
    else:
        blocks_fn, fn = _s2_bwd_fns()
        blocks = blocks_fn(N, lmax, C, H, Co, G, bf16)
        if blocks < 1:
            raise ValueError(f"so3_ffn backward kernel: {C} input / {Co} output channels at "
                             f"lmax {lmax} not supported{' at bfloat16' if bf16 else ''} or its "
                             "tiles exceed shared memory")
        partial = torch.empty((blocks, sum(sizes)), dtype=f32, device=dev)
        # bfloat16: dx's float32 sums over the hidden chunks, rounded once
        dxf = torch.empty(x.shape if bf16 else (1,), dtype=f32, device=dev)
        status = fn(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(), wg.data_ptr(),
            bg.data_ptr(), w2.data_ptr(), to_grid.data_ptr(), from_grid.data_ptr(),
            dx.data_ptr(), dxf.data_ptr(), partial.data_ptr(), grads.data_ptr(), N, lmax, C, H,
            Co, G, blocks, bf16, build.stream_ptr(x),
        )
        build.check(status, "so3_ffn_bwd")
        if bf16:
            launches_s2_bwd_bf16 += 1
        else:
            launches_s2_bwd += 1
    dw1, db1, dwg, dbg, dw2, db2 = torch.split(grads, sizes)
    return (dx, dw1.view(L, C, H), db1, dwg.view(C, H), dbg, dw2.view(L, H, Co), db2)


class SO3FFN(torch.autograd.Function):
    """K4 forward and K4b backward. ``ctx`` keeps the inputs only, as
    ``_fwd`` does; the backward recomputes the hidden and the grid. The grid
    matrices are constants and get no gradient, as in the JAX ``_bwd``."""

    @staticmethod
    def forward(ctx, x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax):
        ctx.lmax = lmax
        ctx.save_for_backward(x, w1, b1, wg, bg, w2, to_grid, from_grid)
        if x.device.type == "cpu":
            return so3_ffn_plain(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax)
        return so3_ffn_cuda(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        dy = dy.contiguous()
        if saved[0].device.type == "cpu":
            grads = so3_ffn_bwd_plain(*saved, ctx.lmax, dy)
        else:
            grads = so3_ffn_bwd_cuda(*saved, ctx.lmax, dy)
        return (*grads, None, None, None)


def so3_ffn(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax: int) -> torch.Tensor:
    """Plain versions for CPU tensors, the CUDA kernels for CUDA tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"so3_ffn runs on cpu or cuda, not {x.device}")
    return SO3FFN.apply(x, w1, b1, wg, bg, w2, b2, to_grid, from_grid, lmax)
