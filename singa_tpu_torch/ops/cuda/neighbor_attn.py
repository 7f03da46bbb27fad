"""K1/K1b: neighbour-list graph attention of every kNN encoder layer, and its
backward; K7/K7b: the same function from neighbour rows gathered outside the
kernels (the hybrid form, ``SINGA_TPU_HYBRID_ATTN``).

K1 replaces ``singa_tpu/ops/pallas/neighbor_attn.py::neighbor_attn_fused``
(forward, ``_attn_fwd_kernel``); its kernels are ``csrc/encoder_attn.cuh``'s,
which K8 (``dense_edge_attn``) shares. Per node i and in-neighbour k: RBF smear of
the distance, the k- and v-EdgeMLPs (shifted softplus) on ``-smear``, the
per-head score ``sum_d qt * w_k * k_nb / sqrt(kd)``, a softmax over the K
neighbours plus the self slot (``diag_scores``), and the aggregate
``sum_k a * w_v * v_nb + a_self * diag_value``. K1b replaces ``_bwd``
(``_attn_bwd_kernel``): the gradients of qt, k and v (scattered to the
neighbour rows over every slot), of the self terms and of the eight EdgeMLP
weights and biases; nbr, nbr_mask, dist and centers get none. The CUDA
kernels (``csrc/neighbor_attn.cu``, ``csrc/neighbor_attn_bwd.cu``) gather
neighbour rows by index and keep every per-node pair tensor out of device
memory. Both directions evaluate only the slots whose terms are not exact
zeros and run their EdgeMLP products on the tensor cores as split TF32: the
forward takes a row's live slots, and a padded row's slots on the
v-EdgeMLP alone (its softmax is closed-form); the backward takes a row's
live slots, and nothing for a row whose cotangent is zero. At other widths
than the encoder's (kd 32, vd 64, De 64, H <= 4, K <= 128) each runs a
CUDA-core instance (``fwd_instance`` says which the forward takes).
``neighbor_attn`` goes through one ``torch.autograd.Function``: plain
versions for CPU tensors, the kernels for CUDA tensors.

K1 and K1b have bfloat16 instances (the bfloat16 training path's):
kernels at bfloat16 storage (K1's entry point ``neighbor_attn`` with
``bf16`` set, and ``neighbor_attn_bwd_bf16`` in the same sources), counted in
``launches_bf16`` and ``launches_bwd_bf16``, taken for a bfloat16 qt, k, v
and diag_value (dist, diag_scores, centers and the EdgeMLP weights stay
float32). Each is its tensor-core kernels at bfloat16 storage (K1's plan,
tile and copy kernels; K1b's pair kernel and dk/dv stage), each EdgeMLP
product one TF32 product where float32 takes three (a bfloat16 value is a
TF32 value), at the widths they take, else its CUDA-core kernels;
``cuda_cores`` and ``stats`` as at float32. They are the function
``_attn_fwd_kernel`` and ``_attn_bwd_kernel`` compute at a bfloat16 dtype
and round where those
round: the smear; the EdgeMLP weights, hiddens and outputs w_k, w_v; each
score term qt w_k k before the head sum (the TPU kernel rounds
``kw * qt`` ahead of its ``seg_k`` product, a place its matrix unit's layout
chose; kept, since it costs nothing on the CUDA cores and makes the
function the TPU kernel's); the softmax weights a_off and a_diag before
they weigh the values. Backward: each ``g w_v v`` and ``g diag_value`` term
before its head sum (da); a where it weighs (d diag_value, dw_v, dv) and
dsc; each ``dsc q k`` and ``a g v`` term before the head sum of dw_k and
dw_v, and those sums again; the EdgeMLPs' dh; each slot's dk/dv term
before the sum over the slots naming a row. dqt, dk, dv and d diag_value
come out bfloat16, d diag_scores and the weight gradients float32, as in
JAX. ``neighbor_attn_bf16_plain`` and ``neighbor_attn_bf16_bwd_plain`` are
their plain twins.

K7 replaces ``neighbor_attn_hybrid`` (``_hybrid_pallas_fwd``) and K7b its
``_bwd_h``: ``neighbor_attn_hybrid`` gathers ``k_nb``/``v_nb`` [B, N, K, *]
with ``torch.gather`` (JAX's ``_gather_rows`` is ``take_along_axis`` outside
the Pallas call), and the kernels, K1's and K1b's with their gathered-row
mode, read each slot's own row. Its Function keeps the inputs only and
gathers again in backward; K7b sends dk/dv to the node rows over the same
CSR transpose as K1b, where the TPU kernel used a one-hot transpose.

K7 and K7b have bfloat16 instances too (entry points ``neighbor_attn_hybrid``
with ``bf16`` set and ``neighbor_attn_hybrid_bwd_bf16``), counted in
``launches_hybrid_bf16`` and ``launches_bwd_hybrid_bf16``: K1's and K1b's
bfloat16 kernels in their gathered-row mode. The hybrid Pallas kernel is
``_attn_fwd_kernel`` with ``gathered=True`` on rows ``_gather_rows``
gathered at the compute dtype, widened as K1's exact one-hot product widens
them, and its backward casts the float32 one-hot transpose of the rounded
dk_nb, dv_nb once: K7·bf16 rounds where K1·bf16 does.
``neighbor_attn_hybrid_bf16_plain`` and ``neighbor_attn_hybrid_bf16_bwd_plain``
are their twins, K1's on the gathered rows.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from singa_tpu_torch.dtypes import rounded
from singa_tpu_torch.ops.cuda import build

launches = 0  # forward kernel launches through ``neighbor_attn``
launches_bwd = 0  # backward kernel launches through ``neighbor_attn``
launches_hybrid = 0  # K7 launches through ``neighbor_attn_hybrid``
launches_hybrid_bwd = 0  # K7b launches through ``neighbor_attn_hybrid``
launches_bf16 = 0  # K1's bfloat16 instance's launches (not in ``launches``)
launches_bwd_bf16 = 0  # K1b's bfloat16 instance's launches
launches_hybrid_bf16 = 0  # K7's bfloat16 instance's launches (not in ``launches_hybrid``)
launches_bwd_hybrid_bf16 = 0  # K7b's bfloat16 instance's launches


def _ssp(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - math.log(2.0)


def gather_rows(t: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """[B, N, F] gathered by [B, N, K] graph-local indices -> [B, N, K, F]
    (JAX's ``_gather_rows``)."""
    B, N, F = t.shape
    K = nbr.shape[2]
    idx = nbr.long().reshape(B, N * K, 1).expand(-1, -1, F)
    return torch.gather(t, 1, idx).reshape(B, N, K, F)


def scatter_rows(t_nb: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The transpose of ``gather_rows``: [B, N, K, F] summed into the rows
    ``nbr`` names -> [B, N, F]."""
    B, N, K, F = t_nb.shape
    idx = nbr.long().reshape(B, N * K, 1).expand(-1, -1, F)
    out = torch.zeros((B, N, F), dtype=t_nb.dtype, device=t_nb.device)
    return out.scatter_add_(1, idx, t_nb.reshape(B, N * K, F))


def neighbor_attn_plain(
    qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
) -> torch.Tensor:
    """qt/k [B, N, H*kd]; v [B, N, H*vd]; nbr/nbr_mask/dist [B, N, K];
    diag_scores [B, N, H]; diag_value [B, N, H*vd]; centers [De]; EdgeMLP
    weights in the flax ``[in, out]`` layout; coeff = -0.5/width^2.
    Returns agg [B, N, H*vd]. A bfloat16 ``k`` takes the kernel's bfloat16
    function (``neighbor_attn_bf16_plain``)."""
    if k.dtype == torch.bfloat16:
        return neighbor_attn_bf16_plain(qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
                                        centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff)
    return _from_rows(qt, gather_rows(k, nbr), gather_rows(v, nbr), nbr_mask, dist,
                      diag_scores, diag_value, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                      coeff)


def neighbor_attn_hybrid_plain(*args) -> torch.Tensor:
    """``neighbor_attn_plain`` from the gathered rows k_nb [B, N, K, H*kd]
    and v_nb [B, N, K, H*vd] in place of k, v and nbr (K7's inputs). A
    bfloat16 ``k_nb`` takes the kernel's bfloat16 function
    (``neighbor_attn_hybrid_bf16_plain``)."""
    if args[1].dtype == torch.bfloat16:
        return neighbor_attn_hybrid_bf16_plain(*args)
    return _from_rows(*args)


def _from_rows(qt, k_nb, v_nb, nbr_mask, dist, diag_scores, diag_value,
               centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float) -> torch.Tensor:
    """The attention from each slot's own k/v row: the plain function of
    every form (K1, K7, and K8 with every column a slot)."""
    B, N, K, HK = k_nb.shape
    H = diag_scores.shape[2]
    kd = HK // H
    vd = v_nb.shape[3] // H
    diff = dist[..., None] - centers
    e = -torch.exp(coeff * diff * diff)  # [B, N, K, De]
    w_k = _ssp(e @ wk1 + bk1) @ wk2 + bk2  # [B, N, K, kd]
    w_v = _ssp(e @ wv1 + bv1) @ wv2 + bv2  # [B, N, K, vd]
    k_nb = k_nb.reshape(B, N, K, H, kd)
    v_nb = v_nb.reshape(B, N, K, H, vd)
    s_off = (qt.reshape(B, N, 1, H, kd) * w_k[:, :, :, None, :] * k_nb).sum(-1)
    s_off = torch.where(nbr_mask[..., None], s_off / math.sqrt(kd), -1e9)
    a = torch.softmax(torch.cat([s_off, diag_scores[:, :, None, :]], dim=2), dim=2)
    agg = (a[:, :, :K, :, None] * w_v[:, :, :, None, :] * v_nb).sum(dim=2)
    agg = agg + a[:, :, K, :, None] * diag_value.reshape(B, N, H, vd)
    return agg.reshape(B, N, H * vd)


def _bf16_pairs(qt, k_nb, v_nb, nbr_mask, dist, diag_scores, centers,
                wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff):
    """What K1's and K7's bfloat16 instances compute per slot from the
    slots' rows k_nb, v_nb [B, N, K, *], as float32 tensors of bfloat16
    values where ``_attn_fwd_kernel`` rounds: the smear ``e``, the
    EdgeMLPs' pre-activations and rounded hiddens, their outputs ``w_k``,
    ``w_v`` (rounded), the rows widened, the scores (each ``qt w_k k``
    term rounded before the head sum) and the softmax weights over the K
    slots and the self slot (float32)."""
    dt = k_nb.dtype
    B, N, K, HK = k_nb.shape
    H = diag_scores.shape[2]
    kd = HK // H
    vd = v_nb.shape[3] // H
    diff = dist[..., None] - centers
    e = rounded(-torch.exp(coeff * diff * diff), dt)  # [B, N, K, De]
    pre_k = e @ rounded(wk1, dt) + bk1
    hid_k = rounded(_ssp(pre_k), dt)
    w_k = rounded(hid_k @ rounded(wk2, dt) + bk2, dt)
    pre_v = e @ rounded(wv1, dt) + bv1
    hid_v = rounded(_ssp(pre_v), dt)
    w_v = rounded(hid_v @ rounded(wv2, dt) + bv2, dt)
    k_nb = k_nb.float().reshape(B, N, K, H, kd)
    v_nb = v_nb.float().reshape(B, N, K, H, vd)
    q = qt.float().reshape(B, N, 1, H, kd)
    s_off = rounded(q * w_k[:, :, :, None, :] * k_nb, dt).sum(-1) * (1.0 / math.sqrt(kd))
    s_off = torch.where(nbr_mask[..., None], s_off, -1e9)
    s_diag = diag_scores.float()
    m = torch.maximum(s_off.amax(dim=2), s_diag)
    p_off = torch.exp(s_off - m[:, :, None])
    p_diag = torch.exp(s_diag - m)
    den = p_off.sum(dim=2) + p_diag
    return dict(e=e, pre_k=pre_k, hid_k=hid_k, w_k=w_k, pre_v=pre_v, hid_v=hid_v, w_v=w_v,
                k_nb=k_nb, v_nb=v_nb, q=q, a_off=p_off / den[:, :, None], a_diag=p_diag / den)


def neighbor_attn_bf16_plain(qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
                             centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff):
    """K1's bfloat16 instance in plain PyTorch, rounding where
    ``_attn_fwd_kernel`` rounds at bfloat16 qt, k, v and diag_value (the
    distances, diag_scores, centers and EdgeMLP weights float32): the smear,
    the EdgeMLP weights, hiddens and outputs, each score term before the
    head sum, and the softmax weights ``a_off``/``a_diag`` before they
    weigh the values; the aggregate in float32, rounded once."""
    return neighbor_attn_hybrid_bf16_plain(qt, gather_rows(k, nbr), gather_rows(v, nbr), nbr_mask,
                                           dist, diag_scores, diag_value, centers,
                                           wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff)


def neighbor_attn_hybrid_bf16_plain(qt, k_nb, v_nb, nbr_mask, dist, diag_scores, diag_value,
                                    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff):
    """K7's bfloat16 instance in plain PyTorch: ``neighbor_attn_bf16_plain``
    from the slots' bfloat16 rows k_nb [B, N, K, H*kd], v_nb [B, N, K,
    H*vd]."""
    dt = k_nb.dtype
    B, N, _ = qt.shape
    p = _bf16_pairs(qt, k_nb, v_nb, nbr_mask, dist, diag_scores, centers,
                    wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff)
    H = diag_scores.shape[2]
    vd = v_nb.shape[3] // H
    a_off, a_diag = rounded(p["a_off"], dt), rounded(p["a_diag"], dt)
    agg = (a_off[..., None] * p["w_v"][:, :, :, None, :] * p["v_nb"]).sum(dim=2)
    agg = agg + a_diag[..., None] * diag_value.float().reshape(B, N, H, vd)
    return agg.reshape(B, N, H * vd).to(dt)


def neighbor_attn_bf16_bwd_plain(qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
                                 centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, g):
    """K1b's bfloat16 instance in plain PyTorch, rounding where
    ``_attn_bwd_kernel`` rounds: each ``g w_v v`` and ``g diag_value`` term
    before its head sum (da), the softmax weights where they weigh (a_t),
    dsc before it spreads to the channels, each ``dsc w_k qt`` and
    ``a g v`` term before the head sum of dw_k/dw_v, those sums again,
    the EdgeMLPs' dh, and each slot's dk/dv term before the sum over the
    slots that name a row. dqt, dk, dv and d diag_value come out bfloat16,
    d diag_scores and the weight gradients float32."""
    return neighbor_attn_hybrid_bf16_bwd_plain(qt, gather_rows(k, nbr), gather_rows(v, nbr), nbr,
                                               nbr_mask, dist, diag_scores, diag_value, centers,
                                               wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, g)


def neighbor_attn_hybrid_bf16_bwd_plain(qt, k_nb, v_nb, nbr, nbr_mask, dist, diag_scores,
                                        diag_value, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2,
                                        bv2, coeff, g):
    """K7b's bfloat16 instance in plain PyTorch: ``neighbor_attn_bf16_bwd_plain``
    from the slots' bfloat16 rows k_nb, v_nb; each slot's rounded dk/dv term
    summed in float32 into the row ``nbr`` names, rounded once."""
    dt = k_nb.dtype
    B, N, HK = qt.shape
    H = diag_scores.shape[2]
    kd = HK // H
    vd = v_nb.shape[3] // H
    p = _bf16_pairs(qt, k_nb, v_nb, nbr_mask, dist, diag_scores, centers,
                    wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff)
    w_k, w_v = p["w_k"][:, :, :, None, :], p["w_v"][:, :, :, None, :]  # [B, N, K, 1, d]
    k_nb, v_nb, q = p["k_nb"], p["v_nb"], p["q"]
    a_off, a_diag = p["a_off"], p["a_diag"]
    gf = g.float().reshape(B, N, 1, H, vd)
    da_off = rounded(gf * w_v * v_nb, dt).sum(-1)  # [B, N, K, H]
    da_diag = rounded(gf[:, :, 0] * diag_value.float().reshape(B, N, H, vd), dt).sum(-1)
    a_t = rounded(a_off, dt)[..., None]
    dwv3 = rounded(a_t * gf * v_nb, dt).sum(3)  # [B, N, K, vd]
    dv_nb = rounded(a_t * w_v * gf, dt)
    ddv = (rounded(a_diag, dt)[..., None] * gf[:, :, 0]).reshape(B, N, H * vd).to(dt)
    dot = (a_off * da_off).sum(dim=2) + a_diag * da_diag
    dds = a_diag * (da_diag - dot)
    ds_off = torch.where(nbr_mask[..., None], a_off * (da_off - dot[:, :, None]), 0.0)
    ds_t = rounded(ds_off * (1.0 / math.sqrt(kd)), dt)[..., None]
    dqt = (ds_t * k_nb * w_k).sum(dim=2).reshape(B, N, HK).to(dt)
    dk_nb = rounded(ds_t * w_k * q, dt)
    dwk3 = rounded(ds_t * k_nb * q, dt).sum(3)  # [B, N, K, kd]
    wgrads = []
    for dw3, pre, hid, w2 in ((dwk3, p["pre_k"], p["hid_k"], wk2),
                              (dwv3, p["pre_v"], p["hid_v"], wv2)):
        dw3 = rounded(dw3, dt)
        dh = rounded((dw3 @ rounded(w2, dt).t()) * torch.sigmoid(pre), dt)
        wgrads.append((torch.einsum("bnke,bnkh->eh", p["e"], dh), dh.sum((0, 1, 2)),
                       torch.einsum("bnkh,bnko->ho", hid, dw3), dw3.sum((0, 1, 2))))
    K = nbr.shape[2]
    dk = scatter_rows(dk_nb.reshape(B, N, K, HK), nbr).to(dt)
    dv = scatter_rows(dv_nb.reshape(B, N, K, H * vd), nbr).to(dt)
    return (dqt, dk, dv, dds, ddv, *wgrads[0], *wgrads[1])


def neighbor_attn_bwd_plain(*args):
    """``(dqt, dk, dv, d diag_scores, d diag_value, dwk1, dbk1, dwk2, dbk2,
    dwv1, dbv1, dwv2, dbv2)`` of ``neighbor_attn_plain``: ``args`` are its
    arguments followed by the cotangent ``g``; at a bfloat16 ``k``,
    ``neighbor_attn_bf16_bwd_plain``."""
    if args[1].dtype == torch.bfloat16:
        return neighbor_attn_bf16_bwd_plain(*args)
    *inputs, coeff, g = args
    # qt, k, v, diag_scores, diag_value and the eight EdgeMLP weights/biases
    diff_at = (0, 1, 2, 6, 7) + tuple(range(9, 17))
    with torch.enable_grad():
        inputs = [
            t.detach().requires_grad_() if i in diff_at else t for i, t in enumerate(inputs)
        ]
        out = neighbor_attn_plain(*inputs, coeff)
        return torch.autograd.grad(out, [inputs[i] for i in diff_at], g)


def neighbor_attn_hybrid_bwd_plain(*args):
    """K7b's outputs, those of ``neighbor_attn_bwd_plain``, from its inputs:
    ``neighbor_attn_hybrid_plain``'s arguments with ``nbr`` after ``v_nb``,
    then the cotangent ``g``. dk/dv are the gradients of k_nb/v_nb summed
    into the rows ``nbr`` names. A bfloat16 ``k_nb`` takes
    ``neighbor_attn_hybrid_bf16_bwd_plain``."""
    if args[1].dtype == torch.bfloat16:
        return neighbor_attn_hybrid_bf16_bwd_plain(*args)
    *inputs, coeff, g = args
    qt, k_nb, v_nb, nbr, *rest = inputs
    inputs = [qt, k_nb, v_nb, *rest]
    # qt, k_nb, v_nb, diag_scores, diag_value and the eight EdgeMLP weights/biases
    diff_at = (0, 1, 2, 5, 6) + tuple(range(8, 16))
    with torch.enable_grad():
        inputs = [
            t.detach().requires_grad_() if i in diff_at else t for i, t in enumerate(inputs)
        ]
        out = _from_rows(*inputs, coeff)
        dqt, dk_nb, dv_nb, *rest = torch.autograd.grad(out, [inputs[i] for i in diff_at], g)
    return (dqt, scatter_rows(dk_nb, nbr), scatter_rows(dv_nb, nbr), *rest)


def _fn(hybrid: bool = False):
    """K1's C entry point, or K7's (no nbr pointer); the last int of each
    is bf16."""
    lib = build.load("neighbor_attn")
    fn = lib.neighbor_attn_hybrid if hybrid else lib.neighbor_attn
    fn.argtypes = (
        [ctypes.c_void_p] * (16 if hybrid else 17) + [ctypes.c_float] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return fn


def fwd_instance(K: int, H: int, kd: int, vd: int, De: int) -> str | None:
    """Which of K1's (and K7's) kernels runs these widths (any B, N):
    "tensor_cores", "cuda_cores", or None for a shape neither takes (the
    CUDA-core instance may still refuse a K whose slots exceed its shared
    memory, when it launches). Launches nothing."""
    fn = build.load("neighbor_attn").neighbor_attn_instance
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return {0: "tensor_cores", 1: "cuda_cores"}.get(fn(K, H, kd, vd, De))


def fwd_residency(hybrid: bool = False, bf16: bool = False) -> dict:
    """K1's tensor-core tile kernel (K7's with ``hybrid``; the bfloat16
    instance with ``bf16``): resident blocks per SM (-1: refused), threads
    and dynamic shared memory per block. For reports; launches nothing."""
    fn = build.load("neighbor_attn").neighbor_attn_residency
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(int(hybrid), int(bf16), ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def _bwd_fns(hybrid: bool = False, bf16: bool = False):
    """(blocks, launch) of K1b's C entry points (``bf16``: its bfloat16
    instance's), or K7b's (no nbr pointer)."""
    lib = build.load("neighbor_attn_bwd")
    name = "neighbor_attn_hybrid_bwd" if hybrid else "neighbor_attn_bwd"
    blocks = getattr(lib, f"{name}_bf16_blocks" if bf16 else f"{name}_blocks")
    blocks.argtypes = [ctypes.c_int] * 8
    blocks.restype = ctypes.c_int
    fn = getattr(lib, f"{name}_bf16" if bf16 else f"{name}_f32")
    fn.argtypes = (
        [ctypes.c_void_p] * (16 if hybrid else 17) + [ctypes.c_float] + [ctypes.c_void_p] * 15
        + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return blocks, fn


def bwd_residency(hybrid: bool = False, bf16: bool = False) -> dict:
    """K1b's tensor-core pair kernel (K7b's with ``hybrid``; the bfloat16
    instance with ``bf16``): resident blocks per SM (-1: refused), threads
    and dynamic shared memory per block. For reports; launches nothing."""
    fn = build.load("neighbor_attn_bwd").neighbor_attn_bwd_residency
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    smem, threads = ctypes.c_int(0), ctypes.c_int(0)
    per_sm = fn(int(hybrid), int(bf16), ctypes.byref(smem), ctypes.byref(threads))
    return {"blocks_per_sm": per_sm, "threads": threads.value, "smem_bytes": smem.value}


def _check_args(qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
                centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, gathered: bool = False):
    """Device, dtype, shape and contiguity of every kernel argument; returns
    (B, N, K, H, kd, vd, De). ``gathered``: k and v are K7's k_nb/v_nb
    [B, N, K, *]; nbr may then be None. qt, k, v and diag_value are float32,
    or bfloat16 all four for the bfloat16 instance."""
    B, N, HK = qt.shape
    K = nbr_mask.shape[2]
    H = diag_scores.shape[2]
    kd = HK // H
    vd = v.shape[-1] // H
    De = centers.shape[0]
    dev = qt.device
    f32 = torch.float32
    rows = (B, N, K) if gathered else (B, N)
    act = torch.bfloat16 if qt.dtype == torch.bfloat16 else f32
    build.require(qt, "qt", (B, N, H * kd), act, dev)
    build.require(k, "k_nb" if gathered else "k", (*rows, H * kd), act, dev)
    build.require(v, "v_nb" if gathered else "v", (*rows, H * vd), act, dev)
    if nbr is not None:
        build.require(nbr, "nbr", (B, N, K), torch.int32, dev)
    build.require(nbr_mask, "nbr_mask", (B, N, K), torch.bool, dev)
    build.require(dist, "dist", (B, N, K), f32, dev)
    check_node_args(qt, diag_scores, diag_value, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                    vd, act)
    return B, N, K, H, kd, vd, De


def check_node_args(qt, diag_scores, diag_value, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                    vd: int, act=torch.float32):
    """The checks of the arguments every form of the encoder attention takes
    (K1, K7, K8): the self terms, the centers and the EdgeMLP weights;
    diag_value of dtype ``act``, the rest float32."""
    B, N, HK = qt.shape
    H = diag_scores.shape[2]
    kd, De = HK // H, centers.shape[0]
    dev, f32 = qt.device, torch.float32
    build.require(diag_scores, "diag_scores", (B, N, H), f32, dev)
    build.require(diag_value, "diag_value", (B, N, H * vd), act, dev)
    build.require(centers, "centers", (De,), f32, dev)
    for name, t, shape in (
        ("wk1", wk1, (De, kd)), ("bk1", bk1, (kd,)), ("wk2", wk2, (kd, kd)),
        ("bk2", bk2, (kd,)), ("wv1", wv1, (De, vd)), ("bv1", bv1, (vd,)),
        ("wv2", wv2, (vd, vd)), ("bv2", bv2, (vd,)),
    ):
        build.require(t, name, shape, f32, dev)


def neighbor_attn_cuda(
    qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
    cuda_cores: bool = False, stats=None,
) -> torch.Tensor:
    """The K1 kernels (at a bfloat16 qt, k, v and diag_value its bfloat16
    instance); arguments and result as ``neighbor_attn_plain``. The
    tensor-core tile kernel runs where it takes the shapes (``fwd_instance``,
    at either dtype), else the CUDA-core one; ``cuda_cores``: the CUDA-core
    one at any shape (to time the two). ``stats``: None, or an int32 tensor [4] of zeros on the
    card, to which the tensor-core kernel adds what it walked (rows taken
    with their live slots, dead-weighted rows evaluated, rows taken again
    whole, slots evaluated; the rest of the rows are dead-weighted rows that
    copy the sums of the row before them)."""
    return _fwd_cuda((qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
                      centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2), coeff, False,
                     cuda_cores, stats)


def neighbor_attn_hybrid_cuda(
    qt, k_nb, v_nb, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float,
    cuda_cores: bool = False, stats=None,
) -> torch.Tensor:
    """The K7 kernels (at a bfloat16 qt, k_nb, v_nb and diag_value its
    bfloat16 instance); arguments and result as
    ``neighbor_attn_hybrid_plain``; ``cuda_cores`` and ``stats`` as
    ``neighbor_attn_cuda``'s."""
    return _fwd_cuda((qt, k_nb, v_nb, nbr_mask, dist, diag_scores, diag_value,
                      centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2), coeff, True,
                     cuda_cores, stats)


def _fwd_cuda(args, coeff, hybrid: bool, cuda_cores: bool, stats):
    """K1 (k, v, nbr) or K7 (k_nb, v_nb, no nbr), at a bfloat16 qt its
    bfloat16 instance: the checks, the output, the scratch, the launch and
    its count."""
    global launches, launches_hybrid, launches_bf16, launches_hybrid_bf16
    if hybrid:
        B, N, K, H, kd, vd, De = _check_args(*args[:3], None, *args[3:], gathered=True)
    else:
        B, N, K, H, kd, vd, De = _check_args(*args)
    args = [build.aligned(t) for t in args]
    qt = args[0]
    if stats is not None:
        build.require(stats, "stats", (4,), torch.int32, qt.device)
    out = torch.empty((B, N, H * vd), dtype=qt.dtype, device=qt.device)
    if B * N == 0:
        return out
    bf16 = qt.dtype == torch.bfloat16
    # the dead-weighted rows' unweighted sums (for the rows that copy them), the plan
    sums = torch.empty((B * N, H * vd), dtype=torch.float32, device=qt.device)
    plan = torch.empty(B * N, dtype=torch.int32, device=qt.device)
    status = _fn(hybrid)(*(t.data_ptr() for t in args), float(coeff), out.data_ptr(),
                         sums.data_ptr(), plan.data_ptr(), B, N, K, H, kd, vd, De,
                         int(cuda_cores), int(bf16),
                         None if stats is None else stats.data_ptr(), build.stream_ptr(qt))
    build.check(status, "neighbor_attn_hybrid" if hybrid else "neighbor_attn")
    if hybrid and bf16:
        launches_hybrid_bf16 += 1
    elif hybrid:
        launches_hybrid += 1
    elif bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def transpose_slots(nbr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CSR transpose of ``nbr`` [B, N, K]: ``offsets`` [B*N + 1] and
    ``slots`` [B*N*K] int32, the flat ``(row, slot)`` ids whose neighbour is
    row j at ``slots[offsets[j]:offsets[j+1]]``, ascending (a stable sort).
    K1b's dk/dv gather reads it; ``build_neighbor_graph`` builds it once per
    graph, beside ``nbr``."""
    B, N, K = nbr.shape
    rows = torch.arange(B, device=nbr.device, dtype=torch.long)[:, None, None] * N
    keys = (nbr.long() + rows).reshape(-1)
    slots = torch.sort(keys, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(B * N + 1, dtype=torch.int32, device=nbr.device)
    offsets[1:] = torch.cumsum(torch.bincount(keys, minlength=B * N), 0)
    return offsets, slots


def neighbor_attn_bwd_cuda(*args, offsets, slots, cuda_cores=False, stats=None):
    """The K1b kernels; arguments and result as ``neighbor_attn_bwd_plain``,
    plus ``transpose_slots(nbr)`` as ``offsets`` and ``slots``. The
    tensor-core pair kernel runs where it takes the shapes, else the
    CUDA-core one; ``cuda_cores``: the CUDA-core one at any shape (to time
    the two). ``stats``: None, or an int32 tensor [4] of zeros on the card,
    to which the launch adds what it walked (rows skipped for a zero
    cotangent, rows taken with their live slots, rows taken whole, slots
    evaluated)."""
    global launches_bwd, launches_bwd_bf16
    grads = _bwd_cuda(args, offsets, slots, False, cuda_cores, stats)
    if grads[0].dtype == torch.bfloat16:
        launches_bwd_bf16 += 1
    else:
        launches_bwd += 1
    return grads


def neighbor_attn_hybrid_bwd_cuda(*args, offsets, slots, cuda_cores=False, stats=None):
    """The K7b kernels (at a bfloat16 qt its bfloat16 instance); arguments
    and result as ``neighbor_attn_hybrid_bwd_plain``, plus
    ``transpose_slots(nbr)`` as ``offsets`` and ``slots``; ``cuda_cores``
    and ``stats`` as ``neighbor_attn_bwd_cuda``'s."""
    global launches_hybrid_bwd, launches_bwd_hybrid_bf16
    grads = _bwd_cuda(args, offsets, slots, True, cuda_cores, stats)
    if grads[0].dtype == torch.bfloat16:
        launches_bwd_hybrid_bf16 += 1
    else:
        launches_hybrid_bwd += 1
    return grads


def _bwd_cuda(args, offsets, slots, hybrid: bool, cuda_cores: bool, stats):
    """K1b (k, v) or K7b (k_nb, v_nb): the checks, outputs, scratch and the
    launch; the caller counts it."""
    *inputs, coeff, g = args
    B, N, K, H, kd, vd, De = _check_args(*inputs, gathered=hybrid)
    qt = inputs[0]
    dev = qt.device
    f32 = torch.float32
    build.require(g, "g", (B, N, H * vd), qt.dtype, dev)
    build.require(offsets, "offsets", (B * N + 1,), torch.int32, dev)
    build.require(slots, "slots", (B * N * K,), torch.int32, dev)
    if stats is not None:
        build.require(stats, "stats", (4,), torch.int32, dev)
    inputs = [build.aligned(t) for t in inputs]
    g, offsets, slots = (build.aligned(t) for t in (g, offsets, slots))
    empty = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    act = lambda *shape: torch.empty(shape, dtype=qt.dtype, device=dev)
    dqt, dk = act(B, N, H * kd), act(B, N, H * kd)
    dv, dds, ddv = act(B, N, H * vd), empty(B, N, H), act(B, N, H * vd)
    sizes = (De * kd, kd, kd * kd, kd, De * vd, vd, vd * vd, vd)
    grads = torch.zeros(sum(sizes), dtype=f32, device=dev)
    if B * N:
        # the bfloat16 instance at a bfloat16 qt
        blocks_fn, fn = _bwd_fns(hybrid, qt.dtype == torch.bfloat16)
        blocks = blocks_fn(B, N, K, H, kd, vd, De, int(cuda_cores))
        if blocks < 1:
            raise ValueError(f"neighbor_attn backward kernel: shapes {(K, H, kd, vd, De)} not "
                             "supported or one node's pair tensors exceed shared memory")
        slots_n = B * N * K
        # per slot: w_k, w_v, a, dsc; per row: its plan; per block: its weight-gradient row
        scratch = (empty(slots_n, kd), empty(slots_n, vd), empty(slots_n, H), empty(slots_n, H),
                   torch.empty(B * N, dtype=torch.int32, device=dev), empty(blocks, sum(sizes)))
        # K7b's entry point takes no nbr: its pair kernel reads the gathered rows
        pointers = [t.data_ptr() for i, t in enumerate(inputs) if not (hybrid and i == 3)]
        status = fn(
            *pointers, float(coeff), g.data_ptr(), offsets.data_ptr(),
            slots.data_ptr(), dqt.data_ptr(), dk.data_ptr(), dv.data_ptr(), dds.data_ptr(),
            ddv.data_ptr(), *(t.data_ptr() for t in scratch), grads.data_ptr(),
            B, N, K, H, kd, vd, De, blocks, int(cuda_cores),
            None if stats is None else stats.data_ptr(), build.stream_ptr(qt),
        )
        build.check(status, "neighbor_attn_hybrid_bwd" if hybrid else "neighbor_attn_bwd")
    weights = inputs[9:]
    wgrads = [p.view(w.shape) for p, w in zip(torch.split(grads, sizes), weights)]
    return (dqt, dk, dv, dds, ddv, *wgrads)


class NeighborAttn(torch.autograd.Function):
    """K1 forward and K1b backward. ``ctx`` keeps the inputs only, as ``_fwd``
    does; the backward recomputes every pair tensor."""

    @staticmethod
    def forward(ctx, *args):
        *inputs, coeff, offsets, slots = args
        ctx.coeff = coeff
        ctx.save_for_backward(*inputs, offsets, slots)
        if inputs[0].device.type == "cpu":
            return neighbor_attn_plain(*inputs, coeff)
        return neighbor_attn_cuda(*inputs, coeff)

    @staticmethod
    def backward(ctx, g):
        *inputs, offsets, slots = ctx.saved_tensors
        args = (*inputs, ctx.coeff, g.contiguous())
        if inputs[0].device.type == "cpu":
            grads = neighbor_attn_bwd_plain(*args)
        else:
            grads = neighbor_attn_bwd_cuda(*args, offsets=offsets, slots=slots)
        dqt, dk, dv, dds, ddv, *wgrads = grads
        # nbr, nbr_mask, dist, centers, coeff and the transpose get none, as in
        # the JAX _bwd
        return (dqt, dk, dv, None, None, None, dds, ddv, None, *wgrads, None, None, None)


def neighbor_attn(
    qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float, offsets, slots,
) -> torch.Tensor:
    """Plain versions for CPU tensors, the CUDA kernels for CUDA tensors.
    ``offsets``/``slots`` are ``transpose_slots(nbr)``, for K1b."""
    if qt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"neighbor_attn runs on cpu or cuda, not {qt.device}")
    return NeighborAttn.apply(qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
                              centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff,
                              offsets, slots)


class NeighborAttnHybrid(torch.autograd.Function):
    """K7 forward and K7b backward. The neighbour rows are gathered before
    each kernel, again in backward (as ``_bwd_h``): ``ctx`` keeps the inputs
    only, never the [B, N, K, *] rows (~1.8 GB per layer at a training
    microbatch)."""

    @staticmethod
    def forward(ctx, *args):
        *inputs, coeff, offsets, slots = args
        ctx.coeff = coeff
        ctx.save_for_backward(*inputs, offsets, slots)
        qt, k, v, nbr, *rest = inputs
        gathered = (qt, gather_rows(k, nbr), gather_rows(v, nbr), *rest)
        if qt.device.type == "cpu":
            return neighbor_attn_hybrid_plain(*gathered, coeff)
        return neighbor_attn_hybrid_cuda(*gathered, coeff)

    @staticmethod
    def backward(ctx, g):
        *inputs, offsets, slots = ctx.saved_tensors
        qt, k, v, nbr, *rest = inputs
        args = (qt, gather_rows(k, nbr), gather_rows(v, nbr), nbr, *rest, ctx.coeff,
                g.contiguous())
        if qt.device.type == "cpu":
            grads = neighbor_attn_hybrid_bwd_plain(*args)
        else:
            grads = neighbor_attn_hybrid_bwd_cuda(*args, offsets=offsets, slots=slots)
        dqt, dk, dv, dds, ddv, *wgrads = grads
        return (dqt, dk, dv, None, None, None, dds, ddv, None, *wgrads, None, None, None)


def neighbor_attn_hybrid(
    qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff: float, offsets, slots,
) -> torch.Tensor:
    """``neighbor_attn``'s arguments and result, through K7/K7b on CUDA
    tensors (the rows gathered by ``torch.gather`` outside the kernels) and
    their plain versions on CPU tensors."""
    if qt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"neighbor_attn_hybrid runs on cpu or cuda, not {qt.device}")
    return NeighborAttnHybrid.apply(qt, k, v, nbr, nbr_mask, dist, diag_scores, diag_value,
                                    centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff,
                                    offsets, slots)
