"""The list forms' algorithms, forward (K1's and K7's tensor-core kernels,
``csrc/neighbor_attn.cu``) and backward (K1b's and K7b's,
``csrc/neighbor_attn_bwd.cu``), against their definition: plain PyTorch
renderings of what the kernels do, written here for the tests only. The
forward's is held to ``neighbor_attn_plain`` / ``neighbor_attn_hybrid_plain``
and to JAX's ``neighbor_attn_fused`` / ``neighbor_attn_hybrid`` (Pallas,
interpret mode); the backward's to ``neighbor_attn_bwd_plain`` /
``neighbor_attn_hybrid_bwd_plain`` (every slot evaluated) and to those JAX
functions' custom VJPs, every gradient.

The forward rendering (``list_forward``) plans each row as the kernel
does: a row with live slots takes them, compacted from the mask in slot
order (none for a real row with no live slot: a_self = 1); a row with no
live slot whose dead slots weigh something, exp(-1e9 - max(ds, -1e9)) != 0
in float32 in some head (a padded row), is dead-weighted: all K slots on
the v-EdgeMLP alone, its softmax in closed form. Rows go to blocks by their
work; each block packs whole rows into tiles, the live rows' slots first
(the k-section, both EdgeMLPs and the scores), then the dead-weighted
rows' (the v-net alone). A live row whose max leaves its dead slots a
weight writes nothing and is taken again, whole, in the block's next tile.
The aggregate sums 16-slot chunks of a row, the chunks in order. Inputs as
below; tolerance: the output within 2e-5 of its largest magnitude, rtol
1e-5 (sums over the taken slots in another order); on the CPU it reads
more than ten times inside it. At bfloat16 qt, k, v and diag_value it
renders K1's bfloat16 instance, rounding where ``neighbor_attn_bf16_plain``
rounds, and is held to that twin and to the Pallas kernel at bfloat16
within ``BF16_TOL`` of the output's largest magnitude.

The backward rendering:

The rendering plans each row as the kernel does: a row whose cotangent is
zero is skipped (its outputs zero, its slots send nothing); any other row
takes its live slots, compacted from the mask in slot order (masks need not
be a prefix). Rows go to blocks by their work, and each block packs whole
rows into tiles of at most ``tile`` slots and ``tile_rows`` rows, with the
softmax per row in one pass. A row whose max (over its self score and live
scores) leaves its dead slots a weight, exp(-1e9 - m) != 0 in float32 in
some head (a padded row with a cotangent, or scores near -1e9), sends
nothing and is taken again, whole, in the block's next tile. Each tile's
weight-gradient products are summed from zero and added to the block's
sums, the blocks' sums in order. Per taken slot it keeps w_k, w_v, a and
dsc in scratch that starts as NaN (as torch.empty may), a skipped slot gets
a = dsc = 0, and dk/dv gather over the CSR transpose of nbr the slots whose
a or dsc is non-zero in some head (a skipped slot's w_k and w_v are never
read).

``list_forward(..., mm=...)`` and ``list_backward(..., mm=...)`` take the
products the kernels run on the tensor cores through ``mm``:
``tests/test_torch_tf32_split.py::k1_split`` and ``k1b_split`` render them
in split TF32. This file imports neither JAX nor the JAX
package at module level (``tests/test_torch_cuda.py`` reaches it through
``k1b_split`` on a machine without JAX).

Inputs are numpy-seeded and float32. Tolerance: each gradient within 2e-5
of its own largest magnitude (floored at 1e-6, so small gradients are held
to their own scale), rtol 1e-5 (sums over every taken slot in another
order). On the CPU every gradient reads more than ten times inside it,
against the plain twins and against JAX.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from singa_tpu_torch.dtypes import rounded

BIG = 1e9
ROW_WORK = 8  # a row's fixed cost in slots, in the blocks' shares (the kernel's kRowWork)
ZERO, LIVE, WHOLE = 0, 1, 2
DEAD, COPY = 3, 4  # the forward's dead-weighted rows, and those that copy the row before's
CHUNK, MAX_CHUNKS = 16, 48  # the forward aggregate's slots per chunk, chunks per tile
H, KD, VD, DE = 2, 8, 8, 8
GRAD_NAMES = ["dqt", "dk", "dv", "dds", "ddv", "dwk1", "dbk1", "dwk2", "dbk2",
              "dwv1", "dbv1", "dwv2", "dbv2"]
DIFF_AT = [0, 1, 2, 6, 7, *range(9, 17)]  # the differentiable arguments


def _ssp(x):
    return F.softplus(x) - math.log(2.0)


def plan_rows(mask, g):
    """Each row's mode and the slots it takes: skipped, or its live slots.
    mask [R, K], g [R, H, vd]."""
    zero = ~(g != 0).flatten(1).any(1)
    cnt = torch.where(zero, 0, mask.sum(1))
    return torch.where(zero, ZERO, LIVE).tolist(), cnt.tolist()


def block_ranges(cnt, blocks):
    """Rows [lo, hi) of each block: row r goes to block floor(p_r G / W), p_r
    the work of the rows before it (taken slots + ROW_WORK each)."""
    work = [c + ROW_WORK for c in cnt]
    total, p, before = sum(work), 0, []
    for w in work:
        before.append(p)
        p += w
    lo = [sum(1 for x in before if x < -(-b * total // blocks)) for b in range(blocks)]
    return list(zip(lo, lo[1:] + [len(cnt)]))


def plan_fwd_rows(mask, ds):
    """Each row's forward mode and the slots it takes: its live slots (none
    for a real row with no live slot), or all K on the v-EdgeMLP when it has
    no live slot and exp(-1e9 - max(ds, -1e9)) != 0 in some head. mask
    [R, K], ds [R, H]."""
    K = mask.shape[1]
    live = mask.sum(1)
    weighs = (torch.exp(-BIG - torch.clamp(ds, min=-BIG)) != 0).any(1)
    dead = (live == 0) & weighs
    return torch.where(dead, DEAD, LIVE).tolist(), torch.where(dead, K, live).tolist()


def list_forward(qt, k, v, nbr, nbr_mask, dist, ds, dval, centers,
                 wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, *, gathered=False,
                 mm=torch.matmul, blocks=1, tile=128, tile_rows=64, stats=None):
    """K1's tensor-core algorithm on ``neighbor_attn_plain``'s arguments
    (K7's, those of ``neighbor_attn_hybrid_plain`` with k_nb and v_nb, with
    ``gathered``; nbr is then unused): the output [B, N, H*vd]. ``stats``, a
    dict, gets the rows taken live, dead-weighted (evaluated) and taken
    again, the slots evaluated and the dead-weighted rows copied. At a
    bfloat16 qt, k, v and diag_value, K1's bfloat16 instance: it rounds
    where ``neighbor_attn_bf16_plain`` rounds (the smear, the EdgeMLP
    weights, hiddens and outputs, each score term before the head sum, the
    softmax weights that weigh the values: a live row's a and a_self, a
    dead-weighted or copied row's closed-form a_dead and a_self), sums in
    float32 and rounds the output once."""
    bf16 = qt.dtype == torch.bfloat16
    rd = (lambda x: rounded(x, torch.bfloat16)) if bf16 else (lambda x: x)
    qt, k, v, dval = qt.float(), k.float(), v.float(), dval.float()
    wk1, wk2, wv1, wv2 = rd(wk1), rd(wk2), rd(wv1), rd(wv2)
    B, N, K = nbr_mask.shape
    nh = ds.shape[2]
    kd, vd = qt.shape[2] // nh, dval.shape[2] // nh
    R, dev = B * N, qt.device
    qt3, ds2, dval3 = qt.reshape(R, nh, kd), ds.reshape(R, nh), dval.reshape(R, nh, vd)
    mask, dist2 = nbr_mask.reshape(R, K), dist.reshape(R, K)
    if gathered:  # each slot's own row
        kslot, vslot = k.reshape(R * K, nh, kd), v.reshape(R * K, nh, vd)
    else:
        rows = (torch.arange(R, device=dev)[:, None] // N * N + nbr.reshape(R, K).long()).reshape(-1)
        kslot, vslot = k.reshape(R, nh, kd)[rows], v.reshape(R, nh, vd)[rows]
    scale = 1.0 / math.sqrt(kd)
    mode, cnt = plan_fwd_rows(mask, ds2)
    bits = lambda x: x.contiguous().view(torch.int32)
    for r in range(1, R):  # a dead-weighted row with the slot inputs of the row before it
        same = torch.equal(bits(dist2[r]), bits(dist2[r - 1])) and (
            torch.equal(bits(vslot[r * K:(r + 1) * K]), bits(vslot[(r - 1) * K:r * K]))
            if gathered else torch.equal(nbr.reshape(R, K)[r], nbr.reshape(R, K)[r - 1]))
        if mode[r] == DEAD and r % N and mode[r - 1] in (DEAD, COPY) and same:
            mode[r], cnt[r] = COPY, 0
    out = torch.full((R, nh, vd), float("nan"), device=dev)
    usum = {}  # the dead-weighted rows' unweighted sums, for their copies
    walked = dict(live=0, dead=0, redone=0, slots=0)
    chunks_of = lambda c: -(-c // CHUNK)
    for lo, hi in block_ranges(cnt, blocks):
        cur, redo = lo, []
        while True:
            rows_t = []  # the tile's rows: (node, mode)
            if redo:
                take = min(len(redo), tile // K, 32)
                rows_t, redo = [(n, WHOLE) for n in redo[:take]], redo[take:]
            else:
                used = chunks = 0
                while (cur < hi and len(rows_t) < tile_rows and used + cnt[cur] <= tile
                       and chunks + chunks_of(cnt[cur]) <= MAX_CHUNKS):
                    rows_t.append((cur, mode[cur]))
                    used += cnt[cur]
                    chunks += chunks_of(cnt[cur])
                    cur += 1
            if not rows_t:
                break
            # the k-section (live and whole rows) first, then the dead-weighted rows
            order = [r for r in rows_t if r[1] != DEAD] + [r for r in rows_t if r[1] == DEAD]
            sl_node, sl_p, spans = [], [], []
            for n, md in order:
                ps = (mask[n].nonzero()[:, 0].tolist() if md == LIVE else [] if md == COPY
                      else list(range(K)))
                spans.append((len(sl_node), len(sl_node) + len(ps)))
                sl_node += [n] * len(ps)
                sl_p += ps
            nsk = sum(e - b for (_, md), (b, e) in zip(order, spans) if md != DEAD)
            T = len(sl_node)
            walked["slots"] += T
            node_t = torch.tensor(sl_node, dtype=torch.long, device=dev)
            flat = node_t * K + torch.tensor(sl_p, dtype=torch.long, device=dev)
            live_t = mask.reshape(-1)[flat]
            diff = dist2.reshape(-1)[flat][:, None] - centers
            E = rd(-torch.exp(coeff * diff * diff))
            Wv = rd(mm(rd(_ssp(mm(E, wv1) + bv1)), wv2) + bv2)  # every slot
            Wk = rd(mm(rd(_ssp(mm(E[:nsk], wk1) + bk1)), wk2) + bk2)  # the k-section
            S = torch.full((T, nh), -BIG, device=dev)
            S[:nsk] = torch.where(live_t[:nsk, None],
                                  rd(qt3[node_t[:nsk]] * Wk[:, None, :] * kslot[flat[:nsk]])
                                  .sum(-1) * scale, torch.full((nsk, nh), -BIG, device=dev))
            for (n, md), (m0, m1) in zip(order, spans):
                if md == COPY:  # written from its source's sums after the tiles
                    continue
                if md == DEAD:  # the softmax in closed form: K slots at -1e9 and the self slot
                    a, a_self = torch.ones(m1 - m0, nh, device=dev), None  # unweighted sums
                    walked["dead"] += 1
                else:
                    mx = ds2[n].clone()
                    if m1 > m0:
                        mx = torch.maximum(mx, S[m0:m1].max(0).values)
                    if md == LIVE and bool((torch.exp(-BIG - mx) != 0).any()):
                        redo.append(n)  # it writes nothing now
                        walked["redone"] += 1
                        continue
                    e, es = torch.exp(S[m0:m1] - mx), torch.exp(ds2[n] - mx)
                    l = es + e.sum(0)
                    a, a_self = rd(e / l), rd(es / l)
                    walked["live"] += md == LIVE
                terms = a[:, :, None] * Wv[m0:m1, None, :] * vslot[flat[m0:m1]]
                agg = torch.zeros(nh, vd, device=dev)
                for c0 in range(0, m1 - m0, CHUNK):  # the chunks' sums, in chunk order
                    agg = agg + terms[c0:c0 + CHUNK].sum(0)
                if md == DEAD:
                    usum[n] = agg
                    out[n] = _dead_row(ds2[n], K, agg, dval3[n], rd)
                else:
                    out[n] = agg + a_self[:, None] * dval3[n]
    for row in range(R):  # each copy from the nearest row before it that is not one
        if mode[row] == COPY:
            src = row - 1
            while mode[src] == COPY:
                src -= 1
            out[row] = _dead_row(ds2[row], K, usum[src], dval3[row], rd)
    if stats is not None:
        stats.update(walked, copied=sum(1 for x in mode if x == COPY))
    out = out.reshape(B, N, nh * vd)
    return out.to(torch.bfloat16) if bf16 else out


def _dead_row(ds, K, usum, dval, rd=lambda x: x):
    """A dead-weighted row's output: its softmax in closed form (K slots at
    -1e9 and the self slot), a_dead times the slots' unweighted sums, plus
    a_self dval (``rd``: the weights' rounding)."""
    mx = torch.clamp(ds, min=-BIG)
    ed, es = torch.exp(-BIG - mx), torch.exp(ds - mx)
    l = K * ed + es
    return rd(ed / l)[:, None] * usum + rd(es / l)[:, None] * dval


def list_backward(qt, k, v, nbr, nbr_mask, dist, ds, dval, centers,
                  wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, g, *, gathered=False,
                  mm=torch.matmul, blocks=1, tile=128, tile_rows=64, stats=None):
    """K1b's algorithm on ``neighbor_attn_bwd_plain``'s arguments (K7b's,
    those of ``neighbor_attn_hybrid_bwd_plain``, with ``gathered``): the 13
    gradients. ``stats``, a dict, gets the rows skipped and the rows taken
    again."""
    from singa_tpu_torch.ops.cuda.neighbor_attn import transpose_slots

    B, N, K = nbr_mask.shape
    nh = ds.shape[2]
    kd, vd = qt.shape[2] // nh, dval.shape[2] // nh
    R, dev = B * N, qt.device
    qt3, g3 = qt.reshape(R, nh, kd), g.reshape(R, nh, vd)
    ds2, dval3 = ds.reshape(R, nh), dval.reshape(R, nh, vd)
    mask, dist2 = nbr_mask.reshape(R, K), dist.reshape(R, K)
    if gathered:  # each slot's own row
        kslot, vslot = k.reshape(R * K, nh, kd), v.reshape(R * K, nh, vd)
    else:
        rows = (torch.arange(R, device=dev)[:, None] // N * N + nbr.reshape(R, K).long()).reshape(-1)
        kslot, vslot = k.reshape(R, nh, kd)[rows], v.reshape(R, nh, vd)[rows]
    scale = 1.0 / math.sqrt(kd)
    mode, cnt = plan_rows(mask, g3)
    nan = lambda *s: torch.full(s, float("nan"), device=dev)
    s_wk, s_wv, s_a, s_dsc = nan(R * K, kd), nan(R * K, vd), nan(R * K, nh), nan(R * K, nh)
    dqt, dds, ddv = nan(R, nh, kd), nan(R, nh), nan(R, nh, vd)
    weights = (wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    grads = [torch.zeros_like(w) for w in weights]
    redone = 0
    for lo, hi in block_ranges(cnt, blocks):
        bsum = [torch.zeros_like(w) for w in weights]
        cur, redo = lo, []
        while True:
            rows_t = []  # the tile's rows: (node, mode)
            if redo:
                take = min(len(redo), tile // K, 32)
                rows_t, redo = [(n, WHOLE) for n in redo[:take]], redo[take:]
            else:
                used = 0
                while cur < hi and len(rows_t) < tile_rows and used + cnt[cur] <= tile:
                    rows_t.append((cur, mode[cur]))
                    used += cnt[cur]
                    cur += 1
            if not rows_t:
                break
            sl_node, sl_p, spans = [], [], []
            for n, md in rows_t:
                ps = (mask[n].nonzero()[:, 0].tolist() if md == LIVE
                      else list(range(K)) if md == WHOLE else [])
                spans.append((len(sl_node), len(sl_node) + len(ps)))
                sl_node += [n] * len(ps)
                sl_p += ps
            node_t = torch.tensor(sl_node, dtype=torch.long, device=dev)
            flat = node_t * K + torch.tensor(sl_p, dtype=torch.long, device=dev)
            T = len(sl_node)
            live_t = mask.reshape(-1)[flat]
            diff = dist2.reshape(-1)[flat][:, None] - centers
            E = -torch.exp(coeff * diff * diff)
            Pk, Pv = mm(E, wk1) + bk1, mm(E, wv1) + bv1
            Hk, Hv = _ssp(Pk), _ssp(Pv)
            Wk, Wv = mm(Hk, wk2) + bk2, mm(Hv, wv2) + bv2
            kr, vr = kslot[flat], vslot[flat]
            S = (qt3[node_t] * Wk[:, None, :] * kr).sum(-1) * scale
            S = torch.where(live_t[:, None], S, torch.full_like(S, -BIG))
            D = (g3[node_t] * Wv[:, None, :] * vr).sum(-1)
            A, DSC = torch.zeros(T, nh, device=dev), torch.zeros(T, nh, device=dev)
            for (n, md), (m0, m1) in zip(rows_t, spans):
                if md == ZERO:
                    dqt[n], dds[n], ddv[n] = 0.0, 0.0, 0.0
                    s_a[n * K:(n + 1) * K], s_dsc[n * K:(n + 1) * K] = 0.0, 0.0
                    continue
                mx = ds2[n].clone()
                if m1 > m0:
                    mx = torch.maximum(mx, S[m0:m1].max(0).values)
                if md == LIVE and bool((torch.exp(-BIG - mx) != 0).any()):
                    redo.append(n)  # its slots send nothing now
                    redone += 1
                    continue
                das = (g3[n] * dval3[n]).sum(-1)
                es = torch.exp(ds2[n] - mx)
                e = torch.exp(S[m0:m1] - mx)
                l = es + e.sum(0)
                dotn = (es * das + (e * D[m0:m1]).sum(0)) / l
                a_self = es / l
                dds[n], ddv[n] = a_self * (das - dotn), a_self[:, None] * g3[n]
                a = e / l
                dsc = torch.where(live_t[m0:m1, None], a * (D[m0:m1] - dotn) * scale,
                                  torch.zeros_like(a))
                A[m0:m1], DSC[m0:m1] = a, dsc
                dqt[n] = (dsc[:, :, None] * Wk[m0:m1, None, :] * kr[m0:m1]).sum(0)
                s_a[n * K:(n + 1) * K], s_dsc[n * K:(n + 1) * K] = 0.0, 0.0
                f = flat[m0:m1]
                s_wk[f], s_wv[f], s_a[f], s_dsc[f] = Wk[m0:m1], Wv[m0:m1], a, dsc
            if T == 0:
                continue
            # the tile's weight gradients, summed from zero
            dwk = (DSC[:, :, None] * qt3[node_t] * kr).sum(1)
            dwv = (A[:, :, None] * g3[node_t] * vr).sum(1)
            dhk = mm(dwk, wk2.T) * torch.sigmoid(Pk)
            dhv = mm(dwv, wv2.T) * torch.sigmoid(Pv)
            tile_sums = [mm(E.T, dhk), dhk.sum(0), mm(Hk.T, dwk), dwk.sum(0),
                         mm(E.T, dhv), dhv.sum(0), mm(Hv.T, dwv), dwv.sum(0)]
            bsum = [x + y for x, y in zip(bsum, tile_sums)]
        grads = [x + y for x, y in zip(grads, bsum)]
    # dk/dv: each row gathers the slots that name it, in CSR order, but those
    # whose a and dsc are zero in every head (their w_k and w_v unwritten)
    offsets, slots = (x.long() for x in transpose_slots(nbr.reshape(B, N, K).int()))
    dk, dv = torch.zeros(R, nh, kd, device=dev), torch.zeros(R, nh, vd, device=dev)
    for j in range(R):
        ss = slots[offsets[j]:offsets[j + 1]]
        ss = ss[((s_dsc[ss] != 0) | (s_a[ss] != 0)).any(1)]
        src = ss // K
        dk[j] = (s_dsc[ss, :, None] * s_wk[ss, None, :] * qt3[src]).sum(0)
        dv[j] = (s_a[ss, :, None] * s_wv[ss, None, :] * g3[src]).sum(0)
    if stats is not None:
        stats.update(zero=sum(1 for x in mode if x == ZERO), redone=redone)
    shape = lambda x, c: x.reshape(B, N, c)
    return [shape(dqt, nh * kd), shape(dk, nh * kd), shape(dv, nh * vd), shape(dds, nh),
            shape(ddv, nh * vd), *grads]


def _weights(rng, De, kd, vd):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return [np.linspace(0.0, 15.0, De, dtype=np.float32),
            0.3 * f(De, kd), 0.1 * f(kd), 0.3 * f(kd, kd), 0.1 * f(kd),
            0.3 * f(De, vd), 0.1 * f(vd), 0.3 * f(vd, vd), 0.1 * f(vd)]


def _coeff(De=DE):
    width = 15.0 / (De - 1)
    return -0.5 / (width * width)


def _random_case(seed, redo=False, copies=False):
    """K1b's arguments (numpy): random masks (not prefixes), a repeated
    neighbour, a real row with no live slot, padded rows (self score -1e9,
    no live slot) of which two have a zero cotangent and one does not; and
    with ``redo`` a padded row with one live slot whose score is far below
    -1e9 (its max is the self score: its dead slots keep their weight); with
    ``copies`` the three padded rows of graph 1 read the same neighbours at
    the same distances, as the corpus's padded nodes do (all at the
    origin): the forward takes the last two as copies of the first."""
    B, N, K = 2, 16, 7
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    nbr = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    nbr[0, 2, :4] = 9
    mask = rng.random((B, N, K)) > 0.3
    mask[0, 3] = False
    ds = f(B, N, H)
    ds[1, N - 3:], mask[1, N - 3:] = -1e9, False
    arrays = [f(B, N, H * KD), f(B, N, H * KD), f(B, N, H * VD), nbr, mask,
              rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * VD),
              *_weights(rng, DE, KD, VD)]
    g = f(B, N, H * VD)
    g[1, N - 2:] = 0.0
    if copies:
        nbr[1, N - 2:], arrays[5][1, N - 2:] = nbr[1, N - 3], arrays[5][1, N - 3]
    if redo:
        ds[0, 9], mask[0, 9] = -1e9, False
        mask[0, 9, 4] = True
        t = torch.as_tensor
        diff = t(arrays[5][0, 9, 4]) - t(arrays[8])
        e = -torch.exp(_coeff() * diff * diff)
        w_k = (_ssp(e @ t(arrays[9]) + t(arrays[10])) @ t(arrays[11]) + t(arrays[12])).numpy()
        krow = arrays[1][0, nbr[0, 9, 4]].reshape(H, KD)
        arrays[0][0, 9] = (-1e11 * np.sign(w_k * krow)).reshape(-1)
    return arrays, g


def _mha_case():
    """The inputs and cotangent NeighborGraphMHA hands neighbor_attn on the
    CPU: a small graph with padded nodes, random parameters, the loss
    sum(out * w); the cotangent is zero on every padded row."""
    from singa_tpu_torch.models import neighbor_graph as ng

    rng = np.random.default_rng(23)
    B, N, C = 2, 14, 16
    pos = rng.uniform(-5, 5, size=(B, N, 3)).astype(np.float32)
    node_mask = np.ones((B, N), bool)
    node_mask[1, -4:] = False
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mha = ng.NeighborGraphMHA(C, H * KD, H, DE, 15.0, device="cpu")
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.as_tensor(0.3 * rng.normal(size=p.shape).astype(np.float32)))
    graph = ng.build_neighbor_graph(torch.as_tensor(pos), torch.as_tensor(node_mask), 3, 15.0, DE)
    seen = {}
    orig = ng.neighbor_attn

    def record(*args):
        out = orig(*args)
        seen["args"] = [a.detach().clone() if torch.is_tensor(a) else a for a in args[:18]]
        out.register_hook(lambda grad: seen.__setitem__("g", grad.detach().clone()))
        return out

    ng.neighbor_attn = record
    try:
        out = mha(torch.as_tensor(x), graph)
        (out * torch.as_tensor(rng.normal(size=out.shape).astype(np.float32))).sum().backward()
    finally:
        ng.neighbor_attn = orig
    arrays = [a.numpy() if torch.is_tensor(a) else a for a in seen["args"][:17]]
    return arrays, seen["g"].numpy(), seen["args"][17]


CASES = {"random": lambda: (*_random_case(41), _coeff()),
         "redo": lambda: (*_random_case(43, redo=True), _coeff()),
         "copies": lambda: (*_random_case(59, copies=True), _coeff()),
         "mha": lambda: (lambda a, g, c: (a, g, c))(*_mha_case())}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


@functools.lru_cache(maxsize=None)
def _jax_reference(name, form):
    """JAX's neighbor_attn_fused or neighbor_attn_hybrid (Pallas, interpret
    mode): the VJP at the case's cotangent."""
    import jax
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_fused, neighbor_attn_hybrid

    arrays, g, coeff = _case(name)
    fn = neighbor_attn_hybrid if form == "gathered" else neighbor_attn_fused

    def f(*diff):
        a = list(map(jnp.asarray, arrays))
        for i, d in zip(DIFF_AT, diff):
            a[i] = d
        return fn(*a, coeff, True)

    with compute_dtype_scope("float32"):
        _, vjp = jax.vjp(f, *(jnp.asarray(arrays[i]) for i in DIFF_AT))
        return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _form_args(arrays, g, coeff, form):
    """The rendering's and the plain twin's arguments: K1b's, or K7b's with
    the rows gathered."""
    from singa_tpu_torch.ops.cuda.neighbor_attn import gather_rows

    ts = [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]
    if form == "gathered":
        ts[1], ts[2] = gather_rows(ts[1], ts[3]), gather_rows(ts[2], ts[3])
    return [*ts, coeff, torch.as_tensor(g)]


def _close_all(got, want, what):
    for name, a, b in zip(GRAD_NAMES, got, want):
        b = np.asarray(b)
        scale = max(1e-6, float(np.abs(b).max())) if b.size else 1e-6
        np.testing.assert_allclose(a.detach().numpy(), b, atol=2e-5 * scale, rtol=1e-5,
                                   err_msg=f"{what}: {name}")



def _close_out(got, want, what):
    want = np.asarray(want)
    scale = max(1e-6, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5 * scale, rtol=1e-5,
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_forward(name, form):
    """JAX's neighbor_attn_fused or neighbor_attn_hybrid (Pallas, interpret
    mode) on the case's inputs."""
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_fused, neighbor_attn_hybrid

    arrays, _, coeff = _case(name)
    fn = neighbor_attn_hybrid if form == "gathered" else neighbor_attn_fused
    with compute_dtype_scope("float32"):
        return np.asarray(fn(*map(jnp.asarray, arrays), coeff, True))

# (blocks, tile, tile_rows): one block and the kernel's tiles; three blocks
# and tiles small enough that rows split across many (K 7 <= 8 slots); one
# row a tile, as the CUDA-core instance takes them (a node at a time, a row
# taken again whole right after)
TILINGS = [(1, 128, 64), (3, 8, 3), (2, 128, 1)]


@pytest.mark.parametrize("blocks,tile,tile_rows", TILINGS)
@pytest.mark.parametrize("form", ["list", "gathered"])
@pytest.mark.parametrize("name", list(CASES))
def test_list_algorithm_matches_plain_and_jax(name, form, blocks, tile, tile_rows):
    """The list forms' algorithm == the all-slots plain twin and JAX's
    Pallas kernel's VJP, every gradient: random masks with a padded row
    whose cotangent is not zero (taken whole) and two whose cotangent is,
    a real row with no live slot; a live row taken again whole; the path's
    own cotangent from a small NeighborGraphMHA (zero on padded rows, none
    taken whole). No output is left unwritten (the scratch and outputs
    start as NaN)."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    arrays, g, coeff = _case(name)
    args = _form_args(arrays, g, coeff, form)
    stats = {}
    got = list_backward(*args, gathered=form == "gathered", blocks=blocks, tile=tile,
                        tile_rows=tile_rows, stats=stats)
    assert not any(bool(torch.isnan(x).any()) for x in got)
    plain = k1.neighbor_attn_hybrid_bwd_plain if form == "gathered" else k1.neighbor_attn_bwd_plain
    _close_all(got, plain(*args), "vs plain")
    _close_all(got, _jax_reference(name, form), "vs JAX")
    if name in ("random", "copies"):  # the padded row with a cotangent is taken again, whole
        assert stats["zero"] == 2 and stats["redone"] == 1
    elif name == "redo":  # and the live row whose score is far below -1e9
        assert stats["zero"] == 2 and stats["redone"] == 2
    else:  # the model path: the padded rows' cotangent is zero, no row is taken again
        assert stats["zero"] == 4 and stats["redone"] == 0


def test_rows_without_a_live_slot_follow_the_float32_underflow():
    """A row with no live slot is taken again, whole, exactly when
    exp(-1e9 - m) is not 0 in float32 in some head: a self score of -1e9 (a
    padded row) or below, not one 200 above; either way every gradient is
    the plain twin's."""
    from singa_tpu_torch.ops.cuda.neighbor_attn import neighbor_attn_bwd_plain

    rng = np.random.default_rng(47)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    B, N, K = 1, 4, 3
    ds = np.array([[[-1e9, 0.3], [-2e9, -1e9], [-1e9 + 200, 1.0], [0.5, -0.5]]], np.float32)
    arrays = [f(B, N, H * KD), f(B, N, H * KD), f(B, N, H * VD),
              rng.integers(0, N, size=(B, N, K)).astype(np.int32), np.zeros((B, N, K), bool),
              rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * VD),
              *_weights(rng, DE, KD, VD)]
    args = _form_args(arrays, f(B, N, H * VD), _coeff(), "list")
    stats = {}
    got = list_backward(*args, stats=stats)
    assert stats == {"zero": 0, "redone": 2}
    _close_all(got, neighbor_attn_bwd_plain(*args), "vs plain")


@pytest.mark.parametrize("blocks,tile,tile_rows", TILINGS)
@pytest.mark.parametrize("form", ["list", "gathered"])
@pytest.mark.parametrize("name", list(CASES))
def test_list_forward_matches_plain_and_jax(name, form, blocks, tile, tile_rows):
    """The list forms' forward algorithm == the all-slots plain twin and
    JAX's Pallas kernel, every row: random masks (not prefixes) with a
    repeated neighbour, padded rows (self score -1e9, no live slot:
    dead-weighted, their softmax uniform) and a real row with no live slot
    (out = dval); a live row whose score sits far below -1e9, taken again
    whole; the inputs of a small NeighborGraphMHA. Tiles of 8 slots and 3
    rows put the tile boundaries between many rows; one row a tile takes a
    row taken again right after it. No row is left unwritten (the output
    starts as NaN)."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    arrays, g, coeff = _case(name)
    args = _form_args(arrays, g, coeff, form)[:-1]
    stats = {}
    got = list_forward(*args, gathered=form == "gathered", blocks=blocks, tile=tile,
                       tile_rows=tile_rows, stats=stats)
    assert not bool(torch.isnan(got).any())
    plain = k1.neighbor_attn_hybrid_plain if form == "gathered" else k1.neighbor_attn_plain
    want = plain(*(args[:3] + args[4:]) if form == "gathered" else args)
    _close_out(got, want, "vs plain")
    _close_out(got, _jax_forward(name, form), "vs JAX")
    B, N, K = arrays[4].shape
    padded = {"random": 3, "redo": 3, "mha": 4, "copies": 3}[name]
    copied = 2 if name == "copies" else 0
    redone = 1 if name == "redo" else 0
    assert (stats["dead"], stats["copied"], stats["redone"]) == (padded - copied, copied, redone)
    assert stats["live"] + stats["dead"] + stats["copied"] + stats["redone"] == B * N
    live_slots = int(arrays[4].sum()) + redone * K
    assert stats["slots"] == live_slots + (padded - copied) * K


BF16_TOL = 1e-2  # a bfloat16 output's largest error, of its largest magnitude (chip_smoke.py's)
BF16_AT = (0, 1, 2, 7)  # qt, k, v and diag_value: bfloat16 in K1's bfloat16 instance


@functools.lru_cache(maxsize=None)
def _jax_forward_bf16(name):
    """JAX's neighbor_attn_fused (Pallas, interpret mode) at bfloat16 qt, k,
    v and diag_value on the case's inputs, as float32 numpy."""
    import jax.numpy as jnp

    from singa_tpu.dtypes import compute_dtype_scope
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_fused

    arrays, _, coeff = _case(name)
    args = [jnp.asarray(a, jnp.bfloat16) if i in BF16_AT else jnp.asarray(a)
            for i, a in enumerate(arrays)]
    with compute_dtype_scope("float32"):
        out = neighbor_attn_fused(*args, coeff, True)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


def _close_bf16(got, want, what):
    """A bfloat16 output within BF16_TOL of the reference's largest
    magnitude: both round the same values at the same points and sum in
    another order, so a value on a rounding boundary lands a bfloat16 step
    away and carries into what follows."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_TOL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("blocks,tile,tile_rows", TILINGS)
@pytest.mark.parametrize("name", list(CASES))
def test_list_forward_bf16_matches_plain_and_jax(name, blocks, tile, tile_rows):
    """K1's bfloat16 instance's algorithm (``list_forward`` at bfloat16 qt,
    k, v and diag_value: live slots only, the closed-form dead-weighted
    rows, the copies, the rows taken again) == the all-slots bfloat16 twin
    ``neighbor_attn_bf16_plain`` and JAX's Pallas kernel at bfloat16, every
    row within BF16_TOL; the rows it walks are the float32 algorithm's (a
    dead slot still adds an exact zero)."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    arrays, g, coeff = _case(name)
    args = _form_args(arrays, g, coeff, "list")[:-1]
    args = [a.to(torch.bfloat16) if i in BF16_AT else a for i, a in enumerate(args)]
    stats, stats32 = {}, {}
    got = list_forward(*args, blocks=blocks, tile=tile, tile_rows=tile_rows, stats=stats)
    assert got.dtype == torch.bfloat16 and not bool(torch.isnan(got).any())
    _close_bf16(got, k1.neighbor_attn_bf16_plain(*args).float(), "vs plain")
    _close_bf16(got, _jax_forward_bf16(name), "vs JAX")
    list_forward(*_form_args(arrays, g, coeff, "list")[:-1], blocks=blocks, tile=tile,
                 tile_rows=tile_rows, stats=stats32)
    assert stats == stats32
    # the roundings inside are the bfloat16 function's: the float32
    # algorithm's output, rounded once, is another
    f32 = list_forward(*_form_args(arrays, g, coeff, "list")[:-1], blocks=blocks, tile=tile,
                       tile_rows=tile_rows)
    assert not torch.equal(got.float(), f32.to(torch.bfloat16).float())


def test_forward_rows_without_a_live_slot_follow_the_float32_underflow():
    """A row with no live slot is dead-weighted exactly when exp(-1e9 - m)
    is not 0 in float32 in some head (m the larger of the self score and
    -1e9): a self score of -1e9 (a padded row) or below, not one 200 above,
    nor a finite one (there out = dval); either way the output is the plain
    twin's."""
    from singa_tpu_torch.ops.cuda.neighbor_attn import neighbor_attn_plain

    rng = np.random.default_rng(53)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    B, N, K = 1, 4, 3
    ds = np.array([[[-1e9, 0.3], [-2e9, -1e9], [-1e9 + 200, 1.0], [0.5, -0.5]]], np.float32)
    arrays = [f(B, N, H * KD), f(B, N, H * KD), f(B, N, H * VD),
              rng.integers(0, N, size=(B, N, K)).astype(np.int32), np.zeros((B, N, K), bool),
              rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * VD),
              *_weights(rng, DE, KD, VD)]
    args = _form_args(arrays, f(B, N, H * VD), _coeff(), "list")[:-1]
    stats = {}
    got = list_forward(*args, stats=stats)
    assert stats == {"live": 2, "dead": 2, "redone": 0, "slots": 2 * K, "copied": 0}
    _close_out(got, neighbor_attn_plain(*args), "vs plain")
    torch.testing.assert_close(got[0, 2:], args[7][0, 2:], atol=0, rtol=0)
