"""The dense form's live-column algorithm (K8/K8b's kernels) against its
definition: a plain PyTorch rendering of what the kernels do, written here
for the tests only, held to ``dense_edge_attn_plain`` / ``_bwd_plain``
(every column evaluated) and to JAX's ``dense_edge_attn`` (Pallas, interpret
mode) and its custom VJP, forward and every gradient; and the lists
``live_columns`` builds from ``adj_dist``.

The rendering walks each row's live columns in ragged tiles with the online
softmax, takes the rows with no live column in closed form (a padded row's
uniform softmax over the N + 1 slots, an isolated real row's self weight of
1), sweeps a row's tiles twice in the backward, keeps per live pair w_k,
w_v, a and dsc, gathers dk/dv over the CSR transpose, and adds the
closed-form rows' per-graph terms to dv and to the v-EdgeMLP's gradients.

Inputs are numpy-seeded and float32. Tolerances: atol 2e-5, rtol 1e-5 on the
O(1) outputs; a gradient's atol is 2e-5 times its own largest magnitude
(weight gradients are sums over every live pair, taken in another order).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import close, t

BIG = 1e9
H, KD, VD, DE = 2, 8, 8, 8
GRAD_NAMES = ["dqt", "dk", "dv", "dds", "ddv", "dwk1", "dbk1", "dwk2", "dbk2",
              "dwv1", "dbv1", "dwv2", "dbv2"]
DIFF_AT = [0, 1, 2, 4, 5, *range(7, 15)]  # the differentiable arguments


def _ssp(x):
    return F.softplus(x) - math.log(2.0)


# (B, N, live share, padded rows per graph, isolated real rows): a mix of
# live, isolated and padded rows; a graph whose rows are all padded; dense
# rows (live counts well above a small tile); one node per graph
CASES = {
    "mixed": (2, 20, 0.3, (0, 4), ((0, 2),)),
    "all_padded_graph": (2, 12, 0.4, (0, 12), ()),
    "dense_rows": (1, 24, 0.8, (3,), ((0, 5),)),
    "one_node": (2, 1, 0.5, (0, 0), ()),
}


def _inputs(name):
    """K8's arguments (numpy) and a cotangent that is non-zero on every row,
    the padded ones included. adj_dist is BIG on the diagonal, on padded
    rows and columns and on dead pairs, a distance elsewhere."""
    B, N, share, padded, isolated = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    valid = np.ones((B, N), bool)
    for b, p in enumerate(padded):
        if p:
            valid[b, N - p:] = False
    live = rng.random((B, N, N)) < share
    live[:, np.arange(N), np.arange(N)] = False
    live &= valid[:, :, None] & valid[:, None, :]
    for b, i in isolated:
        live[b, i, :] = False
    adj = np.where(live, rng.uniform(0.5, 14.0, size=(B, N, N)), BIG).astype(np.float32)
    ds = np.where(valid[..., None], f(B, N, H), np.float32(-1e9)).astype(np.float32)
    weights = [np.linspace(0.0, 15.0, DE, dtype=np.float32),
               0.3 * f(DE, KD), 0.1 * f(KD), 0.3 * f(KD, KD), 0.1 * f(KD),
               0.3 * f(DE, VD), 0.1 * f(VD), 0.3 * f(VD, VD), 0.1 * f(VD)]
    arrays = [f(B, N, H * KD), f(B, N, H * KD), f(B, N, H * VD), adj, ds, f(B, N, H * VD),
              *weights]
    return arrays, f(B, N, H * VD)


def _coeff():
    width = 15.0 / (DE - 1)
    return -0.5 / (width * width)


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """JAX's dense_edge_attn (Pallas, interpret mode): output and VJP."""
    from singa_tpu.ops.pallas.dense_edge_attn import dense_edge_attn as jdense

    arrays, g = _inputs(name)

    def fn(*diff):
        a = list(map(jnp.asarray, arrays))
        for i, d in zip(DIFF_AT, diff):
            a[i] = d
        return jdense(*a, _coeff(), True)

    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(fn, *(jnp.asarray(arrays[i]) for i in DIFF_AT))
        grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


class _Mlp:
    """The two EdgeMLPs on a tile's distances, keeping what the backward
    needs."""

    def __init__(self, dist, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff):
        diff = dist[:, None] - centers
        self.e = -torch.exp(coeff * diff * diff)
        self.pk, self.pv = self.e @ wk1 + bk1, self.e @ wv1 + bv1
        self.hk, self.hv = _ssp(self.pk), _ssp(self.pv)
        self.wk, self.wv = self.hk @ wk2 + bk2, self.hv @ wv2 + bv2


def _tiles(e0, e1, tile):
    return [(c, min(c + tile, e1)) for c in range(e0, e1, tile)]


def live_forward(arrays, lists, tile):
    """K8's algorithm: per row, its live columns in tiles of at most
    ``tile`` with the online softmax, or the closed form."""
    qt, k, v, adj, ds, dval, centers, *w, coeff = [t(a) for a in arrays[:15]] + [_coeff()]
    B, N, _ = qt.shape
    qt, k = qt.reshape(B * N, H, KD), k.reshape(B * N, H, KD)
    v, dval = v.reshape(B * N, H, VD), dval.reshape(B * N, H, VD)
    adj, ds = adj.reshape(B * N, N), ds.reshape(B * N, H)
    wv1, bv1, wv2, bv2 = w[4:]
    vsum = v.reshape(B, N, H, VD).sum(1)
    w0 = _ssp(bv1) @ wv2 + bv2
    out = torch.empty(B * N, H, VD)
    off = lists.row_offsets.long()
    for r in lists.row_order.tolist():  # the kernels' order
        b, e0, e1 = r // N, int(off[r]), int(off[r + 1])
        if e0 == e1:
            m = torch.clamp(ds[r], min=-BIG)
            ed, es = torch.exp(-BIG - m), torch.exp(ds[r] - m)
            l = N * ed + es
            out[r] = (ed / l)[:, None] * w0 * vsum[b] + (es / l)[:, None] * dval[r]
            continue
        m, l, acc = ds[r].clone(), torch.ones(H), dval[r].clone()
        for c0, c1 in _tiles(e0, e1, tile):
            cols = lists.cols[c0:c1].long()
            mlp = _Mlp(adj[r, cols], centers, *w, coeff)
            s = (qt[r] * mlp.wk[:, None, :] * k[b * N + cols]).sum(-1) / math.sqrt(KD)
            m_new = torch.maximum(m, s.max(0).values)
            e, al = torch.exp(s - m_new), torch.exp(m - m_new)
            l = l * al + e.sum(0)
            acc = acc * al[:, None] + (e[:, :, None] * mlp.wv[:, None, :] * v[b * N + cols]).sum(0)
            m = m_new
        out[r] = acc / l[:, None]
    return out.reshape(B, N, H * VD)


def live_backward(arrays, g, lists, tile):
    """K8b's algorithm: the pair sweeps over the live lists (per-pair
    scratch), the closed-form rows, their per-graph terms, and dk/dv
    gathered over the CSR transpose. Returns the 13 gradients."""
    qt, k, v, adj, ds, dval, centers, *w, coeff = [t(a) for a in arrays[:15]] + [_coeff()]
    wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2 = w
    B, N, _ = qt.shape
    qt, k = qt.reshape(B * N, H, KD), k.reshape(B * N, H, KD)
    v, dval = v.reshape(B * N, H, VD), dval.reshape(B * N, H, VD)
    adj, ds = adj.reshape(B * N, N), ds.reshape(B * N, H)
    g = t(g).reshape(B * N, H, VD)
    scale = 1.0 / math.sqrt(KD)
    vsum = v.reshape(B, N, H, VD).sum(1)
    w0 = _ssp(bv1) @ wv2 + bv2
    E = lists.cols.shape[0]
    s_wk, s_wv = torch.zeros(E, KD), torch.zeros(E, VD)
    s_a, s_dsc = torch.zeros(E, H), torch.zeros(E, H)
    s_ad = torch.zeros(B * N, H)
    dqt, dds, ddv = torch.zeros(B * N, H, KD), torch.zeros(B * N, H), torch.zeros(B * N, H, VD)
    wg = [torch.zeros_like(x) for x in w]  # dwk1 dbk1 dwk2 dbk2 dwv1 dbv1 dwv2 dbv2
    off = lists.row_offsets.long()

    def tile_forward(r, cols):
        b = r // N
        mlp = _Mlp(adj[r, cols], centers, *w, coeff)
        s = (qt[r] * mlp.wk[:, None, :] * k[b * N + cols]).sum(-1) * scale
        da = (g[r] * mlp.wv[:, None, :] * v[b * N + cols]).sum(-1)
        return mlp, s, da

    for r in lists.row_order.tolist():  # the kernels' order
        b, e0, e1 = r // N, int(off[r]), int(off[r + 1])
        da_self = (g[r] * dval[r]).sum(-1)
        if e0 == e1:  # the closed form
            m = torch.clamp(ds[r], min=-BIG)
            ed, es = torch.exp(-BIG - m), torch.exp(ds[r] - m)
            l = N * ed + es
            a_dead, a_self = ed / l, es / l
            dot = a_dead * (g[r] * w0 * vsum[b]).sum(-1) + a_self * da_self
            dds[r], ddv[r], s_ad[r] = a_self * (da_self - dot), a_self[:, None] * g[r], a_dead
            continue
        m, l, dot = ds[r].clone(), torch.ones(H), da_self.clone()
        tiles = _tiles(e0, e1, tile)
        for c0, c1 in tiles:  # sweep 1: max, sum and dot, online
            _, s, da = tile_forward(r, lists.cols[c0:c1].long())
            m_new = torch.maximum(m, s.max(0).values)
            e, al = torch.exp(s - m_new), torch.exp(m - m_new)
            l, dot = l * al + e.sum(0), dot * al + (e * da).sum(0)
            m = m_new
        a_self, dot = torch.exp(ds[r] - m) / l, dot / l
        dds[r], ddv[r] = a_self * (da_self - dot), a_self[:, None] * g[r]
        for c0, c1 in tiles:  # sweep 2: every live pair's gradient
            cols = lists.cols[c0:c1].long()
            mlp, s, da = tile_forward(r, cols)
            a = torch.exp(s - m) / l
            dsc = a * (da - dot) * scale
            s_wk[c0:c1], s_wv[c0:c1], s_a[c0:c1], s_dsc[c0:c1] = mlp.wk, mlp.wv, a, dsc
            krows, vrows = k[b * N + cols], v[b * N + cols]
            dqt[r] += (dsc[:, :, None] * mlp.wk[:, None, :] * krows).sum(0)
            dw_k = (dsc[:, :, None] * qt[r] * krows).sum(1)
            dw_v = (a[:, :, None] * g[r] * vrows).sum(1)
            for dw, hid, pre, w2, base in ((dw_k, mlp.hk, mlp.pk, wk2, 0),
                                           (dw_v, mlp.hv, mlp.pv, wv2, 4)):
                dh = (dw @ w2.T) * torch.sigmoid(pre)
                wg[base] += mlp.e.T @ dh
                wg[base + 1] += dh.sum(0)
                wg[base + 2] += hid.T @ dw
                wg[base + 3] += dw.sum(0)
    # the closed-form rows, per graph: G = sum of a_dead g; every column's dv
    # gets w_v0 * G, the v-EdgeMLP dw_v = sum_h G vsum through ssp(bv1)
    G = (s_ad.reshape(B, N, H, 1) * g.reshape(B, N, H, VD)).sum(1)
    dwv = (G * vsum).sum((0, 1))
    wg[6] += torch.outer(_ssp(bv1), dwv)
    wg[7] += dwv
    wg[5] += (dwv @ wv2.T) * torch.sigmoid(bv1)
    # dk/dv: each row gathers the live pairs whose column it is, in CSR order
    dk, dv = torch.zeros(B * N, H, KD), torch.zeros(B * N, H, VD)
    col_off, col_pairs, pair_rows = (x.long() for x in lists[3:5] + lists[2:3])
    for j in range(B * N):
        for e in col_pairs[int(col_off[j]):int(col_off[j + 1])]:
            src = pair_rows[e]
            dk[j] += s_dsc[e][:, None] * s_wk[e] * qt[src]
            dv[j] += s_a[e][:, None] * s_wv[e] * g[src]
        dv[j] += w0 * G[j // N]
    shape = lambda x, c: x.reshape(B, N, c)
    return [shape(dqt, H * KD), shape(dk, H * KD), shape(dv, H * VD), shape(dds, H),
            shape(ddv, H * VD), *wg]


def _close_all(got, want, what):
    for name, a, b in zip(GRAD_NAMES, got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
        close(a, b, 2e-5 * scale, 1e-5, f"{what}: {name}")


@pytest.mark.parametrize("tile", [4, 64])
@pytest.mark.parametrize("name", list(CASES))
def test_live_algorithm_matches_plain_and_jax(name, tile):
    """The live-column algorithm == the all-columns plain twin and JAX's
    Pallas kernel with its VJP, forward and every gradient, under a random
    cotangent on every row, padded ones included; tile 4 puts most live rows
    over one tile (two sweeps, online rescales)."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    arrays, g = _inputs(name)
    lists = k8.live_columns(t(arrays[3]))
    out = live_forward(arrays, lists, tile)
    grads = live_backward(arrays, g, lists, tile)
    targs = [t(a) for a in arrays] + [_coeff()]
    close(out, k8.dense_edge_attn_plain(*targs), 2e-5, 1e-5, "forward vs plain")
    _close_all(grads, k8.dense_edge_attn_bwd_plain(*targs, t(g)), "vs plain")
    jout, jgrads = _jax_reference(name)
    close(out, jout, 2e-5, 1e-5, "forward vs JAX")
    _close_all(grads, jgrads, "vs JAX")
    if name == "mixed":  # the closed-form rows send dv to every column
        padded = arrays[4][..., 0] <= -5e8
        assert padded.any() and float(grads[2][1, -4:].abs().max()) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_live_columns_match_adj_dist(name):
    """Every live pair of adj_dist once, in row-major order (ascending
    columns within a row), with its row; counts as row offsets; the
    transpose lists, for each row j, the pairs whose column is j, ascending;
    the rows in the kernels' order: by descending live count, ties by index;
    the largest live count as a Python int."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    arrays, _ = _inputs(name)
    adj = arrays[3]
    B, N, _ = adj.shape
    lists = k8.live_columns(t(adj))
    assert all(x.dtype == torch.int32 for x in lists[:6])
    live = (adj < 5e8).reshape(B * N, N)
    pairs = [(r, c) for r in range(B * N) for c in range(N) if live[r, c]]
    got = list(zip(lists.pair_rows.tolist(), lists.cols.tolist()))
    assert got == pairs
    np.testing.assert_array_equal(lists.row_offsets.numpy(),
                                  np.concatenate([[0], np.cumsum(live.sum(1))]))
    for j in range(B * N):
        e0, e1 = int(lists.col_offsets[j]), int(lists.col_offsets[j + 1])
        want = [e for e, (r, c) in enumerate(pairs) if (r // N) * N + c == j]
        assert lists.col_pairs[e0:e1].tolist() == want
    assert int(lists.col_offsets[-1]) == len(pairs)
    counts = live.sum(1)
    want_order = sorted(range(B * N), key=lambda r: (-counts[r], r))
    assert lists.row_order.tolist() == want_order
    assert type(lists.max_live) is int and lists.max_live == int(counts.max())


def test_build_neighbor_graph_carries_live_lists():
    """build_neighbor_graph(with_adj_dist=True) carries live_columns of its
    adj_dist (the lists every encoder layer's K8/K8b walk), and none
    without adj_dist; an overflow row keeps all its live columns."""
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    rng = np.random.default_rng(3)
    pos = rng.uniform(-5, 5, size=(2, 30, 3)).astype(np.float32)
    pos[0, 1:15] = pos[0, 0] + 0.3 * rng.normal(size=(14, 3))  # a crowded hub
    mask = np.ones((2, 30), bool)
    mask[1, -6:] = False
    g = build_neighbor_graph(t(pos), t(mask), 3, 15.0, 8, with_adj_dist=True)
    want = k8.live_columns(g.adj_dist)
    for a, b in zip(g.dense_lists[:6], want[:6]):
        assert torch.equal(a, b)
    assert g.dense_lists.max_live == want.max_live
    counts = (g.dense_lists.row_offsets[1:] - g.dense_lists.row_offsets[:-1])
    assert int(counts.max()) > g.nbr.shape[2]  # beyond the K of the lists
    assert int(counts[30 + 24:].sum()) == 0  # padded rows: no live column
    assert build_neighbor_graph(t(pos), t(mask), 3, 15.0, 8).dense_lists is None


def _hub_adj(B: int, N: int, hub: int, seed: int) -> np.ndarray:
    """adj_dist of B graphs of N nodes: a sparse random symmetric adjacency,
    the last graph's last three nodes padded (no live column), and, where
    ``hub`` > 0, row 0 of graph 0 live to its first ``hub`` columns (and
    they to it)."""
    rng = np.random.default_rng(seed)
    live = rng.random((B, N, N)) < 0.05
    live |= live.transpose(0, 2, 1)
    if hub:
        live[0, 0, 1:hub + 1] = live[0, 1:hub + 1, 0] = True
    live[:, np.arange(N), np.arange(N)] = False
    live[-1, -3:, :] = live[-1, :, -3:] = False
    dist = rng.uniform(0.5, 9.0, size=(B, N, N)).astype(np.float32)
    return np.where(live, dist, 1e9).astype(np.float32)


@pytest.mark.parametrize("hub", [0, 140])
def test_live_columns_record_largest_live_count(hub):
    """live_columns records the largest live count of any row once, when it
    builds the lists: on graphs whose rows all stay below K8b·bf16's tile
    of 128, and on one with a hub row live to 140 columns or more (the
    largest);
    an all-padded batch records 0."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    adj = _hub_adj(2, 200, hub, 31 + hub)
    lists = k8.live_columns(t(adj))
    counts = (adj < 5e8).sum(-1)
    assert lists.max_live == int(counts.max())
    assert (lists.max_live == int(counts[0, 0]) >= hub) if hub else (0 < lists.max_live < 128)
    assert int((lists.row_offsets[1:] - lists.row_offsets[:-1]).max()) == lists.max_live
    assert k8.live_columns(t(np.full((1, 5, 5), 1e9, np.float32))).max_live == 0


@pytest.mark.parametrize("max_live,widths,cuda_cores,want", [
    (0, (4, 32, 64, 64), False, "tensor_cores"),  # every row in closed form or skipped
    (111, (4, 32, 64, 64), False, "tensor_cores"),  # the corpus's largest row
    (128, (4, 32, 64, 64), False, "tensor_cores"),  # a row that fills a tile
    (129, (4, 32, 64, 64), False, "cuda_cores"),  # a hub row over one tile
    (383, (4, 32, 64, 64), False, "cuda_cores"),
    (111, (1, 32, 64, 64), False, "tensor_cores"),
    (111, (8, 16, 32, 64), False, "cuda_cores"),  # 8 heads at other widths
    (111, (4, 64, 64, 64), False, "cuda_cores"),  # kd 64
    (111, (4, 32, 128, 64), False, "cuda_cores"),  # vd 128
    (111, (4, 32, 64, 32), False, "cuda_cores"),  # De 32
    (111, (5, 32, 64, 64), False, "cuda_cores"),  # five heads
    (111, (4, 32, 64, 64), True, "cuda_cores"),  # asked for
])
def test_bwd_bf16_instance_by_shape(max_live, widths, cuda_cores, want):
    """The rule that picks K8b·bf16's kernels before the launch: its
    tensor-core ones at the encoder's widths (kd 32, vd 64, De 64), at most
    four heads and lists whose rows each fit one 128-slot tile, else (or
    asked for) its CUDA-core ones."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    H, kd, vd, De = widths
    assert k8.bwd_bf16_instance(max_live, H, kd, vd, De, cuda_cores=cuda_cores) == want
