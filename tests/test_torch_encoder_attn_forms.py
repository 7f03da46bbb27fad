"""The hybrid and dense forms of the kNN encoder's attention against the JAX
package: K7 (``neighbor_attn_hybrid``, ``SINGA_TPU_HYBRID_ATTN``) and K8
(``dense_edge_attn``, ``SINGA_TPU_DENSE_ATTN``), each reached through its
autograd Function on CPU tensors (where it takes its plain version), against
the Pallas kernels in interpret mode, forward and backward; ``adj_dist``
against JAX's on a point set with in-degrees above K; ``NeighborGraphMHA``
under each switch against the JAX module under ``SINGA_TPU_FORCE_FUSED_ATTN``
(its interpret-mode hook) and the same switch; the switches' precedence; and
SINGA's ``encode_pocket``, training loss and every gradient, both packages
in the same form.

Inputs are numpy-seeded and float32. Tolerances: functions 1e-5 (atol 2e-5
on O(1) aggregates, as K1's test), their gradients 1e-4 of each gradient's
largest magnitude (sums over up to a few hundred O(1) terms, as K1b's test);
modules and the whole model 1e-4, gradients under ``close_grads``.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import (
    close,
    close_grads,
    jax_batch,
    load_val,
    port_config,
    port_grads,
    t,
    tiny_jax_config,
    torch_batch,
)

HYBRID, DENSE = "SINGA_TPU_HYBRID_ATTN", "SINGA_TPU_DENSE_ATTN"
SWITCH = {"hybrid": HYBRID, "dense": DENSE}
FORCE = "SINGA_TPU_FORCE_FUSED_ATTN"  # the JAX package's interpret-mode hook
GRAD_NAMES = ["dqt", "dk", "dv", "dds", "ddv", "dwk1", "dbk1", "dwk2", "dbk2",
              "dwv1", "dbv1", "dwv2", "dbv2"]
DIFF_AT = [0, 1, 2, 6, 7, *range(9, 17)]  # K7's differentiable inputs


def _close_grads(got, want, names):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-4 * scale, rtol=1e-4, err_msg=name)


def _weights(rng, De, kd, vd):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return [np.linspace(0.0, 15.0, De, dtype=np.float32),
            0.3 * f(De, kd), 0.1 * f(kd), 0.3 * f(kd, kd), 0.1 * f(kd),
            0.3 * f(De, vd), 0.1 * f(vd), 0.3 * f(vd, vd), 0.1 * f(vd)]


def _coeff(De):
    width = 15.0 / (De - 1)
    return -0.5 / (width * width)


def _counting(monkeypatch, module, name):
    """Wrap ``module.name`` to count its calls; returns the list of calls."""
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a: calls.append(1) or orig(*a))
    return calls


# ---------------------------------------------------------------- K7


def test_neighbor_attn_hybrid_matches_pallas(monkeypatch):
    """K7's plain forward and K7b's plain backward, through the port's
    Function, == neighbor_attn_hybrid (Pallas, interpret mode) and its
    custom VJP, with a node whose slots are all masked, a padded node (self
    score -1e9: its softmax is uniform over masked slots, which send dv to
    the rows they name) and a repeated neighbour index."""
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_hybrid as jhybrid
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7

    B, N, K, H, kd, vd, De = 2, 20, 8, 2, 8, 8, 8
    rng = np.random.default_rng(37)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    nbr = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    nbr[1, 4, :3] = 7  # a repeated neighbour
    mask = rng.random((B, N, K)) > 0.3
    mask[0, 3] = False  # a node with no live slot
    ds = f(B, N, H)
    ds[0, 5], mask[0, 5] = -1e9, False  # a padded node
    arrays = [f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd), nbr, mask,
              rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * vd),
              *_weights(rng, De, kd, vd)]
    g = f(B, N, H * vd)
    coeff = _coeff(De)

    def fn(*diff):
        a = list(map(jnp.asarray, arrays))
        for i, d in zip(DIFF_AT, diff):
            a[i] = d
        return jhybrid(*a, coeff, True)

    with compute_dtype_scope("float32"):
        want, vjp = jax.vjp(fn, *(jnp.asarray(arrays[i]) for i in DIFF_AT))
        jgrads = vjp(jnp.asarray(g))

    calls = _counting(monkeypatch, k7, "neighbor_attn_hybrid_plain")
    bwd_calls = _counting(monkeypatch, k7, "neighbor_attn_hybrid_bwd_plain")
    ts = [t(a) for a in arrays]
    for i in DIFF_AT:
        ts[i].requires_grad_()
    before = (k7.launches_hybrid, k7.launches_hybrid_bwd)
    out = k7.neighbor_attn_hybrid(*ts, coeff, *k7.transpose_slots(ts[3]))
    close(out, want, 2e-5, 1e-5, "forward")
    assert len(calls) == 1
    out.backward(t(g))
    assert len(bwd_calls) == 1
    assert (k7.launches_hybrid, k7.launches_hybrid_bwd) == before  # CPU: the plain versions
    _close_grads([ts[i].grad for i in DIFF_AT], jgrads, GRAD_NAMES)
    # K7's function is K1's: the same numbers as neighbor_attn_plain
    close(out, k7.neighbor_attn_plain(*ts, coeff).detach(), 0, 0, "vs K1 plain")


# ---------------------------------------------------------------- K8


def _dense_inputs(rng, B=2, N=20, H=2, kd=8, vd=8, De=8):
    """K8's inputs: a random symmetric-free adjacency (~30 % live pairs),
    an isolated live node (no live column), padded nodes (BIG rows and
    columns, self score -1e9) and a cotangent that is non-zero on every row,
    the padded ones included."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    live = rng.random((B, N, N)) < 0.3
    live[:, np.arange(N), np.arange(N)] = False
    valid = np.ones((B, N), bool)
    valid[1, N - 4:] = False
    live &= valid[:, :, None] & valid[:, None, :]
    live[0, 2, :] = False  # an isolated live node
    adj = np.where(live, rng.uniform(0.5, 14.0, size=(B, N, N)), 1e9).astype(np.float32)
    ds = np.where(valid[..., None], f(B, N, H), np.float32(-1e9)).astype(np.float32)
    arrays = [f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd), adj, ds, f(B, N, H * vd),
              *_weights(rng, De, kd, vd)]
    return arrays, f(B, N, H * vd), valid


def test_dense_edge_attn_matches_pallas(monkeypatch):
    """K8's plain forward and K8b's plain backward, through the port's
    Function, == dense_edge_attn (Pallas, interpret mode) and its custom
    VJP, with padded rows carrying a non-zero cotangent (their softmax is
    uniform over all N + 1 slots) and an isolated live row."""
    from singa_tpu.ops.pallas.dense_edge_attn import dense_edge_attn as jdense
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    arrays, g, _ = _dense_inputs(np.random.default_rng(43))
    diff_at = [0, 1, 2, 4, 5, *range(7, 15)]
    coeff = _coeff(8)

    def fn(*diff):
        a = list(map(jnp.asarray, arrays))
        for i, d in zip(diff_at, diff):
            a[i] = d
        return jdense(*a, coeff, True)

    with compute_dtype_scope("float32"):
        want, vjp = jax.vjp(fn, *(jnp.asarray(arrays[i]) for i in diff_at))
        jgrads = vjp(jnp.asarray(g))

    calls = _counting(monkeypatch, k8, "dense_edge_attn_plain")
    bwd_calls = _counting(monkeypatch, k8, "dense_edge_attn_bwd_plain")
    ts = [t(a) for a in arrays]
    for i in diff_at:
        ts[i].requires_grad_()
    before = (k8.launches, k8.launches_bwd)
    out = k8.dense_edge_attn(*ts, coeff)
    close(out, want, 2e-5, 1e-5, "forward")
    out.backward(t(g))
    assert (len(calls), len(bwd_calls)) == (1, 1)
    assert (k8.launches, k8.launches_bwd) == before  # CPU: the plain versions
    _close_grads([ts[i].grad for i in diff_at], jgrads, GRAD_NAMES)
    # the padded rows' dv reaches every column: dv is non-zero on padded nodes
    assert float(ts[2].grad[1, -4:].abs().max()) > 0


# ---------------------------------------------------------------- adj_dist


def _hub_points():
    """Two point sets whose kNN graph (k 3, K 6) has in-degrees above K: a
    centre with the 12 vertices of a cuboctahedron around it (each vertex's
    3 nearest include the centre; coordinates exact in float32, so the ties
    are exact in both packages), plus scattered points; the second set has
    padded nodes."""
    cubo = np.array([[a, b, 0] for a in (-1, 1) for b in (-1, 1)]
                    + [[a, 0, b] for a in (-1, 1) for b in (-1, 1)]
                    + [[0, a, b] for a in (-1, 1) for b in (-1, 1)], np.float32)
    rng = np.random.default_rng(5)
    far = rng.uniform(-6, 6, size=(11, 3)).astype(np.float32) + 8.0
    one = np.concatenate([np.zeros((1, 3), np.float32), 1.5 * cubo, far])
    pos = np.stack([one, one[::-1] * 0.9]).astype(np.float32)
    mask = np.ones(pos.shape[:2], bool)
    mask[1, :3] = False
    return pos, mask, 3


def test_adj_dist_matches_jax_with_overflow():
    """build_neighbor_graph(with_adj_dist=True) at the default k_in (K = 2k)
    equals JAX's: the same lists, degree attribute and adj_dist, BIG on the
    diagonal, on padded pairs and nowhere else that is adjacent, and real
    distances on pairs that the top-K cut dropped from the lists."""
    from singa_tpu.models.neighbor_graph import build_neighbor_graph as jbuild
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph as tbuild

    pos, mask, k = _hub_points()
    with compute_dtype_scope("float32"):
        jg = jbuild(jnp.asarray(pos), jnp.asarray(mask), k, 15.0, 16, with_adj_dist=True)
    tg = tbuild(t(pos), t(mask), k, 15.0, 16, with_adj_dist=True)
    assert tbuild(t(pos), t(mask), k, 15.0, 16).adj_dist is None
    np.testing.assert_array_equal(tg.nbr.numpy(), np.asarray(jg.nbr))
    np.testing.assert_array_equal(tg.nbr_mask.numpy(), np.asarray(jg.nbr_mask))
    close(tg.deg_attr, jg.deg_attr, 1e-5, 1e-5, "deg_attr")
    ad, jad = tg.adj_dist.numpy(), np.asarray(jg.adj_dist)
    np.testing.assert_array_equal(ad >= 5e8, jad >= 5e8)
    np.testing.assert_allclose(ad, jad, rtol=1e-6, atol=1e-6)
    big = ad >= 5e8
    assert big[:, np.arange(ad.shape[1]), np.arange(ad.shape[1])].all()  # the diagonal
    assert big[1, :3].all() and big[1][:, :3].all()  # padded rows and columns
    K = tg.nbr.shape[2]
    assert K == 2 * k
    in_degree = (~big).sum(-1)
    assert in_degree.max() > K  # overflow: the centre
    # adjacent pairs beyond the kept lists still carry their distance
    listed = np.zeros_like(big)
    b, i, s = np.nonzero(tg.nbr_mask.numpy())
    listed[b, i, tg.nbr.numpy()[b, i, s]] = True
    dropped = ~big & ~listed
    assert dropped.any()
    # the degree attribute counts the kept lists only, as in JAX
    from singa_tpu_torch.ops.smearing import gaussian_smearing

    kept = gaussian_smearing(tg.dist, 0.0, 15.0, 16) * tg.nbr_mask[..., None]
    close(tg.deg_attr, kept.sum(2), 1e-6, 1e-6, "deg_attr from the kept lists")


# ---------------------------------------------------------------- modules


def _mha_case(seed=0, B=2, N=20, C=16, knn=3):
    """x and positions with padded nodes and a hub (in-degree above K = 2
    knn) so that the dense form's untruncated adjacency differs from the
    lists."""
    rng = np.random.default_rng(seed)
    pos, mask, _ = _hub_points()
    pos, mask = pos[:, :N], mask[:, :N]
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    return x, pos, mask, knn


@pytest.mark.parametrize("form", ["hybrid", "dense"])
def test_neighbor_graph_mha_form_matches_jax(monkeypatch, form):
    """NeighborGraphMHA with the form's switch set == the JAX module with
    SINGA_TPU_FORCE_FUSED_ATTN and the same switch, one parameter set
    bridged from flax: the output (padded rows zero), the input gradient and
    every parameter gradient, through the form's plain versions."""
    from singa_tpu.models.neighbor_graph import NeighborGraphMHA as JMHA
    from singa_tpu.models.neighbor_graph import build_neighbor_graph as jbuild
    from singa_tpu_torch.models.neighbor_graph import NeighborGraphMHA as TMHA
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph as tbuild
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    x, pos, mask, knn = _mha_case()
    C, H, EDGE, STOP = x.shape[2], 2, 8, 15.0
    dense = form == "dense"
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    monkeypatch.setenv(FORCE, "1")
    monkeypatch.setenv(SWITCH[form], "1")
    jm = JMHA(hidden_channels=C, key_channels=16, num_heads=H, edge_channels=EDGE, smear_stop=STOP)
    with compute_dtype_scope("float32"):
        jg = jbuild(jnp.asarray(pos), jnp.asarray(mask), knn, STOP, EDGE, with_adj_dist=dense)
        params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jg))

        def loss(p, xx):
            out = jm.apply(p, xx, jg)
            return jnp.sum(out * w), out

        (_, want), (jp, jdx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))

    tm = TMHA(C, 16, H, EDGE, STOP, device="cpu")
    load_flax_params(tm, params)
    tg = tbuild(t(pos), t(mask), knn, STOP, EDGE, with_adj_dist=dense)
    plain = (k8, "dense_edge_attn_plain") if dense else (k1, "neighbor_attn_hybrid_plain")
    calls = _counting(monkeypatch, *plain)
    k1_calls = _counting(monkeypatch, k1, "neighbor_attn_plain")
    xt = t(x).requires_grad_()
    out = tm(xt, tg)
    assert (len(calls), len(k1_calls)) == (1, 0)
    (out * t(w)).sum().backward()
    close(out, want, 1e-4, 1e-4, "output")
    assert (out.detach().numpy()[~mask] == 0).all()
    close(xt.grad, jdx, 1e-4, 1e-4, "d x")
    close_grads(port_grads(tm), from_flax_grads(jax.tree_util.tree_map(np.asarray, jp["params"])))


def _tiny_encoder():
    from singa_tpu_torch.config import EncoderConfig
    from singa_tpu_torch.models.cpromg import Encoder
    from singa_tpu_torch.params import seeded_init

    cfg = EncoderConfig(hidden_channels=16, edge_channels=8, key_channels=16, num_heads=2,
                        num_interactions=2, knn=3)
    enc = Encoder(cfg, feature_dim=8, device="cpu")
    seeded_init(enc, 3)
    x, pos, mask, _ = _mha_case(C=8)
    lap = np.random.default_rng(2).normal(size=(*mask.shape, cfg.lap_dim)).astype(np.float32)
    return enc, (t(x), t(pos), t(mask), t(lap))


@pytest.mark.parametrize("dense,hybrid,form", [
    ("1", "1", "dense"), ("1", "0", "dense"), ("0", "1", "hybrid"), ("", "1", "hybrid"),
    ("0", "0", "neighbor"), ("1", "", "dense"), (None, None, "neighbor"),
])
def test_switch_precedence(monkeypatch, dense, hybrid, form):
    """The Encoder's layers take K8 whenever SINGA_TPU_DENSE_ATTN is on (it
    wins over the hybrid switch), else K7 when SINGA_TPU_HYBRID_ATTN is on,
    else K1; a variable that is unset, empty or "0" is off."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    for name, value in ((DENSE, dense), (HYBRID, hybrid)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    counts = {
        "dense": _counting(monkeypatch, k8, "dense_edge_attn_plain"),
        "hybrid": _counting(monkeypatch, k1, "neighbor_attn_hybrid_plain"),
        "neighbor": _counting(monkeypatch, k1, "neighbor_attn_plain"),
    }
    enc, inputs = _tiny_encoder()
    with torch.no_grad():
        out, _, _ = enc(*inputs)
    assert bool(torch.isfinite(out).all())
    assert {n: len(c) for n, c in counts.items()} == {
        n: (2 if n == form else 0) for n in counts}


def test_dense_form_padding_invariance(monkeypatch):
    """Under SINGA_TPU_DENSE_ATTN, corrupting the padded nodes' features
    leaves every real node's output unchanged (tests/test_dense_edge_attn.py
    for the JAX kernel), though padded rows attend over every column."""
    from singa_tpu_torch.models.neighbor_graph import NeighborGraphMHA as TMHA
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph as tbuild
    from singa_tpu_torch.params import seeded_init

    monkeypatch.setenv(DENSE, "1")
    x, pos, mask, knn = _mha_case(seed=4)
    tm = TMHA(16, 16, 2, 8, 15.0, device="cpu")
    seeded_init(tm, 7)
    tg = tbuild(t(pos), t(mask), knn, 15.0, 8, with_adj_dist=True)
    noisy = x + (~mask)[..., None] * 7.0
    with torch.no_grad():
        a, b = tm(t(x), tg), tm(t(noisy.astype(np.float32)), tg)
    close(b, a.numpy(), 1e-5, 1e-5, "real nodes")


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module", params=["hybrid", "dense"])
def slice_run(request):
    """SINGA at the tiny config (encoder knn 6, K 12) on one val complex
    with an in-degree overflow row,
    both packages in the same form: JAX's encode_pocket, loss and gradients
    with SINGA_TPU_FORCE_FUSED_ATTN and the switch (the Pallas kernels in
    interpret mode), and the port's with the switch, from bridged weights;
    the port's plain calls counted in encode and in training."""
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import cross_entropy_loss as jce
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    form = request.param
    jcfg = tiny_jax_config()
    files = load_val(1, 4)  # this val complex has a row whose in-degree exceeds K at knn 6
    jb, tb = jax_batch(files), torch_batch(files)
    jm = JSINGA(jcfg)
    with compute_dtype_scope("float32"):  # the parameters do not depend on the form
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jb))
    saved = {k: os.environ.get(k) for k in (FORCE, HYBRID, DENSE)}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update({FORCE: "1", SWITCH[form]: "1"})
    module, name = (k8, "dense_edge_attn_plain") if form == "dense" else (k1, "neighbor_attn_hybrid_plain")
    plain = getattr(module, name)
    calls = []
    try:
        def loss_fn(p, b):
            return jce(jm.apply(p, b), b.tokens.target)

        with compute_dtype_scope("float32"):
            jenc, _ = jax.jit(lambda p, b: jm.apply(p, b, method="encode_pocket"))(params, jb)
            jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, jb)

        setattr(module, name, lambda *a: calls.append(1) or plain(*a))
        cfg = port_config(jcfg)
        model = SINGA(cfg, device="cpu")
        load_flax_params(model, params)
        with torch.no_grad():
            tenc, _ = model.encode_pocket(tb)
        n_encode = len(calls)
        loss = cross_entropy_loss(model(tb), tb.tokens.target)
        n_train = len(calls) - n_encode
        loss.backward()
    finally:
        setattr(module, name, plain)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    enc = cfg.model.encoder
    g = build_neighbor_graph(tb.protein.pos, tb.protein.mask, enc.knn, enc.smear_stop,
                             enc.edge_channels, with_adj_dist=True)
    overflow = int(((g.adj_dist < 5e8).sum(-1) > g.nbr.shape[2]).sum())
    return {
        "form": form, "encode": (tenc, np.asarray(jenc)), "loss": (loss.item(), float(jloss)),
        "grads": (port_grads(model), from_flax_grads(jax.tree_util.tree_map(np.asarray, jgrads))),
        "calls": (n_encode, n_train), "layers": enc.num_interactions, "overflow": overflow,
    }


def test_encode_pocket_form_matches_jax(slice_run):
    """Serving: encode_pocket under the switch runs the form's kernel once
    per encoder layer and equals JAX's encode_pocket in the same form (1e-4,
    a stack of layers); the val complex has rows whose in-degree exceeds K,
    where the dense form differs from the lists by design."""
    tenc, jenc = slice_run["encode"]
    assert slice_run["calls"][0] == slice_run["layers"]
    assert slice_run["overflow"] > 0
    close(tenc, jenc, 1e-4, 1e-4, "encode_pocket")


def test_training_loss_and_gradients_form_match_jax(slice_run):
    """Training: the loss and every gradient, encoder 1 through the form's
    backward, equal jax.value_and_grad in the same form."""
    loss, jloss = slice_run["loss"]
    assert slice_run["calls"][1] == slice_run["layers"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads, jgrads = slice_run["grads"]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
    close_grads(grads, jgrads)
