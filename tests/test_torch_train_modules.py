"""Module gradients of the port against ``jax.grad`` of the JAX package's
XLA path (what it runs on the CPU), with bridged weights: NeighborGraphMHA
(K1 inside), the gate FeedForwardNetwork (K2), GraphAttention (K3), and the
training slice's dense modules: build_dense_graph, DenseGraphMHA, Encoder2
and the teacher-forced Decoder.

Tiny config (tests/test_model.py::tiny_config, lmax 2) on real
``data/corpus/val`` complexes, float32. Each test takes the gradient of
``sum(out * w)`` for a fixed random ``w``, in every parameter and in the
float inputs. Both sides add the same products in another order: forwards
agree to 1e-5 (single blocks) or 1e-4 (stacks), gradients leaf by leaf to
1e-4 of the leaf's largest magnitude (``close_grads``).
"""
from __future__ import annotations

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
    singa_params,
    sub,
    t,
    torch_batch,
)


@pytest.fixture(scope="module")
def setup():
    jcfg, params = singa_params(2, 2)
    files = load_val(2)
    return jcfg, port_config(jcfg), params, jax_batch(files), torch_batch(files)


def _weights(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_grads(apply, p, inputs, w):
    """(output, d params, d inputs) of sum(apply(p, *inputs) * w)."""
    def loss(pp, *xs):
        out = apply(pp, *xs)
        return jnp.sum(out * w), out

    with compute_dtype_scope("float32"):
        (_, out), grads = jax.jit(
            jax.value_and_grad(loss, argnums=tuple(range(1 + len(inputs))), has_aux=True)
        )(p, *inputs)
    return out, grads[0], grads[1:]


def _port_run(module, inputs, call, w):
    """(output, {param: grad}, [input grads]) of sum(call(*inputs) * w)."""
    xs = [t(a).requires_grad_() for a in inputs]
    out = call(*xs)
    (out * t(w)).sum().backward()
    return out, port_grads(module), [x.grad for x in xs]


def _check(jres, tres, fwd_tol):
    from singa_tpu_torch.params import from_flax_grads

    (jout, jpg, jxg), (tout, tpg, txg) = jres, tres
    close(tout, jout, fwd_tol, fwd_tol, "forward")
    close_grads(tpg, from_flax_grads(jax.tree_util.tree_map(np.asarray, jpg)))
    close_grads({f"input {i}": g for i, g in enumerate(txg)},
                {f"input {i}": np.asarray(g) for i, g in enumerate(jxg)})


# ------------------------------------------------------------ K1, K2, K3 inside


def test_neighbor_graph_mha_gradients_match_jax():
    from singa_tpu.models.neighbor_graph import NeighborGraphMHA as JMHA
    from singa_tpu.models.neighbor_graph import build_neighbor_graph as jbuild
    from singa_tpu_torch.models.neighbor_graph import NeighborGraphMHA as TMHA
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph as tbuild
    from singa_tpu_torch.params import load_flax_params

    rng = np.random.default_rng(0)
    B, N, C, H, EDGE, STOP, knn = 2, 20, 16, 2, 8, 15.0, 4
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    pos = (3.0 * rng.normal(size=(B, N, 3))).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, N - 5 :] = False
    w = _weights((B, N, C), 1)
    with compute_dtype_scope("float32"):
        jg = jbuild(jnp.asarray(pos), jnp.asarray(mask), knn, STOP, EDGE)
        jm = JMHA(hidden_channels=C, key_channels=16, num_heads=H, edge_channels=EDGE, smear_stop=STOP)
        params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jg)["params"]
    jres = _jax_grads(lambda p, xx: jm.apply({"params": p}, xx, jg), params, [jnp.asarray(x)], w)
    tm = TMHA(C, 16, H, EDGE, STOP, device="cpu")
    load_flax_params(tm, params)
    tg = tbuild(t(pos), t(mask), knn, STOP, EDGE)
    _check(jres, _port_run(tm, [x], lambda xx: tm(xx, tg), w), 1e-5)


def test_gate_ffn_gradients_match_jax(setup):
    from singa_tpu.equivariant.attention import FeedForwardNetwork as JFFN
    from singa_tpu_torch.equivariant.attention import FeedForwardNetwork as TFFN
    from singa_tpu_torch.params import load_flax_params

    jcfg, _, params, _, _ = setup
    e = jcfg.embedding
    p = sub(params, "params/embedding/block_0/ffn")
    x = _weights((30, (e.lmax + 1) ** 2, e.sphere_channels), 2)
    w = _weights(x.shape, 3)
    jffn = JFFN(hidden_channels=e.ffn_hidden_channels, output_channels=e.sphere_channels,
                lmax=e.lmax, activation="gate")
    jres = _jax_grads(lambda pp, xx: jffn.apply({"params": pp}, xx), p, [jnp.asarray(x)], w)
    tffn = TFFN(e.sphere_channels, e.ffn_hidden_channels, e.sphere_channels, e.lmax, device="cpu")
    load_flax_params(tffn, p)
    _check(jres, _port_run(tffn, [x], tffn, w), 1e-5)


def test_graph_attention_gradients_match_jax(setup):
    from singa_tpu.equivariant.attention import GraphAttention as JGA
    from singa_tpu_torch.equivariant.attention import GraphAttention as TGA
    from singa_tpu_torch.params import load_flax_params
    from test_torch_modules import _edge_inputs

    jcfg, _, params, jb, tb = setup
    e = jcfg.embedding
    (je, jf), (te, tf), xs, xt, x_edge = _edge_inputs(jcfg, jb, tb, seed=4)
    p = sub(params, "params/embedding/block_0/ga")
    jga = JGA(
        sphere_channels=e.sphere_channels, hidden_channels=e.attn_hidden_channels,
        num_heads=e.num_heads, attn_alpha_channels=e.attn_alpha_channels,
        attn_value_channels=e.attn_value_channels, output_channels=e.sphere_channels,
        lmax=e.lmax, mmax=e.mmax, edge_channels=(e.edge_channels, e.edge_channels),
    )
    w = _weights(xt.shape, 5)
    jres = _jax_grads(lambda pp, a, b, c: jga.apply({"params": pp}, a, b, c, je, jf), p,
                      [jnp.asarray(xs), jnp.asarray(xt), jnp.asarray(x_edge)], w)
    tga = TGA(
        e.sphere_channels, e.attn_hidden_channels, e.num_heads, e.attn_alpha_channels,
        e.attn_value_channels, e.sphere_channels, e.lmax, e.mmax,
        (3 * e.edge_channels, e.edge_channels, e.edge_channels), device="cpu",
    )
    load_flax_params(tga, p)
    _check(jres, _port_run(tga, [xs, xt, x_edge], lambda a, b, c: tga(a, b, c, te, tf), w), 2e-5)


# ------------------------------------------------------------ dense modules


def _ligand(jb):
    return (np.asarray(jb.ligand.pos), np.asarray(jb.ligand.mask))


def test_build_dense_graph_matches_jax(setup):
    """The dense kNN closure, degrees and smear on the val ligands, and on a
    lattice with tied distances where a graph has fewer valid atoms than k
    (it gets every valid pair)."""
    from singa_tpu.models.dense_graph import build_dense_graph as jbuild
    from singa_tpu_torch.models.dense_graph import build_dense_graph as tbuild

    jcfg, _, _, jb, _ = setup
    g = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij"), -1)
    lattice = np.stack([g.reshape(-1, 3), g.reshape(-1, 3)[::-1]]).astype(np.float32) * 1.5
    lmask = np.ones(lattice.shape[:2], bool)
    lmask[1, 4:] = False  # four valid atoms, fewer than k = 6
    for (pos, mask), k in ((_ligand(jb), 30), ((lattice, lmask), 6)):
        with compute_dtype_scope("float32"):
            want = jbuild(jnp.asarray(pos), jnp.asarray(mask), k, 25.0, 16)
        got = tbuild(t(pos), t(mask), k, 25.0, 16)
        np.testing.assert_array_equal(got.adj.numpy(), np.asarray(want.adj))
        close(got.neg_smear, want.neg_smear, 1e-6, 1e-5)
        close(got.deg_attr, want.deg_attr, 1e-5, 1e-5)
    valid = lmask[1][:, None] & lmask[1][None, :] & ~np.eye(len(lmask[1]), dtype=bool)
    np.testing.assert_array_equal(got.adj.numpy()[1], valid)


def test_dense_graph_mha_gradients_match_jax(setup):
    from singa_tpu.models.dense_graph import DenseGraphMHA as JD
    from singa_tpu.models.dense_graph import build_dense_graph as jbuild
    from singa_tpu_torch.models.dense_graph import DenseGraphMHA as TD
    from singa_tpu_torch.models.dense_graph import build_dense_graph as tbuild
    from singa_tpu_torch.params import load_flax_params

    jcfg, _, params, jb, _ = setup
    ec = jcfg.model.encoder
    p = sub(params, "params/model/encoder2/layer_0_attn")
    pos, mask = _ligand(jb)
    x = _weights(pos.shape[:2] + (ec.hidden_channels,), 6)
    w = _weights(x.shape, 7)
    with compute_dtype_scope("float32"):
        jg = jbuild(jnp.asarray(pos), jnp.asarray(mask), ec.knn_aa, ec.smear_stop_aa, ec.edge_channels)
    jd = JD(ec.hidden_channels, ec.key_channels, ec.num_heads, ec.edge_channels, ec.smear_stop_aa)
    jres = _jax_grads(lambda pp, xx: jd.apply({"params": pp}, xx, jg), p, [jnp.asarray(x)], w)
    td = TD(ec.hidden_channels, ec.key_channels, ec.num_heads, ec.edge_channels, device="cpu")
    load_flax_params(td, p)
    tg = tbuild(t(pos), t(mask), ec.knn_aa, ec.smear_stop_aa, ec.edge_channels)
    tres = _port_run(td, [x], lambda xx: td(xx, tg), w)
    _check(jres, tres, 1e-5)
    assert (tres[0].detach().numpy()[~mask] == 0).all()


def test_encoder2_gradients_match_jax(setup):
    """Encoder2 on the val ligands with cross-attention into random encoder-1
    layer outputs behind a padded protein mask; gradients in its weights,
    its features and the encoder-1 outputs it reads."""
    from singa_tpu.models.cpromg import Encoder2 as JE2
    from singa_tpu_torch.models.cpromg import Encoder2 as TE2
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params, jb, tb = setup
    ec, fd = jcfg.model.encoder, jcfg.model.featurizer_feat_dim
    p = sub(params, "params/model/encoder2")
    B, Nl = jb.ligand.pos.shape[:2]
    Np = jb.protein.pos.shape[1]
    feat = _weights((B, Nl, fd), 8)
    msas = [_weights((B, Np, ec.hidden_channels), 9 + i) for i in range(ec.num_interactions)]
    pad1 = ~np.asarray(jb.protein.mask)[:, None, :]
    w = _weights((B, Nl, ec.hidden_channels), 20)
    lig = (jb.ligand.pos, jb.ligand.mask, jb.ligand.lap_pe)
    used = [i for i in TE2.CROSS_LAYERS if i < ec.num_interactions]  # the outputs it reads

    def with_used(ms, lib):
        out = [lib(m) for m in msas]
        for i, m in zip(used, ms):
            out[i] = m
        return out

    je2 = JE2(ec, fd)
    jres = _jax_grads(
        lambda pp, f, *m: je2.apply({"params": pp}, f, *lig, jnp.asarray(pad1),
                                    with_used(m, jnp.asarray))[0],
        p, [jnp.asarray(feat)] + [jnp.asarray(msas[i]) for i in used], w,
    )
    te2 = TE2(cfg.model.encoder, fd, device="cpu")
    load_flax_params(te2, p)
    tlig = (tb.ligand.pos, tb.ligand.mask, tb.ligand.lap_pe)
    tres = _port_run(te2, [feat] + [msas[i] for i in used],
                     lambda f, *m: te2(f, *tlig, t(pad1), with_used(m, t))[0], w)
    _check(jres, tres, 1e-4)


def test_teacher_forced_decoder_gradients_match_jax(setup):
    """Decoder.forward on the val tokens (causal mask OR key-is-pad, the
    property slot never a pad key), over a random encoding with padded
    positions."""
    from singa_tpu.config import PAD_TOKEN
    from singa_tpu.models.cpromg import Decoder as JDec
    from singa_tpu_torch.config import PAD_TOKEN as TPAD
    from singa_tpu_torch.models.cpromg import Decoder as TDec
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params, jb, tb = setup
    dc = jcfg.model.decoder
    p = sub(params, "params/model/decoder")
    tokens = np.asarray(jb.tokens.input)
    B, T = tokens.shape
    enc = _weights((B, 30, dc.hidden_channels), 21)
    pad = np.zeros((B, 1, 30), bool)
    pad[:, :, 24:] = True
    prop = np.asarray([[1, 0, 1], [0, 1, 1]], np.float32)
    w = _weights((B, T + 1, dc.hidden_channels), 22)
    jdec = JDec(dc, jcfg.model.num_props, PAD_TOKEN)
    jres = _jax_grads(
        lambda pp, e: jdec.apply({"params": pp}, jnp.asarray(tokens), e, jnp.asarray(pad),
                                 jnp.asarray(prop)),
        p, [jnp.asarray(enc)], w,
    )
    tdec = TDec(cfg.model.decoder, cfg.model.num_props, TPAD, device="cpu")
    load_flax_params(tdec, p)
    tres = _port_run(tdec, [enc], lambda e: tdec(t(tokens), e, t(pad), t(prop)), w)
    _check(jres, tres, 1e-4)
    assert (tokens == PAD_TOKEN).any()  # pad keys are blocked somewhere
