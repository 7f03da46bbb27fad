"""The port's modules against the JAX package's with bridged weights: the
weight bridge itself, GraphAttention, TransBlock, EquivariantEmbedding (both
stages and gen_mode), the kNN Encoder and the KV-cached Decoder.

Tiny config (tests/test_model.py::tiny_config, lmax 2) on real
``data/corpus/val`` pockets, float32. Whole stacks agree to atol ~1e-4
(LayerNorm'd / RMS-normed O(1) features after several layers of reordered
float32 sums); single blocks to 1e-5.
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
    jax_batch,
    load_val,
    port_config,
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


def test_bridge_maps_every_leaf_but_encoder2(setup):
    """Every flax leaf, ``model/encoder2/**`` included (the name dates from
    the serving slice, which left Encoder2 unmapped), lands on exactly one
    port parameter (scan stacks unstacked, kernels transposed) and back; the
    port model has no parameter the tree leaves unset."""
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import _leaves, from_flax, load_flax_params

    jcfg, cfg, params, _, _ = setup
    sd = from_flax(params)
    leaves = dict(_leaves(params["params"]))
    assert any(p[:2] == ("model", "encoder2") for p in leaves)

    model = SINGA(cfg, device="cpu", seed=1)
    load_flax_params(model, params)
    state = model.state_dict()
    assert set(state) == set(sd)
    assert any(k.startswith("model.encoder2.") for k in sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    # and back: each flax leaf is recovered bit-exactly from the port state
    n_layers = jcfg.model.encoder.num_interactions
    for path, leaf in leaves.items():
        if "layers" in path:
            j = path.index("layers")
            rows = [
                _port_leaf(state, path[: j + 1] + (str(i),) + path[j + 2 :]) for i in range(n_layers)
            ]
            back = np.stack(rows)
        else:
            back = _port_leaf(state, path)
        np.testing.assert_array_equal(back, leaf, err_msg="/".join(path))


def _port_leaf(state, path):
    """The flax-layout value of one flax path, read from the port's state."""
    mods = [p for p in path[:-1] if p not in ("Dense_0", "Embed_0")]
    name = path[-1]
    if name == "kernel" and "Dense_0" in path:
        return state[".".join(mods + ["weight"])].numpy().T
    if name in ("scale", "embedding"):
        return state[".".join(mods + ["weight"])].numpy()
    return state[".".join(mods + [name])].numpy()


def test_bridge_refuses_unknown_and_missing(setup):
    from singa_tpu_torch.equivariant.attention import FeedForwardNetwork
    from singa_tpu_torch.params import load_flax_params

    _, _, params, _, _ = setup
    p = dict(sub(params, "params/embedding/block_0/ffn"))
    ffn = FeedForwardNetwork(8, 16, 8, 2, device="cpu")
    load_flax_params(ffn, p)
    with pytest.raises(KeyError):
        load_flax_params(ffn, {**p, "stray": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        load_flax_params(ffn, {k: v for k, v in p.items() if k != "b1"})


def _edge_inputs(jcfg, jb, tb, seed=0):
    """Matching JAX/port edge engines, edge frames and random inputs on the
    merged intra edge set of the batch."""
    from singa_tpu.equivariant import so3 as jso3
    from singa_tpu.ops.neighbors import EdgeEngine as JE
    from singa_tpu_torch.equivariant import so3 as tso3
    from singa_tpu_torch.ops.neighbors import EdgeEngine as TE

    B = jb.protein.x.shape[0]
    n_p, n_l = jb.protein.x.shape[1], jb.ligand.x.shape[1]
    n_c = n_p + n_l
    je = JE.create(
        jnp.concatenate([jb.pp.index, jb.ll.index + n_p], axis=1),
        jnp.concatenate([jb.pp.mask, jb.ll.mask], axis=1),
        jb.tables.intra, n_c, n_c, src_table=jb.tables.intra_src,
    )
    te = TE.create(
        torch.cat([tb.pp.index, tb.ll.index + n_p], dim=1),
        torch.cat([tb.pp.mask, tb.ll.mask], dim=1), tb.tables.intra, n_c, n_c,
    )
    pos = np.concatenate([np.asarray(jb.protein.pos), np.asarray(jb.ligand.pos)], 1).reshape(-1, 3)
    jvec = je.gather_src(jnp.asarray(pos)) - je.gather_dst(jnp.asarray(pos))
    tvec = te.gather_src(t(pos)) - te.gather_dst(t(pos))
    e = jcfg.embedding
    rng = np.random.default_rng(seed)
    n_nodes, n_edges = B * n_c, int(jvec.shape[0])
    I = (e.lmax + 1) ** 2
    xs = rng.normal(size=(n_nodes, I, e.sphere_channels)).astype(np.float32)
    xt = rng.normal(size=(n_nodes, I, e.sphere_channels)).astype(np.float32)
    x_edge = rng.normal(size=(n_edges, 3 * e.edge_channels)).astype(np.float32)
    return (je, jso3.edge_frame(jvec)), (te, tso3.edge_frame(tvec)), xs, xt, x_edge


def test_graph_attention_matches_jax(setup):
    from singa_tpu.equivariant.attention import GraphAttention as JGA
    from singa_tpu_torch.equivariant.attention import GraphAttention as TGA
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params, jb, tb = setup
    e = jcfg.embedding
    (je, jf), (te, tf), xs, xt, x_edge = _edge_inputs(jcfg, jb, tb)
    p = sub(params, "params/embedding/block_0/ga")
    with compute_dtype_scope("float32"):
        jga = JGA(
            sphere_channels=e.sphere_channels, hidden_channels=e.attn_hidden_channels,
            num_heads=e.num_heads, attn_alpha_channels=e.attn_alpha_channels,
            attn_value_channels=e.attn_value_channels, output_channels=e.sphere_channels,
            lmax=e.lmax, mmax=e.mmax, edge_channels=(e.edge_channels, e.edge_channels),
        )
        want = jga.apply({"params": p}, jnp.asarray(xs), jnp.asarray(xt), jnp.asarray(x_edge), je, jf)
    tga = TGA(
        e.sphere_channels, e.attn_hidden_channels, e.num_heads, e.attn_alpha_channels,
        e.attn_value_channels, e.sphere_channels, e.lmax, e.mmax,
        (3 * e.edge_channels, e.edge_channels, e.edge_channels), device="cpu",
    )
    load_flax_params(tga, p)
    with torch.no_grad():
        got = tga(t(xs), t(xt), t(x_edge), te, tf)
    close(got, want, 2e-5, 1e-5)


@pytest.mark.parametrize("hetero", [False, True])
def test_transblock_matches_jax(setup, hetero):
    from singa_tpu.equivariant.attention import TransBlock as JTB
    from singa_tpu_torch.equivariant.attention import TransBlock as TTB
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params, jb, tb = setup
    e = jcfg.embedding
    (je, jf), (te, tf), xs, xt, x_edge = _edge_inputs(jcfg, jb, tb, seed=2)
    p = sub(params, "params/embedding/block_1")
    kw = dict(
        sphere_channels=e.sphere_channels, attn_hidden_channels=e.attn_hidden_channels,
        attn_alpha_channels=e.attn_alpha_channels, attn_value_channels=e.attn_value_channels,
        ffn_hidden_channels=e.ffn_hidden_channels, num_heads=e.num_heads, lmax=e.lmax,
        mmax=e.mmax, norm_type=e.norm_type, ffn_activation=e.ffn_activation,
    )
    jx_src = jnp.asarray(xs)
    jx_dst = jnp.asarray(xt) if hetero else jx_src
    with compute_dtype_scope("float32"):
        jtb = JTB(edge_channels=(e.edge_channels, e.edge_channels), **kw)
        want = jtb.apply({"params": p}, jx_src, jx_dst, jnp.asarray(x_edge), je, jf)
    ttb = TTB(edge_channels=(3 * e.edge_channels, e.edge_channels, e.edge_channels), device="cpu", **kw)
    load_flax_params(ttb, p)
    tx_src = t(xs)
    tx_dst = t(xt) if hetero else tx_src
    with torch.no_grad():
        got = ttb(tx_src, tx_dst, t(x_edge), te, tf)
    close(got, want, 2e-5, 1e-5)


@pytest.mark.parametrize("gen_mode", [True, False])
def test_embedding_matches_jax(setup, gen_mode):
    """EquivariantEmbedding == JAX on val pockets; gen_mode runs the intra
    stage only, the full forward both merged stages."""
    from singa_tpu.equivariant.embedding import EquivariantEmbedding as JEmb
    from singa_tpu_torch.equivariant.embedding import EquivariantEmbedding as TEmb
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params, jb, tb = setup
    p = sub(params, "params/embedding")
    with compute_dtype_scope("float32"):
        want = jax.jit(
            lambda pp, b: JEmb(jcfg.embedding).apply({"params": pp}, b, gen_mode=gen_mode)
        )(p, jb)
    emb = TEmb(cfg.embedding, device="cpu")
    load_flax_params(emb, p)
    with torch.no_grad():
        got = emb(tb, gen_mode=gen_mode)
    close(got.protein, want.protein, 1e-4, 1e-4, "protein")
    close(got.ligand, want.ligand, 1e-4, 1e-4, "ligand")


def test_encoder_matches_jax(setup):
    """The 6-layer kNN encoder (here 3 layers, knn 6) == JAX's scan stack."""
    from singa_tpu.models.cpromg import Encoder as JEnc
    from singa_tpu_torch.models.cpromg import Encoder as TEnc
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params, jb, tb = setup
    fd = jcfg.model.featurizer_feat_dim
    feat = np.random.default_rng(4).normal(size=(2, jb.protein.x.shape[1], fd)).astype(np.float32)
    p = sub(params, "params/model/encoder")
    args = (jb.protein.pos, jb.protein.mask, jb.protein.lap_pe)
    with compute_dtype_scope("float32"):
        out, pad, msas = jax.jit(
            lambda pp, f, *a: JEnc(jcfg.model.encoder, fd).apply({"params": pp}, f, *a)
        )(p, jnp.asarray(feat), *args)
    enc = TEnc(cfg.model.encoder, fd, device="cpu")
    load_flax_params(enc, p)
    with torch.no_grad():
        g_out, g_pad, g_msas = enc(t(feat), tb.protein.pos, tb.protein.mask, tb.protein.lap_pe)
    close(g_out, out, 1e-4, 1e-4, "out")
    np.testing.assert_array_equal(g_pad.numpy(), np.asarray(pad))
    for i, (a, b) in enumerate(zip(g_msas, msas)):
        close(a, b, 1e-4, 1e-4, f"msa {i}")


def test_decoder_prime_and_decode_token_match_jax(setup):
    """Decoder.prime and KV-cached decode_token give JAX's logits step by
    step, across a beam reordering of the cache."""
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params, jb, tb = setup
    R, S, C = 6, 40, jcfg.model.decoder.hidden_channels
    rng = np.random.default_rng(8)
    enc = rng.normal(size=(R, S, C)).astype(np.float32)
    pad = np.zeros((R, 1, S), bool)
    pad[:, :, 30:] = True
    prop = rng.integers(0, 2, size=(R, 3)).astype(np.float32)
    jm = JSINGA(jcfg)
    model = SINGA(cfg, device="cpu")
    load_flax_params(model, params)

    with compute_dtype_scope("float32"):
        jx, var = jm.apply(params, jnp.asarray(enc), jnp.asarray(pad), jnp.asarray(prop),
                           method="prime_cache", mutable=["cache"])
    with torch.no_grad():
        tx, cache = model.model.decoder.prime(t(enc), t(pad), t(prop))
    close(tx, jx, 1e-5, 1e-5, "prime")
    jcache = var["cache"]
    order = np.array([1, 0, 2, 2, 5, 4])
    for step in range(5):
        tok = rng.integers(0, 116, size=(R, 1)).astype(np.int32)
        with compute_dtype_scope("float32"):
            jl, mut = jm.apply({**params, "cache": jcache}, jnp.asarray(tok), step,
                               jnp.asarray(enc), jnp.asarray(pad), method="decode_token",
                               mutable=["cache"])
        with torch.no_grad():
            tl = model.decode_token(t(tok), step, cache)
        close(tl, jl, 1e-4, 1e-5, f"step {step}")
        jcache = jax.tree_util.tree_map(
            lambda x: x[order] if getattr(x, "ndim", 0) >= 1 and x.shape[0] == R else x,
            mut["cache"],
        )
        cache.reorder(torch.as_tensor(order))
