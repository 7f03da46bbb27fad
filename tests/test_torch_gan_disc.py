"""The GAN's discriminators and host rewards against the JAX package: with
the flax weights carried over by the bridge, ``SeqDiscriminator`` (token
ids and soft one-hots) and ``GINDiscriminatorDense`` give JAX's logits and
the gradients of a seeded weighting of them with respect to their inputs and
every parameter; the four reward functions give JAX's results bit for bit
on corpus targets, corrupted and garbage rows. CPU, float32.

Tolerances: logits to 1e-5 (LayerNorm'd float32 stacks; flax's LayerNorm
takes E[x^2] - E[x]^2, torch two passes); gradients leaf by leaf to 1e-4 of
the leaf's largest magnitude, floored at 1e-3 of the set's largest
(``close_grads``; the key biases of attention get a softmax-cancelled zero
gradient, float32 noise on both sides).
"""
from __future__ import annotations

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import REPO, close, close_grads, load_val, port_grads, t

V = 116  # SMI_VOCAB
TGT = 24


def _targets(n: int) -> np.ndarray:
    """tokens.target of the first ``n`` sorted train complexes, cut to TGT."""
    files = sorted(glob.glob(os.path.join(REPO, "data", "corpus", "train", "*.npz")))[:n]
    out = []
    for p in files:
        with np.load(p) as z:
            out.append(z["tokens.target"][:TGT])
    return np.stack(out).astype(np.int32)


def _token_rows() -> np.ndarray:
    """Corpus targets (whole SMILES), corrupted ones (a token dropped, two
    swapped, a ring digit or a bracket added), and garbage rows, [48, 200]."""
    from singa_tpu_torch.config import EOS_TOKEN, PAD_TOKEN

    rng = np.random.default_rng(17)
    files = sorted(glob.glob(os.path.join(REPO, "data", "corpus", "train", "*.npz")))[:24]
    good = []
    for p in files:
        with np.load(p) as z:
            good.append(z["tokens.target"].astype(np.int32))
    good = np.stack(good)
    bad = []
    for i, row in enumerate(good[:16]):
        n = int(np.nonzero(row == EOS_TOKEN)[0][0])
        r = row.copy()
        j = int(rng.integers(0, max(n - 1, 1)))
        kind = i % 4
        if kind == 0:  # drop a token
            r[j:n] = row[j + 1 : n + 1]
            r[n] = PAD_TOKEN
        elif kind == 1:  # swap two
            r[j], r[j + 1] = row[j + 1], row[j]
        elif kind == 2:  # an unclosed ring digit
            r[j] = 2 if row[j] != 2 else 3
        else:  # an unmatched bracket or branch token
            r[j] = 3 if row[j] != 3 else 4
        bad.append(r)
    junk = rng.integers(0, V, size=(8, good.shape[1])).astype(np.int32)
    junk[:4, 10:] = PAD_TOKEN
    return np.concatenate([good, np.stack(bad), junk])


# ---------------------------------------------------------------- discriminators


@pytest.fixture(scope="module")
def seq_disc():
    from singa_tpu.models.discriminator import SeqDiscriminator as JSeq
    from singa_tpu_torch.config import PAD_TOKEN
    from singa_tpu_torch.models.discriminator import SeqDiscriminator
    from singa_tpu_torch.params import load_flax_params

    ids = _targets(6)
    ids[5, :] = ids[0]  # the same molecule twice
    ids[4, 3:] = PAD_TOKEN  # a short row: PAD after the third token
    jmod = JSeq(vocab_size=V)
    with compute_dtype_scope("float32"):
        params = jax.jit(jmod.init)(jax.random.PRNGKey(3), jnp.asarray(ids))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = SeqDiscriminator(V, device="cpu")
    load_flax_params(model, params)
    return jmod, params, model, ids


def _jax_value_and_grads(fn, params, *inputs, argnums=(0,)):
    with compute_dtype_scope("float32"):
        return jax.jit(jax.value_and_grad(fn, argnums=argnums))(params, *inputs)


def test_seq_discriminator_ids_match_jax(seq_disc):
    """Token ids: logits, and every parameter's gradient of sum(w * logits)."""
    from singa_tpu_torch.params import from_flax_grads

    jmod, params, model, ids = seq_disc
    w = np.random.default_rng(2).normal(size=(ids.shape[0],)).astype(np.float32)
    with compute_dtype_scope("float32"):
        jlogits = jax.jit(jmod.apply)(params, jnp.asarray(ids))
    loss = lambda p, x: jnp.sum(jmod.apply(p, x) * w)
    _, (jg,) = _jax_value_and_grads(loss, params, jnp.asarray(ids))
    model.zero_grad()
    logits = model(t(ids))
    (logits * t(w)).sum().backward()
    close(logits, jlogits, 1e-5, 1e-5, "logits")
    close_grads(port_grads(model), from_flax_grads(jax.tree_util.tree_map(np.asarray, jg)))


def test_seq_discriminator_soft_onehots_match_jax(seq_disc):
    """Soft one-hots (rows whose PAD weight passes 0.5 are masked): logits,
    the gradient with respect to the one-hots and every parameter's."""
    from singa_tpu_torch.params import from_flax_grads

    jmod, params, model, ids = seq_disc
    rng = np.random.default_rng(4)
    logits_in = rng.normal(size=ids.shape + (V,)).astype(np.float32)
    logits_in += 6.0 * np.eye(V, dtype=np.float32)[ids]  # near one-hots of the ids
    soft = np.exp(logits_in - logits_in.max(-1, keepdims=True))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    w = rng.normal(size=(ids.shape[0],)).astype(np.float32)
    loss = lambda p, x: jnp.sum(jmod.apply(p, x) * w)
    jl, (jg, jx) = _jax_value_and_grads(loss, params, jnp.asarray(soft), argnums=(0, 1))
    x = t(soft).requires_grad_()
    model.zero_grad()
    out = model(x)
    (out * t(w)).sum().backward()
    with compute_dtype_scope("float32"):
        jlogits = jax.jit(jmod.apply)(params, jnp.asarray(soft))
    close(out, jlogits, 1e-5, 1e-5, "logits")
    close(x.grad, jx, 1e-4 * float(np.abs(np.asarray(jx)).max()), 1e-4, "d one-hots")
    close_grads(port_grads(model), from_flax_grads(jax.tree_util.tree_map(np.asarray, jg)))


def _graphs():
    """Real ligand graphs of two val complexes (the trainer's _real_graph)
    and the host graphs of corpus targets plus an invalid row, each [B, 64, ...]."""
    from singa_tpu_torch.data.batch import stack
    from singa_tpu_torch.train.gan import GANTrainer
    from singa_tpu_torch.train.rewards import graph_batch_host

    rx, radj, rmask = GANTrainer._real_graph(stack(load_val(2)))
    fx, fmask, fadj, fvalid = graph_batch_host(_token_rows()[[0, 1, 40]], 64)
    x = np.concatenate([rx.numpy(), fx[:2]])
    adj = np.concatenate([radj.numpy(), fadj[:2]])
    mask = np.concatenate([rmask.numpy(), fmask[:2]])
    return x, adj, mask, fvalid


def test_gin_discriminator_matches_jax():
    """GINDiscriminatorDense: logits, and the gradients of sum(w * logits)
    with respect to the node features, the (interpolated) adjacency and
    every parameter."""
    from singa_tpu.models.discriminator import GINDiscriminatorDense as JGIN
    from singa_tpu_torch.models.discriminator import GINDiscriminatorDense
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    x, adj, mask, fvalid = _graphs()
    assert fvalid.tolist() == [1.0, 1.0, 0.0] and mask.sum(1).min() >= 3
    adj = 0.7 * adj + 0.3 * adj[::-1]  # interpolated, as WGAN-GP feeds it
    jmod = JGIN()
    with compute_dtype_scope("float32"):
        params = jax.jit(jmod.init)(jax.random.PRNGKey(5), x, adj, mask)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = GINDiscriminatorDense(x.shape[-1], device="cpu")
    load_flax_params(model, params)
    w = np.random.default_rng(6).normal(size=(x.shape[0],)).astype(np.float32)
    loss = lambda p, x_, a_: jnp.sum(jmod.apply(p, x_, a_, mask) * w)
    jl, (jg, jx, ja) = _jax_value_and_grads(loss, params, x, adj, argnums=(0, 1, 2))
    xt, at = t(x).requires_grad_(), t(adj).requires_grad_()
    out = model(xt, at, t(mask))
    (out * t(w)).sum().backward()
    with compute_dtype_scope("float32"):
        jlogits = jax.jit(jmod.apply)(params, x, adj, mask)
    close(out, jlogits, 1e-5, 1e-5, "logits")
    for got, want, name in ((xt.grad, jx, "dx"), (at.grad, ja, "dadj")):
        close(got, want, 1e-4 * float(np.abs(np.asarray(want)).max()), 1e-4, name)
    close_grads(port_grads(model), from_flax_grads(jax.tree_util.tree_map(np.asarray, jg)))


def test_discriminators_never_drop():
    """The port's discriminators hold no dropout (JAX applies its Dropout
    layers deterministically): train and eval mode give the same logits."""
    from singa_tpu_torch.models.discriminator import GINDiscriminatorDense, SeqDiscriminator
    from singa_tpu_torch.params import seeded_init

    seq, gin = SeqDiscriminator(V, device="cpu"), GINDiscriminatorDense(59, device="cpu")
    seeded_init(seq, 0)
    seeded_init(gin, 1)
    assert not any(isinstance(m, torch.nn.Dropout) for m in (*seq.modules(), *gin.modules()))
    ids = t(_targets(3))
    x, adj, mask, _ = _graphs()
    outs = []
    for mode in (True, False):
        seq.train(mode)
        gin.train(mode)
        outs.append((seq(ids), gin(t(x), t(adj), t(mask))))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------- rewards


def test_rewards_equal_jax_bit_for_bit():
    """chem_reward_host, chem_reward_host_shaped, graph_batch_host and
    validity_stats on corpus targets, corrupted and garbage rows: equal to
    the JAX package's, array for array and key for key."""
    from singa_tpu.train import rewards as jr
    from singa_tpu_torch.train import rewards as tr

    tokens = _token_rows()
    assert (tr.QED_GOOD, tr.SAS_GOOD) == (jr.QED_GOOD, jr.SAS_GOOD)
    jm, tm = jr._parse_tokens(tokens), tr._parse_tokens(tokens)
    assert [m is None for m in tm] == [m is None for m in jm]
    valid = [m is not None for m in tm]
    assert sum(valid[:24]) >= 20 and not all(valid[24:])  # some invalid rows, most corpus ones valid
    for fn in ("chem_reward_host", "chem_reward_host_shaped"):
        got, want = getattr(tr, fn)(tokens), getattr(jr, fn)(tokens)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=fn)
    for got, want in zip(tr.graph_batch_host(tokens, 64), jr.graph_batch_host(tokens, 64)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tr.validity_stats(tokens) == jr.validity_stats(tokens)
    assert tr.validity_stats(tokens[24:]) == jr.validity_stats(tokens[24:])
