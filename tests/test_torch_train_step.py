"""The whole training step of the port against the JAX package: with bridged
weights, on 2 ``data/corpus/val`` complexes at the tiny config (lmax 2),
float32, ``SINGA.forward``'s logits, ``cross_entropy_loss`` and every
parameter's gradient equal ``jax.value_and_grad`` of the JAX loss, leaf by
leaf through the gradient bridge; and the microbatched step equals the
monolithic one. Each test runs under both FFN activations the port has
('gate', kernel K2; 's2', kernel K4): the ``step`` fixture is parametrised.

Tolerances: logits to 1e-4 (LayerNorm'd stacks of reordered float32 sums),
the loss to 1e-5 relative, gradients leaf by leaf to 1e-4 of the leaf's
largest magnitude, with a floor of 1e-3 of the largest gradient of the model
for leaves whose true gradient is zero (``close_grads``).
"""
from __future__ import annotations

import dataclasses

import jax
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
    torch_batch,
)


@pytest.fixture(scope="module", params=["gate", "s2"])
def step(request):
    """JAX: loss, logits and gradients; port: the same, from one model, with
    the TransBlocks' FFN activation ``request.param``."""
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import cross_entropy_loss as jce
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    jcfg, params = singa_params(2, 2, ffn_activation=request.param)
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)

    def loss_fn(p, b):
        logits = JSINGA(jcfg).apply(p, b)
        return jce(logits, b.tokens.target), logits

    with compute_dtype_scope("float32"):
        (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jb)
    model = SINGA(port_config(jcfg), device="cpu")
    load_flax_params(model, params)
    logits = model(tb)
    loss = cross_entropy_loss(logits, tb.tokens.target)
    loss.backward()
    return {
        "jcfg": jcfg, "params": params, "tb": tb,
        "jax": (float(jloss), np.asarray(jlogits), from_flax_grads(jax.tree_util.tree_map(np.asarray, jgrads))),
        "port": (loss.item(), logits.detach(), port_grads(model)),
    }


def test_forward_logits_and_loss_match_jax(step):
    jloss, jlogits, _ = step["jax"]
    loss, logits, _ = step["port"]
    assert logits.shape == jlogits.shape and logits.shape[::2] == (2, 116)
    close(logits, jlogits, 1e-4, 1e-4, "logits")
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_every_gradient_matches_jax(step):
    """Every parameter of the port (both embedding stages, encoder 1,
    Encoder2, the decoder, the projection) gets JAX's gradient; every one is
    finite and the set is the flax tree's, leaf for leaf."""
    _, _, jgrads = step["jax"]
    _, _, grads = step["port"]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
    assert any(n.startswith("model.encoder2.") for n in grads)
    close_grads(grads, jgrads)


def test_microbatched_step_equals_monolithic(step, tmp_path):
    """Trainer.train_step in 2 microbatches of 1 gives the monolithic loss,
    gradients and updated parameters."""
    from singa_tpu_torch.params import load_flax_params
    from singa_tpu_torch.train.loop import Trainer, float32_config

    cfg = float32_config(port_config(step["jcfg"]))
    results = {}
    for micro in (None, 1):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, microbatch=micro))
        tr = Trainer(c, logdir=str(tmp_path / f"m{micro}"), device="cpu")
        load_flax_params(tr.model, step["params"])
        loss, gnorm = tr.train_step(step["tb"])
        named = dict(tr.model.named_parameters())
        results[micro] = (loss.item(), gnorm.item(), port_grads(tr.model),
                          {n: p.detach().clone() for n, p in named.items()},
                          {n: tr.optimizer.state[p]["exp_avg"].clone() for n, p in named.items()})
    (l0, g0, gr0, p0, m0), (l1, g1, gr1, p1, m1) = results[None], results[1]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(l0, step["port"][0], rtol=1e-6)
    np.testing.assert_allclose(g1, g0, rtol=1e-4)
    want = {n: g.numpy() for n, g in gr0.items()}
    close_grads(gr1, want)
    # Adam's first moment after one step is (1 - beta1) * grad: the update
    # consumed the same gradients
    beta1 = cfg.train.optimizer.beta1
    close_grads({n: m / (1 - beta1) for n, m in m1.items()},
                {n: m.numpy() / (1 - beta1) for n, m in m0.items()})
    # its first step moves each parameter by lr * g / (|g| + eps), ~ lr *
    # sign(g). Where |g| is ten times clear of close_grads' tolerance the
    # sign is certain and the two parameters agree to lr / 100 (the
    # parameter's own round-off); elsewhere (softmax-invariant biases, whose
    # true gradient is zero) only to one update, 2 lr
    lr = cfg.train.optimizer.lr
    top = max(float(np.abs(w).max()) for w in want.values())
    clear = total = 0
    for n in p0:
        w = want[n]
        sure = np.abs(w) > 10 * 1e-4 * max(float(np.abs(w).max()), 1e-3 * top)
        a, b = p1[n].numpy(), p0[n].numpy()
        np.testing.assert_allclose(a[sure], b[sure], atol=lr / 100, rtol=0, err_msg=n)
        np.testing.assert_allclose(a, b, atol=2 * lr, rtol=0, err_msg=n)
        clear, total = clear + int(sure.sum()), total + w.size
    # about half of the elements (the rest: token embeddings the two complexes
    # never use, small gradients of wide matrices)
    assert clear > total / 3, (clear, total)


def test_encoder2_registers_last_so_seeded_weights_keep():
    """SINGA(cfg, seed) draws Encoder2's weights after every other module's:
    without Encoder2 the same seed gives every other parameter the same
    value, so the generation path's seeded weights are those of the serving
    slice."""
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import seeded_init
    from test_torch_common import tiny_jax_config

    cfg = port_config(tiny_jax_config())
    model = SINGA(cfg, device="cpu", seed=3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model.model.encoder2
    seeded_init(model, 3)
    after = dict(model.named_parameters())
    assert set(before) - set(after) and all(n.startswith("model.encoder2.") for n in set(before) - set(after))
    for n, p in after.items():
        assert torch.equal(p, before[n]), n
