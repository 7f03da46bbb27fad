"""One adversarial round of the port against the JAX package's GANTrainer,
at the tiny config (lmax 2, gate FFN) with the corpus's padding shapes, on
two val complexes, grammar mask on, float32, CPU. Both trainers start from
the same weights (the generator's and both discriminators', carried over by
the bridge); the port is fed the tokens JAX sampled (the two samplers draw
from different generators) and JAX's WGAN-GP interpolation weights. The
host bridge's rewards and graphs, the sequence-D step, the graph-D step
(WGAN-GP and BCE), their eval forms and the generator step give JAX's
losses, accuracies and parameters after each update.

Tolerances: losses to 1e-5 relative (1e-4 for the WGAN-GP loss, a gradient
norm of a float32 stack); accuracies equal. Parameters after an Adam update
(``close_after_adam``): the first update moves an element by lr times
g / (|g| + eps) with eps 1e-8, so where the gradient stands clear of float32
noise (10x the bound ``close_grads`` holds gradients to) and of 100 eps
(below which the move depends on |g|, which float32 sets only to 1e-4 of
the leaf's scale) the move must equal JAX's within 1e-3 of lr plus two
float32 ulps of the parameter; every other element (a softmax-cancelled
bias, a gradient at round-off) moves by at most lr either way, in both
packages.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import (
    gan_jax_config,
    jax_batch,
    load_val,
    port_config,
    singa_params,
    sos_tokens,
    t,
)

G_LR, D_LR = 1e-5, 1e-4
ADAM_EPS = 1e-8


def close_after_adam(module, before: dict, want_tree, lr: float, msg: str) -> None:
    """Parameters of ``module`` after one Adam step from ``before`` against
    JAX's ``want_tree``, as the module docstring says; the gradients are the
    port's (``p.grad`` of the step)."""
    from singa_tpu_torch.params import from_flax

    want = from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    named = dict(module.named_parameters())
    assert set(named) == set(want)
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in named.items()}
    top = max(float(g.abs().max()) for g in grads.values())
    assert top > 0, msg
    moved = 0
    for name, p in named.items():
        g = grads[name]
        b = before[name]
        got_d, want_d = p.detach() - b, t(want[name]) - b
        sure = (g.abs() > 1e-3 * max(float(g.abs().max()), 1e-3 * top)) & (g.abs() > 100 * ADAM_EPS)
        err = (got_d - want_d).abs()
        bound = 1e-3 * lr + 2 * torch.finfo(torch.float32).eps * torch.maximum(b.abs(), p.detach().abs())
        assert bool((err <= bound)[sure].all()), (msg, name, float(err[sure].max()))
        assert float(got_d.abs().max()) <= lr * (1 + 1e-3) + float(bound.max()), (msg, name)
        assert float(want_d.abs().max()) <= lr * (1 + 1e-3) + float(bound.max()), (msg, name)
        moved += int(sure.sum())
    assert moved > 0, msg


def _snapshot(module) -> dict:
    return {n: p.detach().clone() for n, p in module.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_trainers():
    """JAX's WGAN-GP and BCE trainers and their initial states (one set of
    compiled steps for both token sources)."""
    from singa_tpu.train.gan import GANTrainer as JGAN

    _, params = singa_params(2, 2)
    jcfg = gan_jax_config(2, 2)
    jb = jax_batch(load_val(2))
    with compute_dtype_scope("float32"):
        jtr = JGAN(jcfg, graph_loss="wgan-gp", grammar_mask=True)
        jbce = JGAN(jcfg, graph_loss="bce", grammar_mask=True)
        return jtr, jtr.init(jax.random.PRNGKey(1), params, jb), jbce, jbce.init(
            jax.random.PRNGKey(1), params, jb)


@pytest.fixture(scope="module", params=["sampled", "corpus"])
def rounds(request):
    """JAX's round pieces and the port's, each from the same state, on the
    tokens JAX's sampler drew ('sampled': a random tiny generator's, which
    rarely parse) or on the complexes' own SMILES ('corpus': valid
    molecules, so the graph terms of valid fakes take part)."""
    from singa_tpu.train.gan import GANTrainer as JGAN
    from singa_tpu_torch.data.batch import stack
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import load_flax_params
    from singa_tpu_torch.train.gan import GANTrainer

    _, params = singa_params(2, 2)
    jcfg = gan_jax_config(2, 2)
    files = load_val(2)
    jb, tb = jax_batch(files), stack(files)
    B = tb.batch_size
    jtr, s0, jbce, b0 = _jax_trainers()
    out = {"jax": {}, "port": {}, "source": request.param}
    with compute_dtype_scope("float32"):
        if request.param == "sampled":
            tokens = jtr.sample(s0.g_params, jb, jax.random.PRNGKey(2))
        else:
            tokens = jnp.asarray(sos_tokens(files, jcfg.model.decoder.tgt_len))
        chem_r, fake = jtr._host_bridge(tokens)
        eps_key = jax.random.PRNGKey(3)
        out["jax"]["d_eval"] = jtr.d_eval(s0.d_params, jb, tokens)
        out["jax"]["gd_eval"] = jtr.gd_eval(s0.gd_params, jb, fake, eps_key)
        s1, *out["jax"]["d"] = jtr.d_step(s0, jb, tokens)
        s2, *out["jax"]["gd"] = jtr.gd_step(s1, jb, fake, eps_key)
        s3, *out["jax"]["g"] = jtr.g_step(s2, jb, tokens, chem_r, fake)
        b1, *out["jax"]["gd_bce"] = jbce.gd_step(b0, jb, fake, eps_key)
        real = JGAN._real_graph(jb)
    eps = np.asarray(jax.random.uniform(eps_key, (B, 1, 1)))
    out["jax"].update(tokens=np.asarray(tokens), chem_r=np.asarray(chem_r),
                      fake=[np.asarray(a) for a in fake], real=[np.asarray(a) for a in real],
                      s1=s1, s2=s2, s3=s3, b1=b1)

    cfg = port_config(jcfg)

    def port_trainer(graph_loss):
        gen = SINGA(cfg, device="cpu")
        load_flax_params(gen, params)
        tr = GANTrainer(cfg, graph_loss=graph_loss, grammar_mask=True)
        tr.init(gen, seed=0)
        load_flax_params(tr.disc, jax.tree_util.tree_map(np.asarray, s0.d_params))
        load_flax_params(tr.graph_disc, jax.tree_util.tree_map(np.asarray, s0.gd_params))
        assert tr.disc.embedding.shape == (116, 256)
        return tr

    tr = port_trainer("wgan-gp")
    ttok = t(out["jax"]["tokens"]).long()
    chem_t, fake_t = tr._host_bridge(ttok)
    p = out["port"]
    p.update(chem_r=chem_t.numpy(), fake=[a.numpy() for a in fake_t],
             real=[a.numpy() for a in GANTrainer._real_graph(tb)])
    p["d_eval"] = tr.d_eval(tb, ttok)
    p["gd_eval"] = tr.gd_eval(tb, fake_t, t(eps))
    p["before_d"], p["before_gd"], p["before_g"] = (_snapshot(tr.disc), _snapshot(tr.graph_disc),
                                                    _snapshot(tr.generator))
    p["d"] = tr.d_step(tb, ttok)
    p["gd"] = tr.gd_step(tb, fake_t, t(eps))
    p["g"] = tr.g_step(tb, ttok, chem_t, fake_t)
    p["trainer"] = tr
    bce = port_trainer("bce")
    p["gd_bce"] = bce.gd_step(tb, fake_t)
    p["bce"] = bce
    return out


def test_host_bridge_and_real_graph_equal_jax(rounds):
    j, p = rounds["jax"], rounds["port"]
    np.testing.assert_array_equal(p["chem_r"], j["chem_r"])
    for got, want in zip(p["fake"], j["fake"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(p["real"], j["real"]):
        np.testing.assert_array_equal(got, want)
    assert j["real"][1].sum() > 0  # the ligands' covalent edges
    if rounds["source"] == "corpus":  # the complexes' own SMILES parse
        assert j["fake"][3].tolist() == [1.0, 1.0] and (j["chem_r"] >= 1).all()


def test_eval_forms_match_jax(rounds):
    j, p = rounds["jax"], rounds["port"]
    for key, rtol in (("d_eval", 1e-5), ("gd_eval", 1e-4)):
        (jl, ja), (l, a) = j[key], p[key]
        np.testing.assert_allclose(float(l), float(jl), rtol=rtol, err_msg=key)
        assert float(a) == float(ja), key


def test_sequence_discriminator_step_matches_jax(rounds):
    j, p = rounds["jax"], rounds["port"]
    (jl, ja), (l, a) = j["d"], p["d"]
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    assert float(a) == float(ja)
    tr = p["trainer"]
    close_after_adam(tr.disc, p["before_d"], j["s1"].d_params, D_LR, "d")


def test_graph_discriminator_steps_match_jax(rounds):
    """WGAN-GP (the critic's input gradient differentiated again) and BCE."""
    j, p = rounds["jax"], rounds["port"]
    for key, state, tr, rtol in (("gd", j["s2"], p["trainer"], 1e-4),
                                 ("gd_bce", j["b1"], p["bce"], 1e-5)):
        (jl, ja), (l, a) = j[key], p[key]
        np.testing.assert_allclose(float(l), float(jl), rtol=rtol, err_msg=key)
        assert float(a) == float(ja), key
        close_after_adam(tr.graph_disc, p["before_gd"], state.gd_params, D_LR, key)


def test_generator_step_matches_jax(rounds):
    j, p = rounds["jax"], rounds["port"]
    (jl, jr, jv), (l, r, v) = j["g"], p["g"]
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-5)
    assert float(v) == float(jv)
    close_after_adam(p["trainer"].generator, p["before_g"], j["s3"].g_params, G_LR, "g")
