"""The adversarial round at bfloat16 against the JAX package's, at the tiny
config (lmax 2, gate FFN) with the corpus's padding shapes, on two val
complexes, grammar mask on, CPU: the port's ``GANTrainer`` with
``train.compute_dtype: bfloat16`` (each step under its own
``compute_dtype_scope``) against JAX's ``GANTrainer`` under
``compute_dtype_scope("bfloat16")``, from the same weights (the generator's
and both discriminators', carried over by the bridge), on the complexes'
own SMILES (valid molecules, so the graph terms of valid fakes take part)
and JAX's WGAN-GP interpolation weights. Every optimizer is replaced by one
that keeps the gradient and moves nothing (JAX: an optax transformation
that keeps it in its state; the port: SGD at lr 0), so each step's
gradients are compared as they are, and the g step sees the
discriminators the JAX one sees.

The yardstick is JAX's own float32 round from the same weights, whose
distance from JAX's bfloat16 round is what bfloat16's rounding costs.
The port rounds at the same points as JAX but sums in other orders, so
where a value sits near a rounding boundary the two land a bfloat16 step
apart (68% of the encoder's outputs and 44% of the logits are equal bit
for bit here, the rest a step or so apart): two draws of that rounding
noise, which put the port at up to about sqrt(2) times JAX float32's
distance, and past it where REINFORCE's advantage-weighted sum of two
sequences' gradients cancels most of them (the g step). So each step's
gradients, by the largest difference over the module's largest gradient
and by the L2 difference over the L2 norm, are held within ``GRAD_RATIO``
= 2 times JAX float32's distance and within ``GRAD_GAP`` = 5e-2 (measured
on the g step: 0.047 and 0.040 against JAX float32's 0.037 and 0.027;
the d and WGAN-GP gd steps: nearer than JAX float32, 0.0025 and 0.0014 L2
against 0.0028 and 0.034). The losses within ``LOSS_RTOL`` = 5e-3 of JAX's
(measured 1.6e-3, the g step's), the accuracies and valid shares equal.

The log-probs: ``sequence_logp`` (teacher-forced) and the KV-cached
sampler's recorded log-probs (the port's sampler forced onto the tokens
JAX's bfloat16 sampler drew), each against JAX's at bfloat16 within
``LOGP_ATOL`` = 5e-2 per position (a log-softmax of bfloat16 logits, each
of which may stand a step apart), the sequences' sums within GRAD_RATIO
times JAX float32's distance from JAX bfloat16's.
"""
from __future__ import annotations

import dataclasses
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

LOSS_RTOL = 5e-3
GRAD_GAP = 5e-2
GRAD_RATIO = 2.0
LOGP_ATOL = 5e-2


def _bf16_config(jcfg):
    return dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                               compute_dtype="bfloat16"))


def _keep_grads():
    """An optax transformation that moves nothing and keeps the last
    gradient in its state (``state["g"]``)."""
    import optax

    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(lambda p: {"g": zeros(p)},
                                        lambda g, s, p=None: (zeros(g), {"g": g}))


@functools.lru_cache(maxsize=None)
def _jax_round(dt: str):
    """JAX's WGAN-GP round at ``dt`` on the corpus tokens: {"d", "gd", "g":
    (losses..., gradients)}, the tokens, chem rewards, fake graphs and the
    trainer's initial state."""
    from singa_tpu.train.gan import GANTrainer as JGAN

    _, params = singa_params(2, 2)
    jcfg = gan_jax_config(2, 2)
    files = load_val(2)
    jb = jax_batch(files)
    with compute_dtype_scope(dt):
        jtr = JGAN(jcfg, graph_loss="wgan-gp", grammar_mask=True)
        jtr.g_optimizer = jtr.d_optimizer = jtr.gd_optimizer = _keep_grads()
        s0 = jtr.init(jax.random.PRNGKey(1), params, jb)
        tokens = jnp.asarray(sos_tokens(files, jcfg.model.decoder.tgt_len))
        chem_r, fake = jtr._host_bridge(tokens)
        s1, dl, da = jtr.d_step(s0, jb, tokens)
        s2, gdl, gda = jtr.gd_step(s1, jb, fake, jax.random.PRNGKey(3))
        s3, gl, gr, gv = jtr.g_step(s2, jb, tokens, chem_r, fake)
    tree = lambda g: jax.tree_util.tree_map(np.asarray, g)
    return {"d": (float(dl), float(da), tree(s1.d_opt["g"])),
            "gd": (float(gdl), float(gda), tree(s2.gd_opt["g"])),
            "g": (float(gl), float(gr), float(gv), tree(s3.g_opt["g"])),
            "tokens": np.asarray(tokens), "chem_r": np.asarray(chem_r),
            "fake": [np.asarray(a) for a in fake], "s0": s0}


@pytest.fixture(scope="module")
def bf16_round():
    """(JAX bfloat16 round, JAX float32 round, the port's bfloat16 round:
    {"d", "gd", "g": (losses..., {name: gradient})})."""
    from singa_tpu_torch.data.batch import stack
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import load_flax_params
    from singa_tpu_torch.train.gan import GANTrainer

    j16, j32 = _jax_round("bfloat16"), _jax_round("float32")
    _, params = singa_params(2, 2)
    cfg = port_config(_bf16_config(gan_jax_config(2, 2)))
    assert cfg.train.compute_dtype == "bfloat16"
    tb = stack(load_val(2))
    gen = SINGA(cfg, device="cpu")
    load_flax_params(gen, params)
    tr = GANTrainer(cfg, graph_loss="wgan-gp", grammar_mask=True)
    tr.init(gen, seed=0)
    s0 = j16["s0"]
    load_flax_params(tr.disc, jax.tree_util.tree_map(np.asarray, s0.d_params))
    load_flax_params(tr.graph_disc, jax.tree_util.tree_map(np.asarray, s0.gd_params))
    tr.g_opt, tr.d_opt, tr.gd_opt = (torch.optim.SGD(m.parameters(), lr=0.0)
                                     for m in (gen, tr.disc, tr.graph_disc))
    grads = lambda m: {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                       for n, p in m.named_parameters()}  # Encoder2's: no gradient
    ttok = t(j16["tokens"]).long()
    chem, fake = tr._host_bridge(ttok)
    eps = t(np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (tb.batch_size, 1, 1))))
    port = {}
    dl, da = tr.d_step(tb, ttok)
    port["d"] = (float(dl), float(da), grads(tr.disc))
    gdl, gda = tr.gd_step(tb, fake, eps)
    port["gd"] = (float(gdl), float(gda), grads(tr.graph_disc))
    gl, gr, gv = tr.g_step(tb, ttok, chem, fake)
    port["g"] = (float(gl), float(gr), float(gv), grads(gen))
    port["chem_r"], port["fake"] = chem.numpy(), [a.numpy() for a in fake]
    return j16, j32, port


def _by_name(tree) -> dict:
    from singa_tpu_torch.params import from_flax_grads

    return from_flax_grads(tree)


def _gaps(got: dict, want: dict) -> tuple[float, float]:
    """The largest difference over the set's largest magnitude, and the L2
    difference over the L2 norm, of the whole set."""
    names = sorted(want)
    cat = lambda d: np.concatenate([np.asarray(d[n], np.float64).ravel() for n in names])
    a, b = cat(got), cat(want)
    return float(np.abs(a - b).max() / np.abs(b).max()), float(np.linalg.norm(a - b)
                                                                / np.linalg.norm(b))


def _held(key, j16, j32, port):
    """Gradients of one step: the port's against JAX bfloat16's, each gap
    within GRAD_RATIO times JAX float32's and within GRAD_GAP."""
    want = _by_name(j16[key][-1])
    got = {n: g.numpy() for n, g in port[key][-1].items()}
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    assert all(np.isfinite(g).all() for g in got.values()), key
    port_gaps, f32_gaps = _gaps(got, want), _gaps(_by_name(j32[key][-1]), want)
    for p, f in zip(port_gaps, f32_gaps):
        assert p <= GRAD_RATIO * f and p <= GRAD_GAP, (key, port_gaps, f32_gaps)


def test_host_bridge_is_the_same_at_bfloat16(bf16_round):
    j16, _, port = bf16_round
    np.testing.assert_array_equal(port["chem_r"], j16["chem_r"])
    for got, want in zip(port["fake"], j16["fake"]):
        np.testing.assert_array_equal(got, want)
    assert j16["fake"][3].tolist() == [1.0, 1.0]  # the complexes' own SMILES parse


def test_bf16_sequence_discriminator_step_matches_jax(bf16_round):
    """The d step: BCE loss of bfloat16 logits (the Linears cast, the
    residual stream float32, as flax's promotion keeps it), its accuracy
    and the gradients of every discriminator parameter."""
    j16, j32, port = bf16_round
    (jl, ja, _), (l, a, _) = j16["d"], port["d"]
    assert abs(l - jl) <= LOSS_RTOL * abs(jl), (l, jl, j32["d"][0])
    assert a == ja
    _held("d", j16, j32, port)


def test_bf16_wgan_gp_step_matches_jax(bf16_round):
    """The WGAN-GP graph-discriminator step at bfloat16: the critic's
    gradient with respect to its float32 interpolated inputs (bfloat16
    Linears inside), its norm and penalty in float32, the gradient of that
    gradient."""
    j16, j32, port = bf16_round
    (jl, ja, _), (l, a, _) = j16["gd"], port["gd"]
    assert abs(l - jl) <= LOSS_RTOL * abs(jl), (l, jl, j32["gd"][0])
    assert a == ja
    _held("gd", j16, j32, port)


def test_bf16_generator_step_matches_jax(bf16_round):
    """The g step at bfloat16: the REINFORCE loss, mean reward and valid
    share, and the gradient of every generator parameter (encode_pocket's
    kernels at bfloat16 and the teacher-forced decode among them)."""
    j16, j32, port = bf16_round
    (jl, jr, jv, _), (l, r, v, _) = j16["g"], port["g"]
    assert abs(l - jl) <= LOSS_RTOL * abs(jl), (l, jl, j32["g"][0])
    assert abs(r - jr) <= LOSS_RTOL * abs(jr), (r, jr, j32["g"][1])
    assert v == jv
    _held("g", j16, j32, port)
    assert any(float(g.abs().max()) > 0 for n, g in port["g"][-1].items()
               if n.startswith("embedding."))


@functools.lru_cache(maxsize=None)
def _jax_logps(dt: str, tokens_key: int):
    """JAX's sampler at ``dt`` (grammar mask on): its tokens and recorded
    log-probs [B, T], and ``sequence_logp`` of those tokens at ``dt``."""
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import binarize_props as jbinarize
    from singa_tpu.train.gan import sample_sequences as jsample
    from singa_tpu.train.gan import sequence_logp as jlogp

    jcfg, params = singa_params(2, 2)
    jb = jax_batch(load_val(2))
    model = JSINGA(jcfg)
    T = jcfg.model.decoder.tgt_len

    def run(p, b, key, tokens=None):
        enc, pad = model.apply(p, b, method="encode_pocket")
        prop = jbinarize(b, jcfg.model.props)
        if tokens is None:
            return jsample(model, p, enc, pad, prop, key, T, grammar_mask=True)
        return jlogp(model, p, tokens, enc, pad, prop, grammar_mask=True)

    with compute_dtype_scope(dt):
        if dt == "bfloat16":
            tokens, logp = jax.jit(run)(params, jb, jax.random.PRNGKey(tokens_key))
        else:  # float32's log-probs of the bfloat16 sampler's tokens
            tokens = jnp.asarray(_jax_logps("bfloat16", tokens_key)[0])
            logp = None
        seq = jax.jit(run)(params, jb, None, tokens)
    return np.asarray(tokens), None if logp is None else np.asarray(logp), np.asarray(seq)


def test_bf16_logps_match_jax(monkeypatch):
    """``sequence_logp`` and the KV-cached sampler's log-probs (the port's
    sampler made to draw the tokens JAX's bfloat16 sampler drew) at
    bfloat16 against JAX's, per position within LOGP_ATOL, the sequences'
    within GRAD_RATIO times JAX's float32 log-probs' distance."""
    import singa_tpu_torch.train.gan as gan
    from singa_tpu_torch.data.batch import stack
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA, binarize_props
    from singa_tpu_torch.params import load_flax_params

    tokens, jlogp, jseq = _jax_logps("bfloat16", 2)
    _, _, fseq = _jax_logps("float32", 2)
    jcfg, params = singa_params(2, 2)
    cfg = port_config(_bf16_config(jcfg))
    model = SINGA(cfg, device="cpu")
    load_flax_params(model, params)
    tb = stack(load_val(2))
    step = iter(range(1, tokens.shape[1]))
    monkeypatch.setattr(gan, "_categorical", lambda logits, g: t(tokens)[:, next(step)].long())
    with port_scope("bfloat16"), torch.no_grad():
        enc, pad = model.encode_pocket(tb)
        prop = binarize_props(tb, cfg.model.props)
        got_tokens, logp = gan.sample_sequences(model, enc, pad, prop, torch.Generator(),
                                                tokens.shape[1], grammar_mask=True)
        seq = gan.sequence_logp(model, got_tokens, enc, pad, prop, grammar_mask=True)
    np.testing.assert_array_equal(got_tokens.numpy(), tokens)
    assert logp.dtype == seq.dtype == torch.float32
    np.testing.assert_allclose(logp.numpy(), jlogp, rtol=0, atol=LOGP_ATOL)
    np.testing.assert_allclose(seq.numpy(), jseq, rtol=0, atol=LOGP_ATOL)
    assert np.abs(seq.numpy() - jseq).max() <= GRAD_RATIO * np.abs(fseq - jseq).max()
    assert np.abs(logp.numpy().sum(1) - jseq).max() <= LOGP_ATOL


def test_bf16_decode_cache_takes_the_compute_dtype():
    """The KV cache's keys and values are bfloat16 under bfloat16 (JAX's
    cache variables take the dtype of the keys written into them) and
    float32 otherwise; the cross-attention entries alike."""
    from singa_tpu_torch.data.batch import stack
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA, binarize_props

    cfg = port_config(_bf16_config(gan_jax_config(2, 2)))
    model = SINGA(cfg, device="cpu", seed=0)
    tb = stack(load_val(2))
    for dt, want in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        with port_scope(dt), torch.no_grad():
            enc, pad = model.encode_pocket(tb)
            cache = model.prime_cache(enc, pad, binarize_props(tb, cfg.model.props))
            logits = model.decode_token(torch.zeros((2, 1), dtype=torch.long), 0, cache)
        for ts in (cache.self_k, cache.self_v, cache.cross_k, cache.cross_v):
            assert {x.dtype for x in ts} == {want}, dt
        assert logits.dtype == want and cache.length == 2


def test_gan_cli_trains_at_the_configs_bfloat16(tmp_path, capsys, monkeypatch):
    """The GAN CLI on a tiny config file at bfloat16 (``--synthetic --device
    cpu``, one round): it prints the precision line ``training_config``
    gives, keeps bfloat16 in the run's config.yml and logs finite losses;
    under ``SINGA_TPU_HYBRID_ATTN`` (K7/K7b) the same file keeps bfloat16,
    and so does, under ``SINGA_TPU_FUSED_SO2`` (K6/K6b), the file at 128
    attention channels (where K6 runs)."""
    import json
    import math

    import yaml

    from singa_tpu_torch.train.gan import main

    cfg = port_config(_bf16_config(gan_jax_config(2, 2)))
    cfg_path = tmp_path / "tiny_bf16.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    common = ["--config", str(cfg_path), "--synthetic", "--device", "cpu", "--batch-size", "2",
              "--graph-loss", "wgan-gp", "--grammar-mask"]
    main([*common, "--rounds", "1", "--logdir", str(tmp_path / "bf16")])
    assert f"config: {cfg_path} with train.compute_dtype=bfloat16\n" in capsys.readouterr().out
    with open(tmp_path / "bf16" / "config.yml") as f:
        assert yaml.safe_load(f)["train"]["compute_dtype"] == "bfloat16"
    with open(tmp_path / "bf16" / "metrics.jsonl") as f:
        first = json.loads(f.readline())
    assert all(math.isfinite(first[k]) for k in ("gan/d_loss", "gan/gd_loss", "gan/g_loss"))
    with monkeypatch.context() as m:
        m.setenv("SINGA_TPU_HYBRID_ATTN", "1")
        main([*common, "--rounds", "0", "--logdir", str(tmp_path / "hybrid")])
        assert f"config: {cfg_path} with train.compute_dtype=bfloat16\n" in capsys.readouterr().out
        with open(tmp_path / "hybrid" / "config.yml") as f:
            assert yaml.safe_load(f)["train"]["compute_dtype"] == "bfloat16"
    so2 = dataclasses.replace(cfg, embedding=dataclasses.replace(cfg.embedding,
                                                                 attn_hidden_channels=128))
    so2_path = tmp_path / "tiny_bf16_so2.yml"
    with open(so2_path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(so2))), f)
    monkeypatch.setenv("SINGA_TPU_FUSED_SO2", "1")
    main([*common[:1], str(so2_path), *common[2:], "--rounds", "0", "--logdir",
          str(tmp_path / "so2")])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("config:")][0]
    assert line == f"config: {so2_path} with train.compute_dtype=bfloat16"
    with open(tmp_path / "so2" / "config.yml") as f:
        assert yaml.safe_load(f)["train"]["compute_dtype"] == "bfloat16"
