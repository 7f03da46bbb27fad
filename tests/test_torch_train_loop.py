"""The port's trainer around the step: Adam against optax, the plateau
schedule and early stopping, the datasets' order and the synthetic batch
against the JAX package's, the prefetcher, Trainer.fit with its metrics and
checkpoints, two training steps against JAX's trainer, the training CLI and
generation from a trainer checkpoint. CPU, tiny config, float32.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_common import REPO, port_config, t, tiny_jax_config

TGT_LEN = 24  # tests/test_model.py


def _tiny(batch_size=4, microbatch=2):
    """(jax config, port config): the tiny config in float32, small batches."""
    jcfg = tiny_jax_config()
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, compute_dtype="float32", batch_size=batch_size, microbatch=microbatch))
    return jcfg, port_config(jcfg)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("weight_decay,max_grad_norm", [(0.0, float("inf")), (0.01, float("inf")),
                                                        (0.0, 0.5)])
def test_optimizer_matches_optax_after_three_updates(weight_decay, max_grad_norm):
    """The same gradients into optax's make_optimizer and the port's give
    the same parameters after 3 updates: bias correction with beta1 0.99,
    decoupled weight decay, global-norm clipping. atol 1e-7: parameters
    move by ~lr = 1e-3 per update, float32 round-off of that."""
    from singa_tpu.config import OptimizerConfig as JOC
    from singa_tpu.train.optim import make_optimizer as jmake
    from singa_tpu_torch.config import OptimizerConfig
    from singa_tpu_torch.train.optim import clip_by_global_norm_, clips, global_norm, make_optimizer

    kw = dict(lr=1e-3, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    rng = np.random.default_rng(89)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(3)]

    jopt = jmake(JOC(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    for g in grads:
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)

    cfg = OptimizerConfig(**kw)
    params = [torch.nn.Parameter(t(p0[k])) for k in sorted(p0)]
    opt = make_optimizer(params, cfg)
    for g in grads:
        for p, k in zip(params, sorted(p0)):
            p.grad = t(g[k])
        if clips(cfg):
            clip_by_global_norm_(params, cfg.max_grad_norm, global_norm(params))
        opt.step()
    for p, k in zip(params, sorted(p0)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-7, rtol=1e-6)
    assert opt.defaults["betas"] == (0.99, 0.999)


def test_learning_rate_get_set():
    from singa_tpu_torch.config import OptimizerConfig
    from singa_tpu_torch.train.optim import get_learning_rate, make_optimizer, set_learning_rate

    opt = make_optimizer([torch.nn.Parameter(torch.zeros(3))], OptimizerConfig(lr=1e-4))
    assert np.isclose(get_learning_rate(opt), 1e-4)
    set_learning_rate(opt, 5e-5)
    assert np.isclose(get_learning_rate(opt), 5e-5)


def test_plateau_and_early_stopping_follow_jax():
    """On one fixed metric sequence, the port's PlateauState (with warm-up)
    and EarlyStopping give JAX's learning rates and stop decisions, step by
    step, and survive a round trip through their saved form."""
    from singa_tpu.config import SchedulerConfig as JSC
    from singa_tpu.train import optim as jo
    from singa_tpu_torch.config import SchedulerConfig
    from singa_tpu_torch.train import optim as to

    kw = dict(factor=0.5, patience=2, min_lr=1e-5, warmup_iters=3)
    metrics = [1.0, 0.9, 0.9, 0.9, 0.9, 0.85, 0.85, 0.86, 0.87, 0.9, 0.9, 0.9, 0.9, 0.9]
    js, ts = jo.PlateauState.create(JSC(**kw), 1e-3), to.PlateauState.create(SchedulerConfig(**kw), 1e-3)
    je, te = jo.EarlyStopping(patience=4, delta=0.01), to.EarlyStopping(patience=4, delta=0.01)
    for step, m in enumerate(metrics, start=1):
        assert ts.warmup_lr(step) == js.warmup_lr(step)
        js, ts = js.step_metric(m), ts.step_metric(m)
        assert ts.to_dict() == js.to_dict()
        assert te.update(m) == je.update(m)
        assert te.to_dict() == je.to_dict()
        ts = to.PlateauState.from_dict(ts.cfg, ts.to_dict())
        te = to.EarlyStopping.from_dict(te.to_dict())
    assert te.should_stop and ts.lr < 1e-3


# ---------------------------------------------------------------- data


def test_synthetic_batch_matches_jax():
    from singa_tpu.data.batch import synthetic_batch as jsyn
    from singa_tpu_torch.data.batch import synthetic_batch as tsyn

    shapes = tiny_jax_config().shapes
    want = jsyn(7, 3, shapes, TGT_LEN)
    got = tsyn(7, 3, port_config(tiny_jax_config()).shapes, TGT_LEN)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=jax.tree_util.keystr(path))


def _batches_equal(tb, jb):
    for g, w in zip(jax.tree_util.tree_leaves(tb), jax.tree_util.tree_leaves(jb)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["NpzDataset", "BucketedNpzDataset"])
def test_datasets_give_jax_order(kind, tmp_path):
    """For the same seed, the same batches in the same order as the JAX
    package over two epochs of the val split, and for a directory smaller
    than one batch (upsampled with replacement)."""
    import shutil

    from singa_tpu.data import dataset as jd
    from singa_tpu_torch.data import dataset as td

    val = os.path.join(REPO, "data", "corpus", "val")
    small = tmp_path / "small"
    small.mkdir()
    for f in sorted(os.listdir(val))[:3]:
        shutil.copy(os.path.join(val, f), small / f)
    for root, bs in ((val, 16), (str(small), 4)):
        jds, tds = getattr(jd, kind)(root, bs, seed=3), getattr(td, kind)(root, bs, seed=3)
        assert len(tds) == len(jds)
        for _ in range(2):
            jbatches, tbatches = list(jds.epoch()), list(tds.epoch())
            assert len(tbatches) == len(jbatches) >= 1
            for a, b in zip(tbatches, jbatches):
                _batches_equal(a, b)


def test_prefetcher_hands_over_every_batch_and_errors():
    from singa_tpu_torch.data.batch import synthetic_batch
    from singa_tpu_torch.data.pipeline import Prefetcher

    shapes = port_config(tiny_jax_config()).shapes
    batches = [synthetic_batch(i, 2, shapes, TGT_LEN) for i in range(4)]
    got = list(Prefetcher(iter(batches), depth=2, device="cpu"))
    assert len(got) == 4
    for a, b in zip(got, batches):
        assert torch.equal(a.protein.pos, b.protein.pos)

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError):
        list(Prefetcher(broken(), device="cpu"))


# ---------------------------------------------------------------- trainer


def test_trainer_refuses_other_precisions(tmp_path, monkeypatch):
    """bfloat16 is the precision of Config()'s path (gate FFN, neighbour-list
    attention, separable S2), of that path with the encoder attention's
    hybrid or dense form (SINGA_TPU_HYBRID_ATTN: K7/K7b;
    SINGA_TPU_DENSE_ATTN: K8/K8b), with the fused SO(2) attention at the
    width it runs (SINGA_TPU_FUSED_SO2, 128 hidden channels: K6/K6b) and of
    the s2 FFN at the widths K4's and K4b's bfloat16 instances take (lmax
    1..6, 4..16 sphere channels): Trainer takes it there. It refuses it,
    naming ROADMAP, wherever a kernel without a bfloat16 instance would run:
    the s2 FFN at a width those instances do not take (K4/K4b at 20 sphere
    channels); float16 everywhere. The CLI's training_config keeps bfloat16
    where Trainer takes it and coerces to float32, saying why, only on the
    refused ones."""
    from singa_tpu_torch.train.loop import Trainer, training_config

    _, cfg = _tiny()
    bf16 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    emb = lambda c, **kw: dataclasses.replace(c, embedding=dataclasses.replace(c.embedding, **kw))
    s2 = emb(bf16, ffn_activation="s2")
    for i, c in enumerate((bf16, s2)):
        Trainer(c, logdir=str(tmp_path / f"takes{i}"), device="cpu")
        assert training_config(c) == (c, "train.compute_dtype=bfloat16")
    for var in ("SINGA_TPU_HYBRID_ATTN", "SINGA_TPU_DENSE_ATTN"):
        with monkeypatch.context() as m:
            m.setenv(var, "1")
            for i, c in enumerate((bf16, s2)):
                assert Trainer(c, logdir=str(tmp_path / f"{var}{i}"), device="cpu").config is c
                assert training_config(c) == (c, "train.compute_dtype=bfloat16")
    with monkeypatch.context() as m:
        m.setenv("SINGA_TPU_FUSED_SO2", "1")
        so2 = emb(bf16, attn_hidden_channels=128)  # the width K6 runs at
        assert Trainer(so2, logdir=str(tmp_path / "so2"), device="cpu").config is so2
        assert training_config(so2) == (so2, "train.compute_dtype=bfloat16")
    wide = dataclasses.replace(emb(s2, sphere_channels=20), model=dataclasses.replace(
        s2.model, featurizer_feat_dim=20 * (s2.embedding.lmax + 1) ** 2))
    cases = [
        (wide, None, "K4/K4b at lmax 2, 20 sphere channels (ffn_activation: s2"),
    ]
    for i, (c, var, kernels) in enumerate(cases):
        with monkeypatch.context() as m:
            if var:
                m.setenv(var, "1")
            with pytest.raises(ValueError, match="float32 only") as refused:
                Trainer(c, logdir=str(tmp_path / f"r{i}"), device="cpu")
            assert kernels in str(refused.value)
            assert "ROADMAP, Queue 1 item 2" in str(refused.value)
            f32, line = training_config(c)
            assert f32.train.compute_dtype == "float32" and f32.embedding == c.embedding
            assert line.startswith("train.compute_dtype=float32") and kernels in line
            assert "ROADMAP, Queue 1 item 2" in line
            Trainer(f32, logdir=str(tmp_path / f"f{i}"), device="cpu")
    for i, c in enumerate((bf16, s2)):
        f16 = dataclasses.replace(c, train=dataclasses.replace(c.train, compute_dtype="float16"))
        with pytest.raises(ValueError, match="'float16'"):
            Trainer(f16, logdir=str(tmp_path / f"h{i}"), device="cpu")


def test_trainer_fit_writes_metrics_and_a_checkpoint_that_restores(tmp_path):
    """Trainer.fit for 3 steps on the CPU writes metrics.jsonl (loss, grad
    norm, lr, graphs/s per step, the validation loss), config.yml,
    provenance.json and a checkpoint; a fresh Trainer restores the same
    parameters, optimizer state, step and aux, and steps on."""
    from singa_tpu_torch.data.dataset import SyntheticDataset
    from singa_tpu_torch.train.loop import Trainer

    _, cfg = _tiny()
    logdir = str(tmp_path / "run")
    data = SyntheticDataset(4, cfg.shapes, TGT_LEN, seed=0, num_distinct=2)
    tr = Trainer(cfg, logdir=logdir, device="cpu")
    loss = tr.fit(data, data, max_iters=3, log_every=1)
    assert np.isfinite(loss)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["train/grad"]) and r["train/lr"] == 1e-4 for r in train)
    assert any("val/loss" in r for r in recs)
    for name in ("config.yml", "provenance.json"):
        assert os.path.exists(os.path.join(logdir, name))
    assert tr.ckpt.latest_step() == 3

    tr2 = Trainer(cfg, logdir=logdir, device="cpu")
    assert tr2.init_state() == 3
    for (n, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), n
    s1, s2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for k in s1["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1["state"][k][name], s2["state"][k][name])
    assert tr2.sched.to_dict() == tr.sched.to_dict()
    assert tr2.stopper.to_dict() == tr.stopper.to_dict()
    assert np.isfinite(tr2.fit(data, max_iters=4))
    assert tr2.ckpt.latest_step() == 4


def test_fit_first_step_trains_on_the_first_batch(tmp_path):
    """A deliberate difference from the JAX training CLI, which spends the
    dataset's first batch on ``init_state`` (singa_tpu/train/loop.py:346):
    the port's Trainer needs no example batch, so ``fit``'s step k trains
    on the dataset's k-th batch, from the first on."""
    from singa_tpu_torch.data.batch import synthetic_batch
    from singa_tpu_torch.train.loop import Trainer

    _, cfg = _tiny()
    batches = [synthetic_batch(i, 4, cfg.shapes, TGT_LEN) for i in range(3)]
    tr = Trainer(cfg, logdir=str(tmp_path / "run"), device="cpu")
    seen = []
    step = tr.train_step
    tr.train_step = lambda b: (seen.append(b), step(b))[1]
    tr.fit(iter(batches), max_iters=2)
    assert len(seen) == 2
    for got, want in zip(seen, batches):
        assert torch.equal(got.protein.pos, want.protein.pos)
        assert torch.equal(got.tokens.target, want.tokens.target)
    assert not torch.equal(batches[0].protein.pos, batches[1].protein.pos)


def test_two_training_steps_follow_jax(tmp_path):
    """JAX's Trainer and the port's, from the same weights, on the same two
    synthetic batches (2 microbatches each): the losses of both steps agree,
    so the first Adam update moved the port where it moved JAX. rtol 1e-4:
    the second loss carries the first update's float32 round-off."""
    from singa_tpu.data.dataset import SyntheticDataset as JSyn
    from singa_tpu.train.loop import Trainer as JTrainer
    from singa_tpu_torch.data.dataset import SyntheticDataset
    from singa_tpu_torch.params import load_flax_params
    from singa_tpu_torch.train.loop import Trainer

    jcfg, cfg = _tiny()
    jdata = list(JSyn(4, jcfg.shapes, TGT_LEN, seed=0, num_distinct=2).epoch())
    tdata = list(SyntheticDataset(4, cfg.shapes, TGT_LEN, seed=0, num_distinct=2).epoch())
    jtr = JTrainer(jcfg, logdir=str(tmp_path / "jax"), use_mesh=False)
    jtr.init_state(jdata[0], seed=7)
    ttr = Trainer(cfg, logdir=str(tmp_path / "port"), device="cpu")
    load_flax_params(ttr.model, jax.tree_util.tree_map(np.asarray, jtr.params))
    for jb, tb in zip(jdata, tdata):
        jtr.params, jtr.opt_state, jloss, jgn = jtr._train_step(jtr.params, jtr.opt_state, jb)
        loss, gn = ttr.train_step(tb)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-3)


def test_training_cli_then_generation_from_its_checkpoint(tmp_path):
    """python -m singa_tpu_torch.train.loop --data ... --device cpu trains 2
    steps into a logdir and writes a checkpoint; the generation CLI reads
    that checkpoint directory (and the config.yml beside it) and writes its
    CSV."""
    import csv
    import shutil

    import yaml

    from singa_tpu_torch.generate.generate import main as gen_main
    from singa_tpu_torch.train.loop import main as train_main

    _, cfg = _tiny(batch_size=2, microbatch=1)
    data = tmp_path / "corpus" / "train"
    data.mkdir(parents=True)
    val = os.path.join(REPO, "data", "corpus", "val")
    files = sorted(os.listdir(val))[:2]
    for f in files:
        shutil.copy(os.path.join(val, f), data / f)
    cfg_path = tmp_path / "tiny.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    logdir = tmp_path / "run"
    train_main(["--config", str(cfg_path), "--data", str(tmp_path / "corpus"), "--max-iters", "2",
                "--device", "cpu", "--logdir", str(logdir)])
    assert sorted(os.listdir(logdir / "checkpoints")) == ["2"]
    out = tmp_path / "out.csv"
    gen_main(["--checkpoint", str(logdir / "checkpoints"), "--input", str(data / files[0]),
              "--output", str(out), "--device", "cpu"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["smiles", "score"] and len(rows) == 1 + cfg.generate.topk
