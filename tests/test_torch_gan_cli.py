"""The port's GAN on its own (CPU, tiny config, float32): the sampler's
recorded log-probs equal its teacher-forced ``sequence_logp`` (as
tests/test_gan_loop.py holds JAX's), the d_acc_cap pauses, the CLI on
synthetic batches (metrics, config and a checkpoint that the generation CLI
and ``--init-ckpt`` read back), the docking pass-rate (``--vina-eval``, held
to JAX's ``vina_conditioning_host``), and the refusals: a card asked for
where there is none, a bfloat16 config.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from test_torch_common import VAL_FILES, gan_jax_config, load_val, port_config, tiny_jax_config

TGT_LEN = 24  # tests/test_model.py


@pytest.fixture(scope="module")
def gan():
    """A seeded tiny generator on two val complexes, and a trainer bound to it."""
    from singa_tpu_torch.data.batch import stack
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.train.gan import GANTrainer

    cfg = port_config(gan_jax_config(2, 2))
    model = SINGA(cfg, device="cpu", seed=0)
    tr = GANTrainer(cfg, graph_loss="wgan-gp", grammar_mask=True)
    tr.init(model, seed=1)
    return cfg, stack(load_val(2)), tr


@pytest.mark.parametrize("grammar_mask", [False, True], ids=["mask_off", "mask_on"])
def test_sampler_logp_equals_sequence_logp(gan, grammar_mask):
    """Over six seeds: tokens start with SOS and are PAD after EOS, whose
    log-probs are 0; the recorded log-probs sum to the teacher-forced
    ``sequence_logp`` (atol 1e-4, as the JAX package's test) on every row
    that sampled no PAD before its EOS. Such a row (possible only without
    the grammar mask, which never admits PAD) differs, in the JAX package as
    in the port: the sampler's cache attends to the PAD key, the
    teacher-forced decode blocks it. Under the mask every sampled token was
    admissible and the masked log-probs are at least the unmasked ones."""
    from singa_tpu_torch.config import EOS_TOKEN, PAD_TOKEN, SOS_TOKEN
    from singa_tpu_torch.train.gan import grammar_replay, sample_sequences, sequence_logp

    cfg, batch, tr = gan
    with torch.no_grad():
        enc, pad, prop = tr._encode(batch)
    held = 0
    for seed in range(6):
        with torch.no_grad():
            gen = torch.Generator().manual_seed(seed)
            tokens, logp = sample_sequences(tr.generator, enc, pad, prop, gen, TGT_LEN,
                                            grammar_mask=grammar_mask)
            got = sequence_logp(tr.generator, tokens, enc, pad, prop, grammar_mask=grammar_mask)
        assert tokens.shape == (2, TGT_LEN) and (tokens[:, 0] == SOS_TOKEN).all()
        assert (logp <= 0).all() and (logp[:, 0] == 0).all()
        nxt = tokens[:, 1:]
        is_eos = (nxt == EOS_TOKEN).long()
        live = torch.cumsum(is_eos, 1) - is_eos == 0
        assert (nxt[~live] == PAD_TOKEN).all() and (logp[:, 1:][~live] == 0).all()
        pad_first = ((nxt == PAD_TOKEN) & live).any(dim=1)
        assert not (grammar_mask and pad_first.any())
        np.testing.assert_allclose(got[~pad_first].numpy(), logp.sum(1)[~pad_first].numpy(),
                                   rtol=0, atol=1e-4)
        held += int((~pad_first).sum())
        if grammar_mask:
            assert grammar_replay(nxt).gather(-1, nxt[..., None])[..., 0][live].all()
            with torch.no_grad():
                unmasked = sequence_logp(tr.generator, tokens, enc, pad, prop)
            assert (got >= unmasked - 1e-5).all() and (got > unmasked).any()
    assert held >= 6


def test_d_acc_cap_pauses_and_resumes(gan):
    """A discriminator whose last accuracy exceeds the cap is evaluated, not
    updated; the rule is decided before the d loop and again after each d
    step; cap 1.0 never pauses."""
    cfg, batch, tr = gan
    calls = []
    originals = {}
    for name in ("d_step", "d_eval", "gd_step", "gd_eval"):
        originals[name] = getattr(tr, name)
        setattr(tr, name, lambda *a, _n=name, **k: (calls.append(_n), originals[_n](*a, **k))[1])
    gen = torch.Generator().manual_seed(3)
    try:
        tr._last_d_acc = tr._last_gd_acc = None
        m = tr.train_round(batch, gen, d_steps=2, d_acc_cap=-0.5)  # paused after the first step
        assert calls == ["d_step", "gd_step", "d_eval", "gd_eval"]
        assert m["gan/d_paused"] == 1.0 and m["gan/gd_paused"] == 1.0
        calls.clear()
        tr._last_d_acc = tr._last_gd_acc = 2.0  # paused before the loop, released after
        m = tr.train_round(batch, gen, d_steps=2, d_acc_cap=1.5)
        assert calls == ["d_eval", "gd_eval", "d_step", "gd_step"]
        assert m["gan/d_paused"] == 0.0
        calls.clear()
        d0 = tr.disc.head.weight.detach().clone()
        m = tr.train_round(batch, gen, d_steps=1, d_acc_cap=1.0)
        assert calls == ["d_step", "gd_step"] and not torch.equal(d0, tr.disc.head.weight)
        assert all(math.isfinite(v) for v in m.values())
        assert 0.0 <= m["gan/pct_valid"] <= 100.0
    finally:
        for name, fn in originals.items():
            setattr(tr, name, fn)


def test_gan_cli_on_synthetic_batches_round_trips(tmp_path):
    """python -m singa_tpu_torch.train.gan --synthetic --device cpu, 2
    rounds: metrics.jsonl (each round's losses, the quality samples, the
    final report), config.yml and the checkpoint of round 2; the generation
    CLI serves from it (given the logdir or its checkpoints/); --init-ckpt
    reads it back unchanged."""
    import yaml

    from singa_tpu_torch.generate.generate import main as gen_main
    from singa_tpu_torch.train.gan import main

    cfg = port_config(tiny_jax_config())
    cfg_path = tmp_path / "tiny.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    logdir = tmp_path / "gan"
    common = ["--config", str(cfg_path), "--synthetic", "--device", "cpu", "--batch-size", "2",
              "--graph-loss", "wgan-gp", "--grammar-mask"]
    main([*common, "--rounds", "2", "--pretrain", "1", "--eval-every", "1",
          "--logdir", str(logdir)])
    with open(logdir / "metrics.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["step"] for ln in lines] == [1, 2, 3]
    for ln in lines[:2]:
        for k in ("gan/d_loss", "gan/gd_loss", "gan/g_loss", "gan/reward", "quality/pct_valid"):
            assert math.isfinite(ln[k]), k
    assert "quality/pct_unique" in lines[2]
    assert sorted(os.listdir(logdir / "checkpoints")) == ["2"]
    with open(logdir / "config.yml") as f:
        assert yaml.safe_load(f)["train"]["compute_dtype"] == "float32"
    for ckpt in (logdir, logdir / "checkpoints"):
        out = tmp_path / "out.csv"
        gen_main(["--checkpoint", str(ckpt), "--input", VAL_FILES[0], "--output", str(out),
                  "--device", "cpu"])
        with open(out) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["smiles", "score"] and len(rows) == 1 + cfg.generate.topk
    again = tmp_path / "again"
    main([*common, "--rounds", "0", "--init-ckpt", str(logdir), "--logdir", str(again)])
    first = torch.load(logdir / "checkpoints" / "2" / "state.pt", weights_only=True)["model"]
    second = torch.load(again / "checkpoints" / "0" / "state.pt", weights_only=True)["model"]
    assert first.keys() == second.keys() and all(torch.equal(first[k], second[k]) for k in first)


def test_vina_conditioning_host_matches_jax():
    """The docking pass-rate of both packages on the first 8 sorted
    data/corpus/train complexes, given the batch's own ligand SMILES as
    sampled tokens: the port's from its batch, JAX's from its own. Six of
    them embed and dock (the two acyclovir rows fail to parse, a failure in
    both); the returned dicts are equal, vina_mean to rtol 1e-9."""
    import glob

    from singa_tpu.train.rewards import vina_conditioning_host as jvina
    from singa_tpu_torch.train.rewards import vina_conditioning_host
    from test_torch_common import REPO, jax_batch, sos_tokens, torch_batch
    from test_torch_vina import load_jax_vina

    load_jax_vina()
    files = []
    for p in sorted(glob.glob(os.path.join(REPO, "data", "corpus", "train", "*.npz")))[:8]:
        with np.load(p) as z:
            files.append({k: z[k] for k in z.files})
    tokens = sos_tokens(files, 200)
    got = vina_conditioning_host(torch_batch(files), torch.as_tensor(tokens), n_eval=8)
    want = jvina(jax_batch(files), tokens, n_eval=8)
    assert got.keys() == want.keys() == {"pct_vina_good", "n_vina_scored", "vina_mean"}
    assert got["n_vina_scored"] == want["n_vina_scored"] >= 4
    assert got["pct_vina_good"] == want["pct_vina_good"]
    assert math.isfinite(got["vina_mean"]) and got["vina_mean"] < 0
    np.testing.assert_allclose(got["vina_mean"], want["vina_mean"], rtol=1e-9, atol=0)


def test_gan_cli_vina_eval_writes_the_pass_rate(tmp_path, capsys):
    """--vina-eval 2 on synthetic batches: the final report, printed and in
    metrics.jsonl, carries pct_vina_good, n_vina_scored and vina_mean; a
    negative count is refused at parsing."""
    import yaml

    from singa_tpu_torch.train.gan import main

    cfg = port_config(tiny_jax_config())
    cfg_path = tmp_path / "tiny.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    logdir = tmp_path / "gan"
    main(["--config", str(cfg_path), "--synthetic", "--device", "cpu", "--batch-size", "2",
          "--rounds", "1", "--vina-eval", "2", "--logdir", str(logdir)])
    assert "n_vina_scored" in capsys.readouterr().out
    with open(logdir / "metrics.jsonl") as f:
        last = [json.loads(ln) for ln in f][-1]
    assert last["step"] == 2
    assert 0.0 <= last["quality/pct_vina_good"] <= 100.0
    n = last["quality/n_vina_scored"]
    assert n in (0, 1, 2) and (math.isnan(last["quality/vina_mean"]) == (n == 0))
    with pytest.raises(SystemExit) as e:
        main(["--synthetic", "--device", "cpu", "--vina-eval", "-1",
              "--logdir", str(tmp_path / "x")])
    assert e.value.code == 2 and not (tmp_path / "x").exists()


def test_refusals_of_a_missing_card_and_of_bfloat16(monkeypatch, tmp_path):
    from singa_tpu_torch.config import Config
    from singa_tpu_torch.train.gan import GANTrainer, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--synthetic", "--logdir", str(tmp_path / "x")])  # --device defaults to cuda
    with pytest.raises(ValueError, match="float32 only"):
        GANTrainer(Config())  # the JAX default trains in bfloat16
