"""The s2-activation FFN slice of the port against the JAX package: K4
(``so3_ffn``) and K5 (``s2_silu``), reached through their autograd Functions
on CPU tensors (where each takes its plain version), against the Pallas
kernels in interpret mode, forward and backward; ``s2_activation`` and
``FeedForwardNetwork(activation="s2")`` against the flax modules with bridged
weights; the training CLI on a config file that leaves ``compute_dtype`` at
its bf16 default, and generation from its checkpoint. (The whole-model loss
and gradients under ``ffn_activation: s2`` are in
``tests/test_torch_train_step.py``, parametrised over both activations.)

Inputs are numpy-seeded and float32, with non-zero ``b1``, ``b2`` and ``bg``:
seeded weights start with ``b1 = b2 = 0``, which would hide that ``b1``
reaches every output row through the grid. Tolerances are those of the JAX
package's own kernel tests (tests/test_equivariant_layers.py): forward
atol 3e-5 (1e-5 for the activation alone): reordered float32 sums over the
G-point grid; gradients atol 5e-4 (2e-4 for the activation), rtol 1e-4:
the kernels' backwards recompute the grid while autograd of the plain
version differentiates the saved one, and weight gradients sum that
round-off over every node.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import REPO, close, port_config, t, tiny_jax_config

NAMES = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]


def _ffn_arrays(rng, N, lmax, C, H, Co):
    L = lmax + 1
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return [f(N, L * L, C), 0.2 * f(L, C, H), 0.1 * f(H), 0.2 * f(C, H), 0.1 * f(H),
            0.1 * f(L, H, Co), 0.1 * f(Co)]


@pytest.mark.parametrize("lmax,N,C,H", [(3, 40, 4, 256), (2, 7, 4, 40)])
def test_so3_ffn_matches_pallas(lmax, N, C, H):
    """K4's plain forward and K4b's plain backward (dx and all six weight
    and bias gradients) == the Pallas so3_ffn_fused and its _bwd in
    interpret mode; lmax 3 at the JAX test's shapes, lmax 2 at a ragged N
    and a hidden width that is no multiple of the kernel's chunk."""
    from singa_tpu.equivariant import layers as jl
    from singa_tpu.ops.pallas.so3_ffn import pad_grid_mat, so3_ffn_fused
    from singa_tpu_torch.equivariant import layers as tl
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    Co = 4
    I = (lmax + 1) ** 2
    rng = np.random.default_rng(101 + lmax)
    arrays = _ffn_arrays(rng, N, lmax, C, H, Co)
    g = rng.normal(size=(N, I, Co)).astype(np.float32)
    jtg, jfg = jl._grid_mats_for(lmax, lmax, False)
    tgp = jnp.asarray(pad_grid_mat(jtg.reshape(-1, I), lmax))
    fgp = jnp.asarray(pad_grid_mat(jfg.reshape(-1, I), lmax))
    with compute_dtype_scope("float32"):
        want, vjp = jax.vjp(lambda *a: so3_ffn_fused(*a, tgp, fgp, lmax, True),
                            *map(jnp.asarray, arrays))
        want_grads = vjp(jnp.asarray(g))

    tg, fg = tl._grid_mats_for(lmax, lmax, False)
    ts = [t(a).requires_grad_() for a in arrays]
    n = k4.launches_s2
    got = k4.so3_ffn(*ts, t(tg), t(fg), lmax)
    assert k4.launches_s2 == n  # CPU tensors: the plain version, no launch
    close(got, want, 3e-5, 1e-5, "y")
    got.backward(t(g))
    for name, a, b in zip(NAMES, ts, want_grads):
        close(a.grad, b, 5e-4, 1e-4, name)
    # b1 reaches every output row through the grid, not row 0 alone
    assert float(ts[2].grad.abs().max()) > 0
    y1 = k4.so3_ffn_plain(*[t(a) for a in arrays[:2]], t(arrays[2]) + 1.0,
                          *[t(a) for a in arrays[3:]], t(tg), t(fg), lmax)
    assert float((y1 - got.detach())[:, 1:].abs().max()) > 1e-3


@pytest.mark.parametrize("lmax,mmax,m_primary,N,C", [(6, 6, False, 8, 24), (6, 2, True, 11, 16)])
def test_s2_silu_matches_pallas(lmax, mmax, m_primary, N, C):
    """K5's plain forward and K5b's plain backward == the Pallas s2_silu and
    its _bwd in interpret mode: the s2 FFN's full grid (I 49, G 210, as the
    JAX test) and the attention message's m-primary grid (I 29, G 70)."""
    from singa_tpu.equivariant import layers as jl
    from singa_tpu.ops.pallas.s2_act import s2_silu as pallas_s2
    from singa_tpu_torch.equivariant import layers as tl
    from singa_tpu_torch.ops.cuda import s2_act as k5

    tg, fg = tl._grid_mats_for(lmax, mmax, m_primary)
    jtg, jfg = jl._grid_mats_for(lmax, mmax, m_primary)
    rng = np.random.default_rng(103 + C)
    x = rng.normal(size=(N, tg.shape[1], C)).astype(np.float32)
    g = rng.normal(size=(N, tg.shape[1], C)).astype(np.float32)
    with compute_dtype_scope("float32"):
        want, vjp = jax.vjp(lambda a: pallas_s2(a, jtg, jfg), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(g))
    xt = t(x).requires_grad_()
    n = k5.launches_silu
    got = k5.s2_silu(xt, t(tg), t(fg))
    assert k5.launches_silu == n
    close(got, want, 1e-5, 1e-5, "out")
    got.backward(t(g))
    close(xt.grad, want_dx, 2e-4, 1e-4, "dx")
    close(k5.s2_silu_bwd_plain(t(x), t(tg), t(fg), t(g)), want_dx, 2e-4, 1e-4, "dx plain")


def test_s2_activation_matches_jax():
    """layers.s2_activation (K5 through its wrapper) == the JAX package's
    s2_activation (its XLA path on the CPU), l-primary and m-primary."""
    from singa_tpu.equivariant import layers as jl
    from singa_tpu_torch.equivariant import layers as tl

    rng = np.random.default_rng(107)
    for lmax, mmax, m_primary, I in ((2, 2, False, 9), (6, 2, True, 29)):
        x = rng.normal(size=(6, I, 5)).astype(np.float32)
        with compute_dtype_scope("float32"):
            want = jl.s2_activation(jnp.asarray(x), lmax, mmax, m_primary)
        close(tl.s2_activation(t(x), lmax, mmax, m_primary), want, 1e-5, 1e-5)


@pytest.mark.parametrize("lmax", [2, 6])
def test_ffn_s2_module_matches_flax(lmax):
    """FeedForwardNetwork(activation='s2') with the flax module's weights
    (biases made non-zero), bridged by params.load_flax_params: the output
    and the gradients of x and of every parameter."""
    from singa_tpu.equivariant.attention import FeedForwardNetwork as JFFN
    from singa_tpu_torch.equivariant.attention import FeedForwardNetwork
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    C, H, Co, N = 8, 32, 8, 9
    I = (lmax + 1) ** 2
    rng = np.random.default_rng(109 + lmax)
    x = rng.normal(size=(N, I, C)).astype(np.float32)
    g = rng.normal(size=(N, I, Co)).astype(np.float32)
    mod = JFFN(hidden_channels=H, output_channels=Co, lmax=lmax, activation="s2")
    with compute_dtype_scope("float32"):
        params = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(3), jnp.asarray(x)))
        p = dict(params["params"])
        for name in ("b1", "b2"):
            assert not p[name].any()  # seeded at zero: set them
            p[name] = (0.1 * rng.normal(size=p[name].shape)).astype(np.float32)
        params = {"params": p}
        want, vjp = jax.vjp(lambda pp, a: mod.apply(pp, a), params, jnp.asarray(x))
        jgrads, jdx = vjp(jnp.asarray(g))

    ffn = FeedForwardNetwork(C, H, Co, lmax, activation="s2", device="cpu")
    load_flax_params(ffn, params)
    xt = t(x).requires_grad_()
    got = ffn(xt)
    close(got, want, 3e-5, 1e-5, "y")
    got.backward(t(g))
    close(xt.grad, jdx, 5e-4, 1e-4, "dx")
    want_grads = from_flax_grads(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want_grads) == {n for n, _ in ffn.named_parameters()}
    for name, prm in ffn.named_parameters():
        close(prm.grad, want_grads[name], 5e-4, 1e-4, name)


def test_ffn_refuses_the_activations_not_ported():
    from singa_tpu_torch.equivariant.attention import FeedForwardNetwork

    with pytest.raises(ValueError, match="ported: gate, s2"):
        FeedForwardNetwork(8, 16, 8, 2, activation="grid", device="cpu")


def _s2_cli_run(tmp_path, sphere_channels: int, argv_extra=()):
    """The training CLI for 1 step on the CPU on a tiny s2 config file with
    no train.compute_dtype (so the bf16 default) and ``sphere_channels``,
    on two val complexes; then the generation CLI from its checkpoint.
    Returns (config path, what the CLI printed, the saved config)."""
    import csv
    import shutil

    import yaml

    from singa_tpu_torch.config import load_config
    from singa_tpu_torch.generate.generate import main as gen_main
    from singa_tpu_torch.train.loop import main as train_main

    jcfg = tiny_jax_config(ffn_activation="s2")
    raw = json.loads(json.dumps(dataclasses.asdict(jcfg)))
    del raw["train"]["compute_dtype"]
    raw["train"].update(batch_size=2, microbatch=None)
    raw["embedding"]["sphere_channels"] = sphere_channels
    raw["model"]["featurizer_feat_dim"] = sphere_channels * (jcfg.embedding.lmax + 1) ** 2
    cfg_path = tmp_path / f"tiny_s2_{sphere_channels}.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    assert load_config(str(cfg_path)).train.compute_dtype == "bfloat16"

    data = tmp_path / "corpus" / "train"
    data.mkdir(parents=True, exist_ok=True)
    val = os.path.join(REPO, "data", "corpus", "val")
    files = sorted(os.listdir(val))[:2]
    for name in files:
        shutil.copy(os.path.join(val, name), data / name)
    logdir = tmp_path / f"run{sphere_channels}"
    train_main(["--config", str(cfg_path), "--data", str(tmp_path / "corpus"), "--max-iters", "1",
                "--device", "cpu", "--logdir", str(logdir)])
    assert sorted(os.listdir(logdir / "checkpoints")) == ["1"]
    saved = load_config(str(logdir / "config.yml"))
    assert saved.embedding.ffn_activation == "s2"

    out = tmp_path / "out.csv"
    gen_main(["--checkpoint", str(logdir / "checkpoints"), "--input", str(data / files[0]),
              "--output", str(out), "--device", "cpu"])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["smiles", "score"] and len(rows) == 1 + port_config(jcfg).generate.topk
    return cfg_path, saved


def test_training_cli_runs_a_bf16_config_in_float32(tmp_path, capsys):
    """A config file with ffn_activation s2 at a width K4's and K4b's
    bfloat16 instances do not take (20 sphere channels) and no
    train.compute_dtype (so the bf16 default) trains 1 step on the CPU in
    float32 and says why; the generation CLI then serves one pocket from
    that checkpoint, whose config.yml carries the s2 activation."""
    cfg_path, saved = _s2_cli_run(tmp_path, 20)
    printed = capsys.readouterr().out
    assert (f"config: {cfg_path} with train.compute_dtype=float32 (the port trains this path in "
            "float32, not in the config's bfloat16: K4/K4b at lmax 2, 20 sphere channels "
            "(ffn_activation: s2; their bfloat16 instances take lmax 1..6 and 4..16 channels, a "
            "multiple of 4) have no bfloat16 instance yet; ROADMAP, Queue 1 item 2)") in printed
    assert saved.train.compute_dtype == "float32"


def test_training_cli_trains_the_s2_config_at_bf16(tmp_path, capsys):
    """The same at 8 sphere channels, a width the bfloat16 instances take:
    the CLI keeps the config's bfloat16, says so, trains and checkpoints at
    it, and generation serves from that checkpoint."""
    cfg_path, saved = _s2_cli_run(tmp_path, 8)
    assert f"config: {cfg_path} with train.compute_dtype=bfloat16\n" in capsys.readouterr().out
    assert saved.train.compute_dtype == "bfloat16"


def test_trainer_refuses_the_corpus_config_unless_made_float32(monkeypatch, tmp_path):
    """configs/train_corpus.yml (the s2 configuration, bf16 by default, at
    lmax 6 and 16 sphere channels): Trainer takes it as it is, at bfloat16,
    and so it does under SINGA_TPU_FUSED_SO2 (K6/K6b have bfloat16
    instances); at a width K4's and K4b's bfloat16 instances do not take (20
    sphere channels) it refuses it unless made float32, and float32_config,
    which the CLI then applies, keeps everything else, the s2 activation
    and batch 32 as one microbatch included."""
    from singa_tpu_torch.config import load_config
    from singa_tpu_torch.train.loop import Trainer, float32_config, training_config

    cfg = load_config(os.path.join(REPO, "configs", "train_corpus.yml"))
    assert cfg.train.compute_dtype == "bfloat16"
    assert training_config(cfg) == (cfg, "train.compute_dtype=bfloat16")
    assert Trainer(cfg, logdir=str(tmp_path / "bf16"), device="cpu").config is cfg
    with monkeypatch.context() as m:
        m.setenv("SINGA_TPU_FUSED_SO2", "1")  # K6·bf16 / K6b·bf16
        assert training_config(cfg) == (cfg, "train.compute_dtype=bfloat16")
        assert Trainer(cfg, logdir=str(tmp_path / "so2"), device="cpu").config is cfg
    wide = dataclasses.replace(
        cfg, embedding=dataclasses.replace(cfg.embedding, sphere_channels=20),
        model=dataclasses.replace(cfg.model,
                                  featurizer_feat_dim=20 * (cfg.embedding.lmax + 1) ** 2))
    with pytest.raises(ValueError, match="float32 only"):
        Trainer(wide, logdir=str(tmp_path / "refused"), device="cpu")
    f32 = float32_config(wide)
    assert training_config(wide)[0] == f32
    assert f32.train.compute_dtype == "float32"
    assert f32.embedding == wide.embedding and f32.embedding.ffn_activation == "s2"
    assert (f32.train.batch_size, f32.train.microbatch) == (32, None)
