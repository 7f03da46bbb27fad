"""The port's generation path against the JAX package: the SMILES grammar
mask, beam search (tie-breaking included), the whole slice
``generate_for_pocket`` with bridged weights, and the CLI."""
from __future__ import annotations

import csv
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import (
    VAL_FILES,
    close,
    jax_batch,
    load_val,
    port_config,
    singa_params,
    t,
    torch_batch,
)


def _grammar_fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _run_grammar(streams: np.ndarray, allow_dot: bool):
    """Feed token streams [B, K, T] to both grammars step by step, comparing
    the admissible-token masks, the forced flags and the whole state."""
    from singa_tpu.generate import grammar as jg
    from singa_tpu_torch.generate import grammar as tg

    shape = streams.shape[:2]
    js, ts = jg.init_state(shape), tg.init_state(shape)
    for step in range(streams.shape[2]):
        jok, jforced = jg.allowed_tokens(js, allow_dot=allow_dot, return_forced=True)
        tok_, tforced = tg.allowed_tokens(ts, allow_dot=allow_dot, return_forced=True)
        np.testing.assert_array_equal(tok_.numpy(), np.asarray(jok), err_msg=f"step {step}")
        np.testing.assert_array_equal(tforced.numpy(), np.asarray(jforced))
        tok = streams[:, :, step]
        js, ts = jg.update(js, jnp.asarray(tok)), tg.update(ts, t(tok))
        want = _grammar_fields(js)
        for name, got in _grammar_fields(ts).items():
            np.testing.assert_array_equal(got, want[name], err_msg=f"{name} step {step}")


@pytest.mark.parametrize("allow_dot", [False, True])
def test_grammar_matches_jax_on_random_streams(allow_dot):
    """Random streams, half drawn from the port's own admissible set (deep
    valid states) and half uniform over the vocabulary (odd states)."""
    from singa_tpu_torch.generate import grammar as tg

    rng = np.random.default_rng(0 if allow_dot else 1)
    B, K, T, V = 3, 6, 40, 116
    streams = rng.integers(0, V, size=(B, K, T)).astype(np.int32)
    state = tg.init_state((B, K))
    for step in range(T):
        ok = tg.allowed_tokens(state, allow_dot=allow_dot).numpy()
        for b in range(B):
            for k in range(K // 2):
                streams[b, k, step] = rng.choice(np.flatnonzero(ok[b, k]))
        state = tg.update(state, t(streams[:, :, step]))
    _run_grammar(streams, allow_dot)


def test_grammar_matches_jax_on_corpus_smiles():
    """The token sequences of corpus SMILES (after the SOS token)."""
    seqs = [f["tokens.input"][1:41] for f in load_val(24)]
    streams = np.stack(seqs).reshape(4, 6, 40).astype(np.int32)
    _run_grammar(streams, allow_dot=True)


def _decode_table(V=12, T=10):
    """A synthetic next-token model whose logits depend on the last two
    tokens, quantised to multiples of 0.5 so that scores tie often."""
    rng = np.random.default_rng(3)
    return (np.round(rng.normal(size=(V, V, V)) * 2) / 2).astype(np.float32), T


@pytest.mark.parametrize("length_penalty", [0.7, 1.0])
def test_beam_search_matches_jax_with_ties(length_penalty):
    from singa_tpu.generate.beam import beam_search as jbeam
    from singa_tpu_torch.generate.beam import beam_search as tbeam

    table, T = _decode_table()
    B, K = 3, 4
    # the synthetic vocabulary's tokens 1 and 2 play EOS and PAD, 0 SOS
    kw = dict(batch_size=B, num_beams=K, max_length=T, length_penalty=length_penalty,
              sos_token=0, eos_token=1, pad_token=2, topk=K)

    def jdecode(tokens, cur_len, cache):
        last = jax.lax.dynamic_index_in_dim(tokens, cur_len - 1, axis=1, keepdims=False)
        prev = jax.lax.dynamic_index_in_dim(tokens, jnp.maximum(cur_len - 2, 0), axis=1,
                                            keepdims=False)
        return jnp.asarray(table)[prev, last], cache

    def tdecode(tokens, cur_len, keep_rows):
        tokens = tokens.long()
        return t(table)[tokens[:, max(cur_len - 2, 0)], tokens[:, cur_len - 1]]

    jt, js = jax.jit(lambda: jbeam(jdecode, **kw))()
    tt, ts = tbeam(tdecode, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    close(ts, js, 1e-6, 1e-6)


@functools.lru_cache(maxsize=None)
def _slice_setup():
    jcfg, params = singa_params(2, 2)
    return jcfg, port_config(jcfg), params


def test_generate_for_pocket_matches_jax():
    """The whole slice at the tiny config with bridged weights, 4 beams,
    max_length 24, grammar mask on: the same beam tokens as the JAX package
    and scores within rtol 1e-5."""
    from singa_tpu.generate.beam import beam_generate as jbeam_generate
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu_torch.chem.tokenizer import decode
    from singa_tpu_torch.generate.beam import beam_generate
    from singa_tpu_torch.generate.generate import generate_for_pocket
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import load_flax_params

    jcfg, cfg, params = _slice_setup()
    g = cfg.generate
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)
    jm = JSINGA(jcfg)
    with compute_dtype_scope("float32"):
        enc, pad = jax.jit(lambda p, b: jm.apply(p, b, method="encode_pocket"))(params, jb)
        prop = jnp.asarray([g.prop] * 2, jnp.float32)
        jtok, jsc = jax.jit(functools.partial(
            jbeam_generate, jm, num_beams=g.num_beams, max_length=g.max_length,
            length_penalty=g.length_penalty, topk=g.topk, grammar_mask=g.grammar_mask,
            allow_dot=g.allow_dot,
        ))(params, enc, pad, prop)

    model = SINGA(cfg, device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        tenc, tpad = model.encode_pocket(tb)
        close(tenc, enc, 1e-4, 1e-4, "encode_pocket")
        ttok, tsc = beam_generate(
            model, tenc, tpad, t(np.asarray(prop)), num_beams=g.num_beams,
            max_length=g.max_length, length_penalty=g.length_penalty, topk=g.topk,
            grammar_mask=g.grammar_mask, allow_dot=g.allow_dot,
        )
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    close(tsc, jsc, 0, 1e-5, "scores")

    smiles, scores = generate_for_pocket(model, tb, cfg)
    jt = np.asarray(jtok)
    assert smiles == [decode(jt[b, k]) for b in range(jt.shape[0]) for k in range(jt.shape[1])]
    close(scores, np.asarray(jsc).reshape(-1), 0, 1e-5, "generate_for_pocket scores")


def test_cli_writes_csv(tmp_path):
    """main([... '--device', 'cpu']) on one val pocket writes one row per
    returned hypothesis; weights come from a .pt state dict and the config
    from the config.yml beside it."""
    from singa_tpu_torch.config import save_config
    from singa_tpu_torch.generate.generate import main
    from singa_tpu_torch.models.singa import SINGA

    _, cfg, _ = _slice_setup()
    cfg = dataclasses.replace(cfg, generate=dataclasses.replace(cfg.generate, topk=2))
    save_config(cfg, str(tmp_path / "config.yml"))
    torch.save(SINGA(cfg, device="cpu", seed=3).state_dict(), tmp_path / "w.pt")
    out = tmp_path / "out.csv"
    main(["--checkpoint", str(tmp_path / "w.pt"), "--input", VAL_FILES[5],
          "--output", str(out), "--device", "cpu", "--prop", "from-input"])
    rows = list(csv.reader(open(out)))
    assert rows[0] == ["smiles", "score"] and len(rows) == 3
    assert all(np.isfinite(float(r[1])) for r in rows[1:])
    # a non-.npz input is a PDB now: a missing one is a missing file
    with pytest.raises(FileNotFoundError):
        main(["--checkpoint", str(tmp_path / "w.pt"), "--input", str(tmp_path / "pocket.pdb"),
              "--device", "cpu"])


def test_generate_for_pocket_from_pdb_matches_jax():
    """PDB block (a) of tests/test_torch_complex_builder.py (the first val
    complex's protein nodes with its ligand SDF) through both builders at
    the serving buckets and both generate_for_pocket at the tiny config with
    bridged weights: the same beam tokens, scores within rtol 1e-5."""
    from singa_tpu.data.complex_builder import build_from_files as jbuild
    from singa_tpu.generate.generate import generate_for_pocket as jgenerate
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu_torch.data.complex_builder import build_from_files
    from singa_tpu_torch.generate.generate import generate_for_pocket
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import load_flax_params
    from test_torch_complex_builder import block_a

    jcfg, cfg, params = _slice_setup()
    pdb, sdf = block_a()
    tgt = cfg.model.decoder.tgt_len
    jb, tb = jbuild(pdb, sdf, tgt_len=tgt), build_from_files(pdb, sdf, tgt_len=tgt)
    with compute_dtype_scope("float32"):
        jsmiles, jscores = jgenerate(JSINGA(jcfg), params, jb, jcfg)
    model = SINGA(cfg, device="cpu")
    load_flax_params(model, params)
    smiles, scores = generate_for_pocket(model, tb, cfg)
    assert smiles == jsmiles
    close(scores, jscores, 0, 1e-5, "scores")


def test_cli_pdb_input_with_props(tmp_path, monkeypatch):
    """main([... '--input', pdb, '--ligand', sdf, '--props', '--device',
    'cpu']) writes the seven columns; its validity, QED, SA, logP and TPSA
    are the JAX functions' values on the same SMILES. Random tiny weights
    rarely write a valid molecule, so a second run swaps the generated
    SMILES for known ones (corpus drugs and broken strings) on their way to
    the CSV."""
    import singa_tpu_torch.generate.generate as tgen
    from singa_tpu.chem.drug_corpus import CORPUS
    from singa_tpu.chem.properties import logp, qed, sa_score, tpsa
    from singa_tpu.chem.smiles_parser import is_valid_smiles, parse_smiles
    from singa_tpu_torch.config import ShapeConfig, save_config
    from singa_tpu_torch.models.singa import SINGA
    from test_torch_complex_builder import block_a

    _, cfg, _ = _slice_setup()
    # the tiny widths at the serving buckets (block (a) is a 160-atom pocket)
    cfg = dataclasses.replace(cfg, shapes=ShapeConfig(),
                              generate=dataclasses.replace(cfg.generate, topk=4))
    save_config(cfg, str(tmp_path / "config.yml"))
    torch.save(SINGA(cfg, device="cpu", seed=3).state_dict(), tmp_path / "w.pt")
    pdb, sdf = block_a()
    (tmp_path / "pocket.pdb").write_text(pdb)
    out = tmp_path / "out.csv"
    args = ["--checkpoint", str(tmp_path / "w.pt"), "--input", str(tmp_path / "pocket.pdb"),
            "--ligand", sdf, "--output", str(out), "--props", "--device", "cpu"]

    def check() -> int:
        rows = list(csv.reader(open(out)))
        assert rows[0] == ["smiles", "score", "valid", "qed", "sa", "logp", "tpsa"]
        assert len(rows) == 1 + 4
        n_valid = 0
        for smi, score, valid, *props in rows[1:]:
            assert np.isfinite(float(score))
            assert valid == str(int(is_valid_smiles(smi))), smi
            if valid == "1":
                n_valid += 1
                mol = parse_smiles(smi)
                want = [qed(mol), sa_score(mol), logp(mol), tpsa(mol)]
                np.testing.assert_allclose([float(x) for x in props], want, rtol=0, atol=1e-6)
            else:
                assert props == ["", "", "", ""]
        return n_valid

    tgen.main(args)
    check()
    known = [CORPUS[0][1], "c1cccc1", CORPUS[40][1], CORPUS[100][1]]
    real = tgen.generate_for_pocket

    def swapped(*a, **kw):
        smiles, scores = real(*a, **kw)
        return known[: len(smiles)], scores

    monkeypatch.setattr(tgen, "generate_for_pocket", swapped)
    tgen.main(args)
    assert check() == 3


def test_port_imports_no_networkx():
    """Every module of the port, imported in a fresh interpreter, pulls in
    no networkx (the card's machine has none)."""
    import os
    import subprocess
    import sys

    from test_torch_common import REPO

    code = r"""
import importlib, pkgutil, sys
import singa_tpu_torch
for m in pkgutil.walk_packages(singa_tpu_torch.__path__, "singa_tpu_torch."):
    importlib.import_module(m.name)
from singa_tpu_torch.chem.smiles_parser import parse_smiles
from singa_tpu_torch.chem.properties import all_properties
all_properties(parse_smiles("c1ccc2[nH]ccc2c1"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("networkx", "jax", "flax", "singa_tpu"))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
