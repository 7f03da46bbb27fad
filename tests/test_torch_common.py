"""PyTorch port vs the JAX package: shared helpers, constants, import hygiene.

The other ``test_torch_*`` files import the helpers below. Inputs are made
with numpy from fixed seeds or read from ``data/corpus/val``, then fed to the
JAX function and to its port counterpart; JAX runs in float32 at matmul
precision 'highest' (tests/conftest.py), the port in float32 on the CPU
(where every kernel wrapper takes its plain PyTorch version).
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL_FILES = sorted(glob.glob(os.path.join(REPO, "data", "corpus", "val", "*.npz")))


def tiny_jax_config(lmax=2, mmax=2, num_beams=4, max_length=24):
    """tests/test_model.py::tiny_config with generation knobs for the slice."""
    from test_model import tiny_config

    cfg = tiny_config(lmax, mmax)
    return dataclasses.replace(
        cfg,
        generate=dataclasses.replace(cfg.generate, num_beams=num_beams, max_length=max_length),
    )


def port_config(jcfg):
    """The port's Config with the same values as a JAX package Config."""
    from singa_tpu_torch import config as tcfg

    return tcfg._build(tcfg.Config, dataclasses.asdict(jcfg))


def load_val(n: int, start: int = 0) -> list[dict]:
    files = []
    for p in VAL_FILES[start : start + n]:
        with np.load(p) as z:
            files.append({k: z[k] for k in z.files})
    return files


def jax_batch(files):
    from singa_tpu.data.dataset import _stack

    return _stack(files)


def torch_batch(files):
    from singa_tpu_torch.data.batch import stack

    return stack(files)


@functools.lru_cache(maxsize=None)
def singa_params(lmax: int = 2, mmax: int = 2, n_files: int = 2, seed: int = 0):
    """(jax config, flax params of SINGA) at the tiny config on val pockets."""
    from singa_tpu.models.singa import SINGA as JSINGA

    jcfg = tiny_jax_config(lmax, mmax)
    with compute_dtype_scope("float32"):
        params = jax.jit(JSINGA(jcfg).init)(
            jax.random.PRNGKey(seed), jax_batch(load_val(n_files))
        )
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def sub(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def t(a, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU tensor."""
    out = torch.as_tensor(np.array(a))
    return out if dtype is None else out.to(dtype)


def close(got, want, atol, rtol, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lmax,mmax", [(2, 2), (2, 1), (6, 2)])
def test_coefficient_constants_bit_equal(lmax, mmax):
    """CoefficientMapping and the J-factorised rotation constants are the
    same numbers as the JAX package's numpy (exact equality)."""
    from singa_tpu.equivariant import so3 as jso3
    from singa_tpu_torch.equivariant import so3 as tso3

    a, b = jso3.CoefficientMapping(lmax, mmax), tso3.CoefficientMapping(lmax, mmax)
    for name in ("l_to_m", "m_to_l", "m0_trunc", "l_of_full", "l_of_trunc", "rotate_inv_rescale"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name), err_msg=name)
    assert b.m_size == a.m_size and b.n_trunc == a.n_trunc
    ja, jb = jso3._JLayout(lmax, mmax), tso3._JLayout(lmax, mmax)
    for name in ("J", "J_kept", "J_kept_m", "m_of", "flip", "rot_stage1", "rot_stage2",
                 "rot_stage2_m", "inv_stage2", "inv_rescale"):
        np.testing.assert_array_equal(getattr(jb, name), getattr(ja, name), err_msg=name)


@pytest.mark.parametrize("lmax,mmax", [(2, 2), (2, 1), (6, 2)])
def test_grid_and_jd_constants_bit_equal(lmax, mmax):
    from singa_tpu.equivariant import grid as jgrid
    from singa_tpu.equivariant import sh as jsh
    from singa_tpu.equivariant import wigner as jwig
    from singa_tpu_torch.equivariant import grid as tgrid
    from singa_tpu_torch.equivariant import sh as tsh
    from singa_tpu_torch.equivariant import wigner as twig

    for a, b in zip(jgrid._grid_mats(lmax, mmax), tgrid._grid_mats(lmax, mmax)):
        np.testing.assert_array_equal(b, a)
    ja, jb = jwig._load_jd(), twig._load_jd()
    assert len(ja) == len(jb)
    for a, b in zip(ja, jb):
        np.testing.assert_array_equal(b, a)
    pts = np.random.default_rng(3).normal(size=(64, 3))
    np.testing.assert_array_equal(tsh.real_sph_harm(lmax, pts), jsh.real_sph_harm(lmax, pts))


def test_edge_frame_and_rotations_match_jax():
    """edge_frame, rotate and rotate_inv (m-primary EdgeFrame path) equal
    JAX's at float32 round-off (atol 1e-5: three chained constant matmuls
    with |entries| <= ~3)."""
    import jax.numpy as jnp
    from singa_tpu.equivariant import so3 as jso3
    from singa_tpu_torch.equivariant import so3 as tso3

    rng = np.random.default_rng(5)
    vec = rng.normal(size=(40, 3)).astype(np.float32)
    vec[3] = 0.0  # a padded, zero-length edge
    x = rng.normal(size=(40, 49, 6)).astype(np.float32)
    jf = jso3.edge_frame(jnp.asarray(vec))
    tf = tso3.edge_frame(t(vec))
    close(tf.phi, jf.phi, 1e-6, 1e-6)
    close(tf.beta, jf.beta, 1e-6, 1e-6)
    for m_primary in (True, False):
        r_j = jso3.rotate(jf, jnp.asarray(x), 6, 2, m_primary=m_primary)
        r_t = tso3.rotate(tf, t(x), 6, 2, m_primary=m_primary)
        close(r_t, r_j, 1e-5, 1e-5)
        b_j = jso3.rotate_inv(jf, r_j, 6, 2, m_primary=m_primary)
        b_t = tso3.rotate_inv(tf, t(np.asarray(r_j)), 6, 2, m_primary=m_primary)
        close(b_t, b_j, 1e-5, 1e-5)


def test_gaussian_smearing_matches_jax():
    import jax.numpy as jnp
    from singa_tpu.ops.smearing import gaussian_smearing as jsm
    from singa_tpu_torch.ops.smearing import gaussian_smearing as tsm

    d = np.random.default_rng(1).uniform(0, 16, size=(5, 7)).astype(np.float32)
    # rtol 1e-5: linspace offsets may differ by one float32 ulp
    close(tsm(t(d), 0.0, 15.0, 64), jsm(jnp.asarray(d), 0.0, 15.0, 64), 1e-6, 1e-5)
    close(tsm(t(d), 0.0, 10.0, 16, 20.0), jsm(jnp.asarray(d), 0.0, 10.0, 16, 20.0), 1e-6, 1e-5)


def test_config_copy_matches_jax():
    """The port's config copy has the JAX package's defaults and vocabulary."""
    from singa_tpu import config as jcfg
    from singa_tpu_torch import config as tcfg

    assert tcfg.SMI_VOCAB == jcfg.SMI_VOCAB
    assert (tcfg.SOS_TOKEN, tcfg.EOS_TOKEN, tcfg.PAD_TOKEN) == (
        jcfg.SOS_TOKEN, jcfg.EOS_TOKEN, jcfg.PAD_TOKEN,
    )
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
    assert dataclasses.asdict(port_config(tiny_jax_config())) == dataclasses.asdict(
        tiny_jax_config()
    )


def test_detokenize_matches_jax():
    from singa_tpu.chem.tokenizer import decode as jdecode
    from singa_tpu.chem.tokenizer import encode
    from singa_tpu_torch.chem.tokenizer import decode as tdecode

    for smi in ("CC(=O)Nc1ccccc1", "O=C([O-])c1ccc[nH+]c1", "C1CC1Br"):
        inp, tgt = encode(smi, 40)
        assert tdecode(inp) == jdecode(inp) == smi
        assert tdecode(tgt) == jdecode(tgt) == smi


def test_import_hygiene():
    """Importing every module of the port pulls in no jax, flax or
    singa_tpu module (checked in a fresh interpreter)."""
    code = r"""
import importlib, pkgutil, sys
import singa_tpu_torch
names = ["singa_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(singa_tpu_torch.__path__, "singa_tpu_torch.")
]
for n in names:
    importlib.import_module(n)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "singa_tpu")
)
print(len(names), bad)
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 25  # every module was visited


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports only the port, torch and the standard library
    (read from its source: running it needs a card)."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax", "singa_tpu"}, roots
    assert "singa_tpu_torch" in roots
