"""The port's native Vina scorer (``singa_tpu_torch/cpp``) against the JAX
package's (``singa_tpu/cpp``), in one process: the XS atom types of all 560
``data/corpus_raw`` ligands and of a pocket written from the first val
complex (exact), and the scores, terms and batch scores of 20 corpus ligands
against that pocket (rtol 1e-9: the same sources built with the same flags,
so equal numbers are expected). Then the build rules: the library lands in
``build/vina/`` and never in the JAX package's tree, importing the port
compiles nothing, and a build that fails raises at every entry point that
needs the library (no 0.0, no None).
"""
from __future__ import annotations

import functools
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_common import REPO, VAL_FILES

RAW = sorted(glob.glob(os.path.join(REPO, "data", "corpus_raw", "*.sdf")))


def load_jax_vina() -> None:
    """Load the JAX package's Vina library in this process, one process at a
    time: its ``build`` recompiles ``singa_tpu/cpp/libvina_score.so`` in
    place when the file looks older than its sources (as after a fresh
    checkout), and a worker must not load it while another writes it."""
    import fcntl
    import tempfile

    from singa_tpu.cpp import vina as jv
    from singa_tpu.dock import engine as je

    with open(os.path.join(tempfile.gettempdir(), "singa_tpu_vina_build.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        jv._lib()
        je._lib()


def val_pdb_block(i: int = 0) -> tuple[str, str]:
    """(PDB block of val complex i's protein nodes, its ligand SDF path)."""
    from singa_tpu_torch.chem.pdb import write_pdb

    with np.load(VAL_FILES[i]) as z:
        m = z["protein.mask"]
        block = write_pdb(z["protein.pos"][m], z["protein.atomic_num"][m])
    name = os.path.basename(VAL_FILES[i])[: -len(".npz")]
    return block, os.path.join(REPO, "data", "corpus_raw", f"{name}_ligand.sdf")


@functools.lru_cache(maxsize=None)
def pockets(tmp: str):
    """(port pocket, JAX pocket) of the first val complex's 10 A pocket."""
    from singa_tpu.chem.pdb import PDBProtein as JPDB
    from singa_tpu.chem.sdf import parse_sdf as jparse
    from singa_tpu_torch.chem.pdb import PDBProtein
    from singa_tpu_torch.chem.sdf import parse_sdf

    load_jax_vina()
    block, sdf = val_pdb_block(0)
    path = os.path.join(tmp, "pocket.pdb")
    with open(path, "w") as f:
        f.write(block)
    tp, _ = PDBProtein(path).pocket(parse_sdf(sdf).pos)
    jp, _ = JPDB(path).pocket(jparse(sdf).pos)
    return tp, jp


@pytest.fixture(scope="module")
def pocket_pair(tmp_path_factory):
    return pockets(str(tmp_path_factory.mktemp("vina")))


def ligand_pairs(paths):
    from singa_tpu.chem.sdf import parse_sdf as jparse
    from singa_tpu_torch.chem.sdf import parse_sdf

    return [(parse_sdf(p), jparse(p)) for p in paths]


def test_xs_types_match_jax(pocket_pair):
    from singa_tpu.cpp import vina as jv
    from singa_tpu_torch.cpp import vina as tv

    tp, jp = pocket_pair
    assert tp.num_atoms > 100
    np.testing.assert_array_equal(tv.xs_types(tp), jv.xs_types(jp))
    assert len(RAW) == 560
    for path, (t, j) in zip(RAW, ligand_pairs(RAW)):
        got, want = tv.xs_types(t), jv.xs_types(j)
        assert got.dtype == want.dtype == np.int32, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("fn", ["score_complex", "score_terms", "score_batch"])
def test_scores_match_jax(pocket_pair, fn):
    """20 corpus ligands (every 28th file) in their own input poses against
    the val pocket: the port's library and the JAX package's agree to rtol
    1e-9, and some ligands are in contact (non-zero terms)."""
    from singa_tpu.chem.properties import rotatable_bonds as jrot
    from singa_tpu.cpp import vina as jv
    from singa_tpu_torch.chem.properties import rotatable_bonds
    from singa_tpu_torch.cpp import vina as tv

    tp, jp = pocket_pair
    ligs = ligand_pairs(RAW[::28])
    assert len(ligs) == 20
    if fn == "score_batch":
        got = tv.score_batch([(t.pos, tv.xs_types(t), rotatable_bonds(t)) for t, _ in ligs],
                             tp.pos, tv.xs_types(tp))
        want = jv.score_batch([(j.pos, jv.xs_types(j), jrot(j)) for _, j in ligs],
                              jp.pos, jv.xs_types(jp))
        # the batch entry point scores each ligand as score_complex does
        single = [tv.score_complex(tp, t) for t, _ in ligs]
        np.testing.assert_allclose(got, single, rtol=1e-9, atol=0)
    else:
        got = np.array([getattr(tv, fn)(tp, t) for t, _ in ligs])
        want = np.array([getattr(jv, fn)(jp, j) for _, j in ligs])
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert np.count_nonzero(got) >= 1
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def test_library_builds_under_build_vina():
    """The port's library is built from its own sources into build/vina/,
    named by the hash of sources and flags, with the JAX package's g++
    command line; nothing is written under singa_tpu/."""
    from singa_tpu_torch.cpp import vina

    path = vina.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "vina")
    assert os.path.basename(path).startswith("libvina_score-") and os.path.isfile(path)
    assert vina.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
    for name in ("vina_common.h", "vina_score.cc", "vina_dock.cc"):
        assert os.path.isfile(os.path.join(REPO, "singa_tpu_torch", "cpp", "src", name))
    assert vina.build() == path  # built once


def test_importing_the_port_compiles_nothing():
    """In a fresh interpreter whose subprocess module refuses to start
    anything, every module of the port imports, the Vina library included."""
    code = r"""
import importlib, pkgutil, subprocess
def refuse(*a, **k):
    raise AssertionError("a process was started at import: %r" % (a,))
subprocess.run = subprocess.Popen = subprocess.check_call = subprocess.check_output = refuse
import singa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(singa_tpu_torch.__path__, "singa_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from singa_tpu_torch.cpp import vina
assert vina._LIB is None
assert {"singa_tpu_torch.cpp.vina", "singa_tpu_torch.dock.engine",
        "singa_tpu_torch.tools.make_dataset"} <= set(names)
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


def _entry_points(tmp_path, pocket_pair):
    """name -> a call into the library through a user-facing entry point."""
    import torch

    from singa_tpu_torch.chem.sdf import parse_sdf
    from singa_tpu_torch.cpp import vina
    from singa_tpu_torch.data.batch import stack
    from singa_tpu_torch.dock import conf_energy, dock, torsion_tree
    from singa_tpu_torch.tools import dock_ligand, gen_corpus_complexes, make_dataset
    from singa_tpu_torch.train.gan import main as gan_main
    from singa_tpu_torch.train.rewards import vina_conditioning_host
    from test_torch_common import load_val, sos_tokens

    tp, _ = pocket_pair
    block, sdf = val_pdb_block(0)
    pdb = tmp_path / "p.pdb"
    pdb.write_text(block)
    lig = parse_sdf(sdf)
    index = tmp_path / "index.txt"
    index.write_text(f"{pdb} {sdf} val\n")
    files = load_val(1)
    return {
        "score_complex": lambda: vina.score_complex(tp, lig),
        "score_terms": lambda: vina.score_terms(tp, lig),
        "score_batch": lambda: vina.score_batch([(lig.pos, vina.xs_types(lig), 0)], tp.pos,
                                                vina.xs_types(tp)),
        "dock": lambda: dock(tp, lig, exhaustiveness=1, n_steps=1),
        "conf_energy": lambda: conf_energy(lig, tp, np.zeros(6 + len(torsion_tree(lig).axes))),
        "vina_conditioning_host": lambda: vina_conditioning_host(
            stack(files), torch.as_tensor(sos_tokens(files, 40)), n_eval=1),
        "make_dataset": lambda: make_dataset.main(
            ["--index", str(index), "--outdir", str(tmp_path / "out")]),
        "dock_ligand": lambda: dock_ligand.main([str(pdb), sdf, "--exhaustiveness", "1"]),
        "gen_corpus_complexes": lambda: gen_corpus_complexes.main(
            ["--protein", str(pdb), "--count", "1", "--ligands", "0",
             "--outdir", str(tmp_path / "raw")]),
        "gan_cli": lambda: gan_main(
            ["--synthetic", "--device", "cpu", "--batch-size", "2", "--rounds", "1",
             "--vina-eval", "1", "--logdir", str(tmp_path / "gan")]),
    }


ENTRY_POINTS = ["score_complex", "score_terms", "score_batch", "dock", "conf_energy",
                "vina_conditioning_host", "make_dataset", "dock_ligand", "gen_corpus_complexes",
                "gan_cli"]


def _broken_compiler(monkeypatch, tmp_path, fault: str) -> None:
    """Point the build at a missing compiler, or at one that fails, and at a
    fresh build directory, with no library loaded."""
    from singa_tpu_torch.cpp import vina

    compiler = str(tmp_path / "no-such-g++") if fault == "missing_compiler" else "false"
    monkeypatch.setattr(vina, "CXX", compiler)
    monkeypatch.setattr(vina, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(vina, "_LIB", None)


@pytest.mark.parametrize("fault", ["missing_compiler", "compiler_fails"])
def test_build_raises_on_either_compiler_fault(monkeypatch, tmp_path, fault):
    """A compiler that is missing (OSError) or exits non-zero: ``build``
    raises RuntimeError naming the Vina library, and leaves no library."""
    from singa_tpu_torch.cpp import vina

    _broken_compiler(monkeypatch, tmp_path, fault)
    with pytest.raises(RuntimeError, match="Vina library"):
        vina.build()
    assert not os.path.exists(vina.lib_path())
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_build_failure_raises(monkeypatch, tmp_path, pocket_pair, entry):
    """With a compiler that fails, every entry point raises RuntimeError
    naming the Vina library and writes no shard; the GAN CLI raises before
    its first round (no metrics.jsonl)."""
    from singa_tpu_torch.cpp import vina

    calls = _entry_points(tmp_path, pocket_pair)
    _broken_compiler(monkeypatch, tmp_path, "compiler_fails")
    with pytest.raises(RuntimeError, match="Vina library"):
        calls[entry]()
    assert not (tmp_path / "out").exists() or not any((tmp_path / "out").rglob("*.npz"))
    assert not (tmp_path / "gan" / "metrics.jsonl").exists()
    assert vina._LIB is None
