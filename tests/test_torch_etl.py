"""The port's ETL (``python -m singa_tpu_torch.tools.make_dataset``) against
the JAX package's ``tools/make_dataset.py::process_one``, in one process, on
three val complexes rebuilt as (PDB block of the protein nodes, the complex's
own corpus SDF) and listed in an ``--index`` file: every array of every
shard equals JAX's (ints and bools exact, floats within 1e-6), the Vina
label included, which is non-zero and equals the port's ``score_complex`` of
the pocket; the port's ``NpzDataset`` reads the shards back. Then the
``--scan`` layout, with an unreadable ligand skipped, and the corpus tool
(``gen_corpus_complexes``: embedded drugs docked at surface sites) against
JAX's, its index fed to the port's ETL.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from test_torch_common import REPO
from test_torch_vina import load_jax_vina, val_pdb_block

N = 3


def jax_tool(name: str):
    """tools/<name>.py of the JAX package, loaded under its own module name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(port shard paths, JAX shard paths, [(pdb, sdf)]) of the first N val
    complexes."""
    from singa_tpu.config import Config as JConfig
    from singa_tpu_torch.tools import make_dataset

    load_jax_vina()
    tmp = tmp_path_factory.mktemp("etl")
    pairs = []
    for i in range(N):
        block, sdf = val_pdb_block(i)
        pdb = tmp / f"complex{i}.pdb"
        pdb.write_text(block)
        pairs.append((str(pdb), sdf))
    index = tmp / "index.txt"
    index.write_text("# protein ligand split\n"
                     + "".join(f"{p} {s} val\n" for p, s in pairs))
    got = make_dataset.main(["--index", str(index), "--outdir", str(tmp / "port")])
    jmd = jax_tool("make_dataset")
    want = []
    for pdb, sdf in pairs:
        out = str(tmp / (os.path.basename(sdf).replace("_ligand.sdf", "") + ".npz"))
        assert jmd.process_one(pdb, sdf, out, JConfig()) is None
        want.append(out)
    return got, want, pairs


@pytest.mark.parametrize("i", range(N))
def test_shards_match_jax_process_one(shards, i):
    got, want, pairs = shards
    sdf = pairs[i][1]
    name = os.path.basename(sdf).replace("_ligand.sdf", "")
    assert got[i].endswith(os.path.join("port", "val", name + ".npz"))
    with np.load(got[i]) as g, np.load(want[i]) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            a, b = g[k], w[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        assert float(g["props.vina"]) != 0.0 and g["protein.mask"].sum() > 100
        assert g["ligand.mask"].sum() >= 4 and (g["tokens.target"] != g["tokens.target"][-1]).any()


def test_vina_label_is_score_complex(shards):
    from singa_tpu_torch.chem.pdb import PDBProtein
    from singa_tpu_torch.chem.sdf import parse_sdf
    from singa_tpu_torch.cpp.vina import score_complex

    got, _, pairs = shards
    for path, (pdb, sdf) in zip(got, pairs):
        lig = parse_sdf(sdf)
        pocket, _ = PDBProtein(pdb).pocket(lig.pos, radius=10.0)
        with np.load(path) as z:
            assert z["props.vina"] == np.float32(score_complex(pocket, lig))


def test_npz_dataset_reads_the_shards(shards):
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.data.dataset import NpzDataset

    got, _, _ = shards
    ds = NpzDataset(os.path.dirname(got[0]), batch_size=N, shuffle=False)
    assert ds.files == sorted(got)
    batch = next(ds.epoch())
    assert batch.protein.x.shape == (N, 384, 59) and batch.tokens.input.shape == (N, 200)
    assert batch.tables.intra.shape[0] == N
    again = load_npz(sorted(got))
    for a, b in zip(batch.props, again.props):
        assert (a == b).all() and (a != 0).all()


def test_scan_layout_skips_an_unreadable_ligand(tmp_path, capsys):
    from singa_tpu_torch.tools import make_dataset

    block, sdf = val_pdb_block(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    for name in ("good", "bad"):
        (raw / f"{name}_protein.pdb").write_text(block)
    (raw / "good_ligand.sdf").write_text(open(sdf).read())
    (raw / "bad_ligand.sdf").write_text("bad\n\n\nxx\n")
    out = make_dataset.main(["--scan", str(raw), "--outdir", str(tmp_path / "out"),
                             "--split", "train"])
    assert out == [str(tmp_path / "out" / "train" / "good.npz")]
    log = capsys.readouterr().out
    assert "done: 1 ok, 1 skipped" in log and "skipped bad: ValueError" in log


def test_gen_corpus_complexes_matches_jax(tmp_path, monkeypatch):
    """Three base drugs embedded, placed at two surface sites of a val
    complex's PDB block and docked (exhaustiveness 1): the port writes the
    same SDF text and the same names and splits as JAX's tool, and the
    port's ETL turns its index into three Vina-labelled shards."""
    import sys

    from singa_tpu_torch.tools import gen_corpus_complexes, make_dataset

    load_jax_vina()
    pdb = tmp_path / "protein.pdb"
    pdb.write_text(val_pdb_block(3)[0])
    common = ["--protein", str(pdb), "--count", "3", "--ligands", "0", "--sites", "2",
              "--exhaustiveness", "1"]
    gen_corpus_complexes.main([*common, "--outdir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["gen_corpus_complexes.py", *common,
                                      "--outdir", str(tmp_path / "jax")])
    jax_tool("gen_corpus_complexes").main()
    index = [ln.split() for ln in (tmp_path / "port" / "index.txt").read_text().splitlines()]
    jindex = [ln.split() for ln in (tmp_path / "jax" / "index.txt").read_text().splitlines()]
    assert len(index) == len(jindex) == 3
    for (p, sdf, split), (jp, jsdf, jsplit) in zip(index, jindex):
        assert p == jp == str(pdb) and split == jsplit
        assert os.path.basename(sdf) == os.path.basename(jsdf)
        assert open(sdf).read() == open(jsdf).read(), sdf
    shards = make_dataset.main(["--index", str(tmp_path / "port" / "index.txt"),
                                "--outdir", str(tmp_path / "shards")])
    assert len(shards) == 3
    for path in shards:
        with np.load(path) as z:
            assert float(z["props.vina"]) != 0.0 and z["ligand.mask"].sum() >= 4
