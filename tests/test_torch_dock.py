"""The port's pose search (``singa_tpu_torch/dock``) against the JAX
package's (``singa_tpu/dock``), in one process: the torsion trees and the
intra-ligand pairs of all 560 ``data/corpus_raw`` ligands (exact), the
conformation energy at seeded random dof vectors (rtol 1e-9), and short
seeded searches of three small corpus ligands in the first val complex's
pocket (scores rtol 1e-9, poses atol 1e-6 A), and the re-docking CLI's
table against JAX's tool's. ``chem.mol.within_bonds``,
which stands in for networkx's cut-off shortest paths, is held to networkx
on random graphs.
"""
from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from test_torch_common import REPO
from test_torch_vina import ligand_pairs, pockets, val_pdb_block

RAW = sorted(glob.glob(os.path.join(REPO, "data", "corpus_raw", "*.sdf")))
# three small corpus ligands with 0, 1 and 2 torsions
DOCKED = ["acetamide_s0_152", "ethanol-hydroxy0_s0_280", "acetic-acid-ethyl0_s0_281"]


@pytest.fixture(scope="module")
def pocket_pair(tmp_path_factory):
    return pockets(str(tmp_path_factory.mktemp("dock")))


def test_torsion_trees_and_pairs_match_jax():
    from singa_tpu.dock import interacting_pairs as jpairs
    from singa_tpu.dock import torsion_tree as jtree
    from singa_tpu_torch.dock import interacting_pairs, torsion_tree

    n_tor = 0
    for path, (t, j) in zip(RAW, ligand_pairs(RAW)):
        got, want = torsion_tree(t), jtree(j)
        for field in got._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype and g.shape == w.shape, (path, field)
            np.testing.assert_array_equal(g, w, err_msg=f"{path} {field}")
        g, w = interacting_pairs(t, got), jpairs(j, want)
        assert g.dtype == w.dtype == np.int32, path
        np.testing.assert_array_equal(g, w, err_msg=path)
        n_tor += len(got.axes)
    assert n_tor > 500  # the corpus exercises real torsions


def test_within_bonds_matches_networkx():
    import networkx as nx

    from singa_tpu_torch.chem.mol import Molecule, within_bonds

    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 30))
        bonds = np.unique(np.sort(rng.integers(0, n, size=(int(rng.integers(1, 2 * n)), 2)), 1),
                          axis=0)
        bonds = bonds[bonds[:, 0] != bonds[:, 1]]
        mol = Molecule(atomic_num=np.full(n, 6), pos=np.zeros((n, 3)), bonds=bonds,
                       bond_order=np.ones(len(bonds)), bond_aromatic=np.zeros(len(bonds)))
        g = nx.Graph()
        g.add_nodes_from(range(n))
        g.add_edges_from(map(tuple, bonds))
        for cutoff in (1, 3):
            want = dict(nx.all_pairs_shortest_path_length(g, cutoff=cutoff))
            for s in range(n):
                assert within_bonds(mol, s, cutoff) == set(want[s])


def test_conf_energy_matches_jax(pocket_pair):
    """Ten corpus ligands (every 56th file), four seeded dof vectors each
    (centroid within 3 A of the ligand's, angles in [-pi, pi]): the energy
    rtol 1e-9 and the built coordinates atol 1e-9 A."""
    from singa_tpu.dock import conf_energy as jce
    from singa_tpu_torch.dock import conf_energy, torsion_tree

    tp, jp = pocket_pair
    rng = np.random.default_rng(11)
    for path, (t, j) in zip(RAW[::56], ligand_pairs(RAW[::56])):
        n_tor = len(torsion_tree(t).axes)
        for _ in range(4):
            x = np.concatenate([t.pos.mean(0) + rng.uniform(-3, 3, 3),
                                rng.uniform(-np.pi, np.pi, 3 + n_tor)])
            e, xyz = conf_energy(t, tp, x)
            je, jxyz = jce(j, jp, x)
            assert np.isfinite(e) and xyz.shape == (t.num_atoms, 3), path
            np.testing.assert_allclose(e, je, rtol=1e-9, atol=0, err_msg=path)
            np.testing.assert_allclose(xyz, jxyz, rtol=0, atol=1e-9, err_msg=path)


@pytest.mark.parametrize("name", DOCKED)
def test_dock_matches_jax(pocket_pair, name):
    """In a 16 A box on the val complex's own ligand, exhaustiveness 2, 40
    steps, seed 5, up to 4 poses: the same poses in the same order, scores
    rtol 1e-9, coordinates atol 1e-6 A, best first, in contact (< 0)."""
    from singa_tpu.dock import dock as jdock
    from singa_tpu_torch.chem.sdf import parse_sdf
    from singa_tpu_torch.dock import dock, torsion_tree

    tp, jp = pocket_pair
    (t, j), = ligand_pairs([os.path.join(REPO, "data", "corpus_raw", f"{name}_ligand.sdf")])
    assert len(torsion_tree(t).axes) == DOCKED.index(name)
    center = parse_sdf(val_pdb_block(0)[1]).pos.mean(0)
    kw = dict(center=center, box_size=16.0, exhaustiveness=2, n_steps=40, seed=5, max_poses=4)
    got, want = dock(tp, t, **kw), jdock(jp, j, **kw)
    assert 1 <= len(got) == len(want)
    scores = [r.score for r in got]
    assert scores == sorted(scores) and np.isfinite(scores).all() and scores[0] < 0
    np.testing.assert_allclose(scores, [r.score for r in want], rtol=1e-9, atol=0)
    for g, w in zip(got, want):
        assert g.pos.shape == (t.num_atoms, 3)
        np.testing.assert_allclose(g.pos, w.pos, rtol=0, atol=1e-6)


def test_dock_ligand_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """python -m singa_tpu_torch.tools.dock_ligand on the val complex's PDB
    block and SDF (exhaustiveness 2, 30 steps, 4 poses) prints JAX's
    tool's table; its poses file reads back as those poses (4 decimals)."""
    import sys

    from singa_tpu_torch.chem.pdb import PDBProtein
    from singa_tpu_torch.chem.sdf import parse_sdf
    from singa_tpu_torch.dock import dock
    from singa_tpu_torch.tools import dock_ligand
    from test_torch_etl import jax_tool
    from test_torch_vina import load_jax_vina

    load_jax_vina()
    block, sdf = val_pdb_block(0)
    pdb = tmp_path / "p.pdb"
    pdb.write_text(block)
    args = [str(pdb), sdf, "--exhaustiveness", "2", "--steps", "30", "--poses", "4"]
    dock_ligand.main([*args, "--out", str(tmp_path / "poses.sdf")])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["dock_ligand.py", *args])
    jax_tool("dock_ligand").main()
    want = capsys.readouterr().out
    assert got == want and got.count("\n") == 2 + 4
    text = (tmp_path / "poses.sdf").read_text()
    blocks = [b + "$$$$\n" for b in text.split("$$$$\n")[:-1]]
    scores = [float(ln.split("|")[1]) for ln in got.splitlines()[2:]]
    assert len(blocks) == len(scores) == 4
    lig = parse_sdf(sdf)
    pocket, _ = PDBProtein(str(pdb)).pocket(lig.pos)
    poses = dock(pocket, lig, exhaustiveness=2, n_steps=30, max_poses=4)
    for blk, score, pose in zip(blocks, scores, poses):
        assert blk.splitlines()[0] == f"pose_{blocks.index(blk) + 1}_score_{pose.score:.3f}"
        assert score == float(f"{pose.score:.3f}")
        read = parse_sdf(blk)
        np.testing.assert_array_equal(read.atomic_num, lig.atomic_num)
        np.testing.assert_allclose(read.pos, pose.pos, rtol=0, atol=1e-4)
