"""The port's host chem stack (``singa_tpu_torch/chem``, no networkx) against
the JAX package's (``singa_tpu/chem``, networkx), in one process.

Every ligand SDF of ``data/corpus_raw`` and every SMILES of
``singa_tpu/chem/drug_corpus.py::CORPUS`` goes through both stacks: the
molecule graph (rings as ordered lists, neighbour order, bond orders and
aromatic flags), ``write_smiles``, ``atom_features`` and ``bond_features``
exactly; QED, SA, logP, TPSA and ``all_properties`` within 1e-6 (they come
out equal). Each molecule is parsed once and shared between the checks.
"""
from __future__ import annotations

import functools
import glob
import os
import random

import networkx as nx
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SDF_FILES = sorted(glob.glob(os.path.join(REPO, "data", "corpus_raw", "*.sdf")))

# strings both parsers must refuse: grammar, rings, kekulisation, valence
BAD_SMILES = [
    "", "C1CC", "C(C", "CC)", "c1cccc1", "c1ccccc", "C=C=C=", "[Xx]", "C%1",
    "CC(=O)(=O)(=O)C", "c1ccc2c(c1)cccc2c", "n1cccc1C(=O)(C)C", "C11", "FF(F)F",
    "[CH5]", "c1cc[c+]cc1c", "O=O=O", "C1.C1", "(C)C", "1CC",
]


def _jax():
    from singa_tpu.chem import (
        featurize, properties, sdf, smiles_parser, smiles_writer,
    )

    return featurize, properties, sdf, smiles_parser, smiles_writer


def _port():
    from singa_tpu_torch.chem import (
        featurize, properties, sdf, smiles_parser, smiles_writer,
    )

    return featurize, properties, sdf, smiles_parser, smiles_writer


@functools.lru_cache(maxsize=None)
def molecules(source: str) -> list:
    """(name, JAX molecule, port molecule) for every corpus SDF or every
    CORPUS SMILES."""
    j, p = _jax(), _port()
    if source == "sdf":
        return [(os.path.basename(f), j[2].parse_sdf(f), p[2].parse_sdf(f)) for f in SDF_FILES]
    from singa_tpu.chem.drug_corpus import CORPUS

    return [(name, j[3].parse_smiles(s), p[3].parse_smiles(s)) for name, s in CORPUS]


SOURCES = ["sdf", "corpus"]


def test_corpus_sizes():
    from singa_tpu.chem.drug_corpus import CORPUS

    assert len(SDF_FILES) == 560 and len(CORPUS) == 154


@pytest.mark.parametrize("source", SOURCES)
def test_molecule_graph_matches_jax(source):
    """Arrays, rings list for list in networkx's order, every atom's
    neighbours in networkx's order, the edge data, and the perceived flags."""
    for name, jm, tm in molecules(source):
        for f in ("atomic_num", "pos", "bonds", "bond_order", "bond_aromatic", "formal_charge"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f"{name} {f}")
        assert tm.rings == jm.rings, name
        for a in range(jm.num_atoms):
            assert tm.neighbors(a) == list(jm.graph.neighbors(a)), (name, a)
            for b in tm.neighbors(a):
                assert tm.edge_data(a, b) == jm.graph.get_edge_data(a, b), (name, a, b)
        for f in ("aromatic", "hybridization", "partial_charge", "is_donor", "is_donor_h",
                  "is_acceptor", "is_hydrophobe", "is_minus", "is_plus", "in_ring",
                  "degree", "heavy_degree"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f"{name} {f}")
        np.testing.assert_array_equal(tm.bond_in_ring(), jm.bond_in_ring(), err_msg=name)
        np.testing.assert_array_equal(tm._h_count(), jm._h_count(), err_msg=name)
        assert tm.mol_weight == jm.mol_weight, name


@pytest.mark.parametrize("source", SOURCES)
def test_write_smiles_and_features_match_jax(source):
    jf, _, _, _, jw = _jax()
    tf, _, _, _, tw = _port()
    for name, jm, tm in molecules(source):
        assert tw.write_smiles(tm) == jw.write_smiles(jm), name
        np.testing.assert_array_equal(tf.atom_features(tm), jf.atom_features(jm), err_msg=name)
        for got, want in zip(tf.bond_features(tm), jf.bond_features(jm)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("source", SOURCES)
def test_properties_match_jax(source):
    _, jp, _, _, _ = _jax()
    _, tp, _, _, _ = _port()
    for name, jm, tm in molecules(source):
        for fn in ("qed", "sa_score", "logp", "tpsa"):
            got, want = getattr(tp, fn)(tm), getattr(jp, fn)(jm)
            assert abs(got - want) <= 1e-6, (name, fn, got, want)
        got, want = tp.all_properties(tm), jp.all_properties(jm)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (name, k, got[k], want[k])
        for fn in ("hba", "hbd", "rotatable_bonds", "aromatic_ring_count", "structural_alerts"):
            assert getattr(tp, fn)(tm) == getattr(jp, fn)(jm), (name, fn)


def test_written_smiles_parse_as_in_jax():
    """The SMILES written for the 560 SDFs, parsed back by both parsers:
    aromatic rings arrive lowercase, so each parse kekulises through the
    matching. The same validity, kekulé bond orders, rings and properties."""
    _, jp, _, jsp, jw = _jax()
    _, tp, _, tsp, tw = _port()
    n_valid = 0
    for name, jm, _ in molecules("sdf"):
        smi = jw.write_smiles(jm)
        ok = jsp.is_valid_smiles(smi)
        assert tsp.is_valid_smiles(smi) == ok, (name, smi)
        if not ok:
            continue
        n_valid += 1
        a, b = jsp.parse_smiles(smi), tsp.parse_smiles(smi)
        np.testing.assert_array_equal(b.bond_order, a.bond_order, err_msg=smi)
        np.testing.assert_array_equal(b.bond_aromatic, a.bond_aromatic, err_msg=smi)
        assert b.rings == a.rings, smi
        assert tw.write_smiles(b) == jw.write_smiles(a), smi
        got, want = tp.all_properties(b), jp.all_properties(a)
        assert all(abs(got[k] - want[k]) <= 1e-6 for k in want), (smi, got, want)
    assert n_valid > 500


def test_is_valid_smiles_matches_jax():
    from singa_tpu.chem.drug_corpus import CORPUS
    from singa_tpu.chem.smiles_parser import is_valid_smiles as jvalid
    from singa_tpu_torch.chem.smiles_parser import is_valid_smiles as tvalid

    for _, smi in CORPUS:
        assert tvalid(smi) and jvalid(smi), smi
    for smi in BAD_SMILES:
        assert tvalid(smi) == jvalid(smi), smi
    assert sum(not jvalid(s) for s in BAD_SMILES) >= 15
    # kekulisation failures raise ValueError in both
    from singa_tpu.chem.smiles_parser import parse_smiles as jparse
    from singa_tpu_torch.chem.smiles_parser import parse_smiles as tparse

    for smi in ("c1cccc1", "c1ccc2c(c1)cccc2c"):
        for parse in (jparse, tparse):
            with pytest.raises(ValueError, match="kekulisation"):
                parse(smi)


def _random_graphs(n_graphs: int, seed: int):
    """(networkx Graph, the same edges as an insertion-ordered adjacency)."""
    rng = random.Random(seed)
    for _ in range(n_graphs):
        n = rng.randint(1, 14)
        p = rng.choice([0.15, 0.25, 0.4, 0.6])
        edges = [(i, j) for i in range(n) for j in range(i + 1, n) if rng.random() < p]
        rng.shuffle(edges)
        g, adj = nx.Graph(), {}
        for i, j in edges:
            a, b = (j, i) if rng.random() < 0.5 else (i, j)
            g.add_edge(a, b)
            adj.setdefault(a, {})
            adj.setdefault(b, {})
            adj[a][b] = adj[b][a] = None
        yield g, adj


def test_matching_matches_networkx():
    """The kekulisation matching is the one networkx returns, on random
    graphs with odd cycles (blossoms) and several maximum matchings."""
    from singa_tpu_torch.chem.matching import max_cardinality_matching

    for g, adj in _random_graphs(1500, 0):
        want = {frozenset(e) for e in nx.max_weight_matching(g, maxcardinality=True)}
        mate = max_cardinality_matching(adj)
        assert all(mate[b] == a for a, b in mate.items())
        assert {frozenset(e) for e in mate.items()} == want, sorted(g.edges)


def test_cycle_basis_matches_networkx():
    from singa_tpu_torch.chem.mol import cycle_basis

    for g, adj in _random_graphs(1500, 1):
        assert cycle_basis(adj) == nx.cycle_basis(g)


def test_periodic_and_tokenizer_copies_match_jax():
    from singa_tpu.chem import periodic as jper
    from singa_tpu.chem import tokenizer as jtok
    from singa_tpu.chem.drug_corpus import CORPUS
    from singa_tpu_torch.chem import periodic as tper
    from singa_tpu_torch.chem import tokenizer as ttok

    assert tper.SYMBOLS == jper.SYMBOLS and tper.ATOMIC_NUMBER == jper.ATOMIC_NUMBER
    assert tper.ATOMIC_WEIGHT == jper.ATOMIC_WEIGHT
    for z in range(90):
        for fn in ("covalent_radius", "vdw_radius", "electronegativity", "atomic_weight"):
            assert getattr(tper, fn)(z) == getattr(jper, fn)(z)
    for _, smi in CORPUS:
        assert ttok.split_smiles(smi) == jtok.split_smiles(smi)
        for got, want in zip(ttok.encode(smi, 200), jtok.encode(smi, 200)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert ttok.decode(ttok.encode(smi, 200)[0]) == smi
    for bad in ("C[Xe]C", "C" * 200):
        for enc in (jtok.encode, ttok.encode):
            with pytest.raises(ValueError):
                enc(bad, 200)


def test_laplacian_pe_matches_jax():
    from singa_tpu.ops.laplacian import laplacian_pe_numpy as jpe
    from singa_tpu_torch.ops.laplacian import laplacian_pe_numpy as tpe
    from singa_tpu_torch.chem.featurize import bond_features

    for name, _, tm in molecules("sdf")[::40]:
        ei, _ = bond_features(tm)
        for k in (8, 4):
            got = tpe(ei, tm.num_atoms, k, np.random.default_rng(3))
            want = jpe(ei, tm.num_atoms, k, np.random.default_rng(3))
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tpe(np.zeros((2, 0), np.int64), 3), jpe(np.zeros((2, 0), np.int64), 3))


def test_sdf_helpers_match_jax():
    from singa_tpu.chem import sdf as jsdf
    from singa_tpu_torch.chem import sdf as tsdf

    for name, jm, tm in molecules("sdf")[::25]:
        np.testing.assert_array_equal(tsdf.center_of_mass(tm), jsdf.center_of_mass(jm))
        text = tsdf.write_sdf(tm, name)
        assert text == jsdf.write_sdf(jm, name)
        back = tsdf.parse_sdf(text)
        np.testing.assert_array_equal(back.bonds, tm.bonds)
        np.testing.assert_allclose(back.pos, tm.pos, atol=1e-4)
    path = SDF_FILES[0]
    for remove_hs in (True, False):
        a, b = jsdf.parse_sdf(path, remove_hs), tsdf.parse_sdf(path, remove_hs)
        np.testing.assert_array_equal(b.atomic_num, a.atomic_num)
        assert b.rings == a.rings
