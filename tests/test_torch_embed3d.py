"""The port's 3-D embedder, SASA, drug corpus and ligand expansion
(``singa_tpu_torch/chem/{embed3d,sasa,drug_corpus,ligand_expand}.py``)
against the JAX package's, in one process: ``embed_smiles`` of 20 ``CORPUS``
SMILES at two seeds (atol 1e-6 A: the same numpy draws and arithmetic),
``total_sasa`` and the per-atom Shrake-Rupley areas of corpus ligands (rtol
1e-9), ``CORPUS`` itself, the substituent grafts, ``expand_corpus(450,
seed=7)`` and ``ligand_disjoint_split`` (equal).
"""
from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from test_torch_common import REPO

RAW = sorted(glob.glob(os.path.join(REPO, "data", "corpus_raw", "*.sdf")))


@pytest.mark.parametrize("seed", [0, 3])
def test_embed_smiles_matches_jax(seed):
    """20 CORPUS entries (every 7th from the first): the same graph, the
    same coordinates within 1e-6 A, float32, centred, no atom on another."""
    from singa_tpu.chem.drug_corpus import CORPUS
    from singa_tpu.chem.embed3d import embed_smiles as jembed
    from singa_tpu_torch.chem.embed3d import embed_smiles

    smiles = [s for _, s in CORPUS[::7]][:20]
    assert len(smiles) == 20
    for smi in smiles:
        got, want = embed_smiles(smi, seed=seed), jembed(smi, seed=seed)
        np.testing.assert_array_equal(got.atomic_num, want.atomic_num, err_msg=smi)
        np.testing.assert_array_equal(got.bonds, want.bonds, err_msg=smi)
        assert got.pos.dtype == np.float32 and got.pos.shape == (got.num_atoms, 3)
        np.testing.assert_allclose(got.pos, want.pos, rtol=0, atol=1e-6, err_msg=smi)
        np.testing.assert_allclose(got.pos.mean(0), 0.0, atol=1e-4)
        if got.num_atoms > 1:
            d = np.linalg.norm(got.pos[:, None] - got.pos[None], axis=-1)
            assert d[~np.eye(len(d), dtype=bool)].min() > 0.5, smi


def test_sasa_matches_jax():
    """Every 20th corpus ligand: total and per-atom areas rtol 1e-9, the
    polarity classes and radii equal."""
    from singa_tpu.chem import sasa as jsasa
    from singa_tpu.chem.sdf import parse_sdf as jparse
    from singa_tpu_torch.chem import sasa
    from singa_tpu_torch.chem.sdf import parse_sdf

    for path in RAW[::20]:
        t, j = parse_sdf(path), jparse(path)
        for a, b in zip(sasa.classify_atoms(t.atomic_num), jsasa.classify_atoms(j.atomic_num)):
            np.testing.assert_array_equal(a, b, err_msg=path)
        got, want = sasa.total_sasa(t.pos, t.atomic_num), jsasa.total_sasa(j.pos, j.atomic_num)
        assert got > 0, path
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0, err_msg=path)
        _, radii = sasa.classify_atoms(t.atomic_num)
        np.testing.assert_allclose(sasa.shrake_rupley(t.pos, radii, n_points=50),
                                   jsasa.shrake_rupley(j.pos, radii, n_points=50),
                                   rtol=1e-9, atol=0, err_msg=path)


def test_corpus_matches_jax():
    from singa_tpu.chem.drug_corpus import CORPUS as JCORPUS
    from singa_tpu_torch.chem.drug_corpus import CORPUS

    assert CORPUS == JCORPUS and len(CORPUS) >= 150


def test_substituent_grafts_match_jax():
    """Every substituent on the first three sites of 12 CORPUS drugs: the
    same attachment sites and the same variant SMILES (or None)."""
    from singa_tpu.chem import ligand_expand as jle
    from singa_tpu.chem.smiles_parser import parse_smiles as jparse
    from singa_tpu_torch.chem import ligand_expand as le
    from singa_tpu_torch.chem.drug_corpus import CORPUS
    from singa_tpu_torch.chem.smiles_parser import parse_smiles

    assert le.SUBSTITUENTS == jle.SUBSTITUENTS and le.MAX_ATOMS == jle.MAX_ATOMS
    made = 0
    for _, smi in CORPUS[::13]:
        assert le.attachment_sites(parse_smiles(smi)) == jle.attachment_sites(jparse(smi)), smi
        for site in range(3):
            for k in range(len(le.SUBSTITUENTS)):
                got = le.derive_variant(smi, site, k)
                assert got == jle.derive_variant(smi, site, k), (smi, site, k)
                made += got is not None
    assert made > 100


def test_expand_corpus_and_split_match_jax():
    from singa_tpu.chem import ligand_expand as jle
    from singa_tpu_torch.chem import ligand_expand as le

    got, want = le.expand_corpus(450, seed=7), jle.expand_corpus(450, seed=7)
    assert got == want and len(got) == 450 and len({s for _, s, _ in got}) == 450
    for val_frac, seed in ((0.12, 7), (0.3, 1)):
        split = le.ligand_disjoint_split(got, val_frac=val_frac, seed=seed)
        assert split == jle.ligand_disjoint_split(want, val_frac=val_frac, seed=seed)
        assert set(split.values()) == {"train", "val"}
