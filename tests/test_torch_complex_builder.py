"""The port's complex builder (``singa_tpu_torch/data/complex_builder.py``)
against the JAX package's, in one process, on two PDB blocks this file
writes itself (the repository holds no PDB):

(a) the protein nodes of the first sorted val complex (the 7cff pocket at
    the serving size) as ATOM records with the element in columns 77-78,
    8 atoms a residue named UNK, with that complex's own ligand SDF;
(b) a few hand-placed residues round diclofenac (a PHE ring under PHE's
    pi-atom names stacked on its ring, a LYS NZ beside its carboxylate, an
    ASP carboxylate, a SER OG, an ALA CB and one water), with the ligand as
    its carboxylate anion: every interaction flag but the halogen bond is set
    on some edge.

Every array of ``build_from_files`` must equal JAX's (float arrays within
1e-6; they come out equal), with and without the ligand, after the
destination tables drop edges over the in-degree caps.
"""
from __future__ import annotations

import functools
import glob
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL = sorted(glob.glob(os.path.join(REPO, "data", "corpus", "val", "*.npz")))
RAW = os.path.join(REPO, "data", "corpus_raw")
DICLOFENAC = os.path.join(RAW, "diclofenac_s0_4_ligand.sdf")


def block_a() -> tuple[str, str]:
    """(PDB block, ligand SDF path) of the first sorted val complex."""
    from singa_tpu_torch.chem.pdb import write_pdb

    with np.load(VAL[0]) as z:
        m = z["protein.mask"]
        block = write_pdb(z["protein.pos"][m], z["protein.atomic_num"][m])
    name = os.path.basename(VAL[0])[: -len(".npz")]
    return block, os.path.join(RAW, f"{name}_ligand.sdf")


def _unit(v):
    return v / np.linalg.norm(v)


def block_b() -> tuple[str, str]:
    """(PDB block, SDF text of diclofenac as its carboxylate)."""
    from singa_tpu_torch.chem.pdb import atom_line
    from singa_tpu_torch.chem.sdf import parse_sdf

    with open(DICLOFENAC) as f:
        lines = f.read().splitlines()
    end = lines.index("M  END")
    sdf = "\n".join(lines[:end] + ["M  CHG  1   1  -1"] + lines[end:]) + "\n"

    p = parse_sdf(DICLOFENAC).pos.astype(np.float64)
    ring = [4, 5, 6, 7, 8, 9]  # the phenylacetic ring
    c = p[ring].mean(0)
    n = np.linalg.svd(p[ring] - c)[2][2]
    if np.dot(n, p[0] - c) > 0:  # stack on the side away from the acid
        n = -n
    u = _unit(p[4] - c)
    v = np.cross(n, u)
    atoms = [("CB", "PHE", 1, c + 3.6 * n + 2.9 * u, 6)]
    for k, name in enumerate(("CG", "CD1", "CE1", "CZ", "CE2", "CD2")):
        a = 2 * np.pi * k / 6
        atoms.append((name, "PHE", 1, c + 3.6 * n + 1.39 * (np.cos(a) * u + np.sin(a) * v), 6))
    # LYS NZ 3.0 A off the carboxylate's O1: of 200 directions, the one
    # farthest from the other ligand atoms within 4.8 A of the ring centroid
    k = np.arange(200) + 0.5
    th, ph = np.arccos(1 - 2 * k / 200), np.pi * (1 + 5**0.5) * k
    cand = p[0] + 3.0 * np.stack([np.cos(ph) * np.sin(th), np.sin(ph) * np.sin(th), np.cos(th)], 1)
    clear = np.linalg.norm(cand[:, None] - p[None, 1:], axis=-1).min(1)
    clear[np.linalg.norm(cand - c, axis=1) > 4.8] = -1
    nz = cand[int(np.argmax(clear))]
    atoms += [("CE", "LYS", 2, nz + 1.49 * _unit(nz - c), 6), ("NZ", "LYS", 2, nz, 7)]
    og = p[2] + 2.8 * _unit(p[2] - p[1])  # SER OG 2.8 A off the carbonyl O
    atoms += [("CB", "SER", 3, og + 1.43 * _unit(og - p[2]), 6), ("OG", "SER", 3, og, 8)]
    cg = p[10] + 3.8 * _unit(p[10] - p[[9, 11]].mean(0))  # ASP by the amine N
    d = _unit(p[10] - cg)
    w = _unit(np.cross(d, n))
    atoms += [("CB", "ASP", 4, cg - 1.52 * d, 6), ("CG", "ASP", 4, cg, 6),
              ("OD1", "ASP", 4, cg + 1.25 * (0.5 * d + 0.866 * w), 8),
              ("OD2", "ASP", 4, cg + 1.25 * (0.5 * d - 0.866 * w), 8)]
    cb = p[13] + 3.8 * _unit(p[13] - p[12])  # ALA CB 3.8 A off a Cl
    atoms += [("CA", "ALA", 5, cb + 1.53 * _unit(cb - p[13]), 6), ("CB", "ALA", 5, cb, 6)]
    out = [atom_line(i + 1, nm, rn, rs, pos, z) for i, (nm, rn, rs, pos, z) in enumerate(atoms)]
    out.append(atom_line(len(atoms) + 1, "O", "HOH", 6, c + 6 * n, 8, record="HETATM"))
    return "\n".join(out + ["END"]) + "\n", sdf


@functools.lru_cache(maxsize=None)
def blocks(tmp: str) -> dict:
    """{'a': (block, sdf path), 'b': (block, sdf path)}, the SDF of (b)
    written under ``tmp``."""
    b_block, b_sdf = block_b()
    path = os.path.join(tmp, "diclofenac_anion.sdf")
    with open(path, "w") as f:
        f.write(b_sdf)
    return {"a": block_a(), "b": (b_block, path)}


@pytest.fixture(scope="module")
def pdb_blocks(tmp_path_factory):
    return blocks(str(tmp_path_factory.mktemp("blocks")))


def assert_batches_equal(got, want, path="batch"):
    """Every field of the port's batch (CPU tensors) against JAX's (numpy).
    JAX's destination tables also hold source tables, which the port does
    not keep (its backward needs none)."""
    if got is None:
        assert want is None, path
        return
    if isinstance(got, torch.Tensor):
        w = np.asarray(want)
        g = got.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)
        return
    assert got._fields == want._fields[: len(got._fields)], path
    for f in got._fields:
        assert_batches_equal(getattr(got, f), getattr(want, f), f"{path}.{f}")


LP_FLAGS = {"hbond": 5, "hydrophobic": 7, "salt_bridge": 8, "pi_stack": 9, "pi_cation": 10}


def test_block_b_sets_every_interaction_flag(pdb_blocks):
    """JAX's own builder flags an H-bond, a hydrophobic contact, a salt
    bridge, pi-stacking and pi-cation on block (b), and the water is gone."""
    from singa_tpu.data.complex_builder import build_from_files

    block, sdf = pdb_blocks["b"]
    batch = build_from_files(block, sdf)
    mask = np.asarray(batch.lp.mask[0])
    attr = np.asarray(batch.lp.attr[0])[mask]
    for name, col in LP_FLAGS.items():
        assert attr[:, col].sum() >= 1, name
    assert int(np.asarray(batch.protein.mask).sum()) == 17  # HOH skipped


@pytest.mark.parametrize("with_ligand", [True, False])
@pytest.mark.parametrize("block", ["a", "b"])
def test_build_from_files_matches_jax(pdb_blocks, block, with_ligand):
    from singa_tpu.data.complex_builder import build_from_files as jbuild
    from singa_tpu_torch.data.complex_builder import build_from_files as tbuild

    pdb, sdf = pdb_blocks[block]
    sdf = sdf if with_ligand else None
    want = jbuild(pdb, sdf)
    got = tbuild(pdb, sdf)
    assert_batches_equal(got, want)
    assert got.tables is not None and got.batch_size == 1
    if sdf is None:  # protein-only: the tokens are all PAD, the ligand empty
        from singa_tpu_torch.config import PAD_TOKEN

        assert (got.tokens.input == PAD_TOKEN).all() and (got.tokens.target == PAD_TOKEN).all()
        assert not got.ligand.mask.any() and not got.lp.mask.any()
    if block == "a" and with_ligand:
        assert int(got.protein.mask.sum()) == 160 and int(got.pl.mask.sum()) == 20


def test_build_from_files_reads_paths_and_is_repeatable(pdb_blocks, tmp_path):
    """A PDB path gives the batch its text gives, and two builds agree bit
    for bit."""
    from singa_tpu_torch.data.complex_builder import build_from_files

    block, sdf = pdb_blocks["a"]
    path = tmp_path / "pocket.pdb"
    path.write_text(block)
    a, b = build_from_files(str(path), sdf), build_from_files(block, sdf)
    for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y)


def test_build_complex_tokens_props_and_overflow_match_jax(pdb_blocks):
    """build_complex with a SMILES and property labels, and the bucket
    overflow at a small node bucket, as in JAX."""
    from singa_tpu.chem.interactions import ProteinContext as JCtx
    from singa_tpu.chem.pdb import PDBProtein as JPDB
    from singa_tpu.chem.sdf import parse_sdf as jsdf
    from singa_tpu.config import ShapeConfig as JShapes
    from singa_tpu.data import complex_builder as jcb
    from singa_tpu_torch.chem.interactions import ProteinContext as TCtx
    from singa_tpu_torch.chem.pdb import PDBProtein as TPDB
    from singa_tpu_torch.chem.sdf import parse_sdf as tsdf
    from singa_tpu_torch.config import ShapeConfig as TShapes
    from singa_tpu_torch.data import complex_builder as tcb

    block, sdf = pdb_blocks["b"]
    smi, props = "OC(=O)Cc1ccccc1Nc1c(Cl)cccc1Cl", {"qed": 0.8, "sas": 2.5, "vina": -7.25}
    out = []
    for PDB, parse, Ctx in ((JPDB, jsdf, JCtx), (TPDB, tsdf, TCtx)):
        prot = PDB(block)
        ctx = Ctx(np.array([a.res_name for a in prot.atoms]), np.array([a.name for a in prot.atoms]),
                  np.array([a.res_seq for a in prot.atoms]))
        out.append((prot.to_molecule(), parse(sdf), ctx))
    want = jcb.build_complex(*out[0], tgt_len=60, smiles=smi, props=props, seed=5)
    got = tcb.build_complex(*out[1], tgt_len=60, smiles=smi, props=props, seed=5)
    assert_batches_equal(got, want)
    assert float(got.props.vina[0]) == -7.25
    small_j, small_t = JShapes(num_protein_nodes=16), TShapes(num_protein_nodes=16)
    with pytest.raises(jcb.BucketOverflow):
        jcb.build_complex(*out[0], shapes=small_j)
    with pytest.raises(tcb.BucketOverflow):
        tcb.build_complex(*out[1], shapes=small_t)
    with pytest.raises(ValueError, match="protein context"):
        tcb.build_complex(out[1][0], out[1][1], None)


def test_pdb_protein_matches_jax(pdb_blocks):
    """Atoms, residues, the water skipped, the element guessed from the atom
    name where columns 77-78 are blank, the pocket and the re-emitted block."""
    from singa_tpu.chem.pdb import PDBProtein as JPDB
    from singa_tpu_torch.chem.pdb import PDBProtein as TPDB
    from singa_tpu_torch.chem.sdf import parse_sdf

    block, sdf = pdb_blocks["b"]
    blank = "\n".join(ln[:76] if ln.startswith("ATOM") else ln for ln in block.splitlines())
    blank += "\nATOM     99 CL1  UNK B  12       1.000   2.000   3.000\n"
    for text in (block, blank, pdb_blocks["a"][0]):
        j, t = JPDB(text), TPDB(text)
        assert [vars(a).keys() for a in t.atoms] == [vars(a).keys() for a in j.atoms]
        for ta, ja in zip(t.atoms, j.atoms):
            assert (ta.serial, ta.name, ta.res_name, ta.chain, ta.res_seq, ta.element, ta.line) == (
                ja.serial, ja.name, ja.res_name, ja.chain, ja.res_seq, ja.element, ja.line)
            np.testing.assert_array_equal(ta.pos, ja.pos)
        assert [(r.name, r.chain, r.seq, r.atom_indices) for r in t.residues] == [
            (r.name, r.chain, r.seq, r.atom_indices) for r in j.residues]
        np.testing.assert_array_equal(t.atomic_num, j.atomic_num)
        np.testing.assert_array_equal(t.center_of_mass(), j.center_of_mass())
        lig = parse_sdf(pdb_blocks["a"][1] if text is pdb_blocks["a"][0] else sdf).pos
        for radius in (4.0, 10.0):
            tres, jres = t.query_residues_ligand(lig, radius), j.query_residues_ligand(lig, radius)
            assert [r.atom_indices for r in tres] == [r.atom_indices for r in jres]
            assert t.residues_to_pdb_block(tres) == j.residues_to_pdb_block(jres)
            (tm, ti), (jm, ji) = t.pocket(lig, radius), j.pocket(lig, radius)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm.bonds, jm.bonds)
            assert tm.rings == jm.rings
        for crit in ("center_of_mass", "any"):
            assert [r.seq for r in t.query_residues_radius(lig[0], 6.0, crit)] == [
                r.seq for r in j.query_residues_radius(lig[0], 6.0, crit)]
    t = TPDB(blank)
    assert t.atoms[-1].element == 17 and all(a.res_name != "HOH" for a in t.atoms)


def test_interactions_match_jax(pdb_blocks):
    """ring_geometry, protein_rings and interaction_edges on block (b)'s
    pocket, exactly."""
    from singa_tpu.chem import interactions as ji
    from singa_tpu.chem.pdb import PDBProtein as JPDB
    from singa_tpu.chem.sdf import parse_sdf as jsdf
    from singa_tpu_torch.chem import interactions as ti
    from singa_tpu_torch.chem.pdb import PDBProtein as TPDB
    from singa_tpu_torch.chem.sdf import parse_sdf as tsdf

    assert ti.PI_ATOMS == ji.PI_ATOMS and ti.HALOGENS == ji.HALOGENS
    block, sdf = pdb_blocks["b"]
    res = []
    for PDB, parse, mod in ((JPDB, jsdf, ji), (TPDB, tsdf, ti)):
        prot, lig = PDB(block), parse(sdf)
        ctx = mod.ProteinContext(np.array([a.res_name for a in prot.atoms]),
                                 np.array([a.name for a in prot.atoms]),
                                 np.array([a.res_seq for a in prot.atoms]))
        pocket = prot.to_molecule()
        res.append((mod.ring_geometry(lig), mod.ring_geometry(lig, aromatic_only=False),
                    mod.protein_rings(ctx, pocket.pos), mod.interaction_edges(pocket, lig, ctx),
                    mod.interaction_edges(pocket, lig, ctx, cutoff=5.0)))
    for want, got in zip(*res):
        for w, g in zip(want, got):
            if isinstance(w, list):
                assert g == w
            else:
                np.testing.assert_array_equal(g, w)
