"""Host-side featurization: raw structures -> one fixed-shape ComplexBatch
(counterpart of ``singa_tpu/data/complex_builder.py``).

The glue between ``singa_tpu_torch.chem`` and the batch contract: the
re-design of the reference's Featuriser.create_pyg_graph + MakeGraph.py flow
(reference utils/Featuriser.py:73-166, MakeGraph.py:75-149). Laplacian
positional encodings are computed here, once, instead of per-forward through
DGL (reference model/CProMG.py:562-571). The arrays are the JAX package's;
they become CPU tensors, and the port's ``attach_tables`` drops the same
edges over the in-degree caps.

Generation note: for protein-only batches the reference switches to an 8-NN
graph (gen.py:135-149) while training uses covalent bonds; covalent bonds are
kept in both paths for train/serve consistency (deliberate deviation, as in
the JAX package).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from singa_tpu_torch.chem.featurize import atom_features, bond_features
from singa_tpu_torch.chem.interactions import ProteinContext, interaction_edges
from singa_tpu_torch.chem.mol import Molecule
from singa_tpu_torch.chem.pdb import PDBProtein
from singa_tpu_torch.chem.sdf import parse_sdf
from singa_tpu_torch.chem.tokenizer import encode
from singa_tpu_torch.config import PAD_TOKEN, ShapeConfig
from singa_tpu_torch.data.batch import (
    ComplexBatch,
    EdgeSet,
    NodeSet,
    PropertySet,
    TokenSet,
    attach_tables,
)
from singa_tpu_torch.ops.laplacian import laplacian_pe_numpy


class BucketOverflow(ValueError):
    """Raised when a complex exceeds the configured padding buckets."""


def _pad_nodes(mol: Molecule, n_max: int, lap_dim: int, lap_rng) -> dict:
    n = mol.num_atoms
    if n > n_max:
        raise BucketOverflow(f"{n} atoms > bucket {n_max}")
    x = np.zeros((n_max, 59), np.float32)
    pos = np.zeros((n_max, 3), np.float32)
    z = np.zeros((n_max,), np.int32)
    mask = np.zeros((n_max,), bool)
    lap = np.zeros((n_max, lap_dim), np.float32)
    x[:n] = atom_features(mol)
    pos[:n] = mol.pos
    z[:n] = mol.atomic_num
    mask[:n] = True
    ei, _ = bond_features(mol)
    lap[:n] = laplacian_pe_numpy(ei, n, k=lap_dim, rng=lap_rng)
    return dict(x=x, pos=pos, atomic_num=z, mask=mask, lap_pe=lap)


def _pad_edges(ei: np.ndarray, attr: np.ndarray, e_max: int, attr_dim: int) -> dict:
    e = ei.shape[1] if ei.size else 0
    if e > e_max:
        raise BucketOverflow(f"{e} edges > bucket {e_max}")
    index = np.zeros((e_max, 2), np.int32)
    a = np.zeros((e_max, attr_dim), np.float32)
    mask = np.zeros((e_max,), bool)
    if e:
        index[:e, 0] = ei[0]
        index[:e, 1] = ei[1]
        a[:e] = attr
        mask[:e] = True
    return dict(index=index, attr=a, mask=mask)


def build_complex(
    pocket: Molecule,
    ligand: Optional[Molecule],
    ctx: Optional[ProteinContext],
    shapes: ShapeConfig = ShapeConfig(),
    tgt_len: int = 200,
    smiles: Optional[str] = None,
    props: Optional[dict] = None,
    interaction_cutoff: float = 4.0,
    seed: int = 0,
) -> ComplexBatch:
    """Assemble a batch-of-1 CPU ComplexBatch with its destination tables.
    ``ligand=None`` produces the protein-only generation input (reference
    utils/gen.py path)."""
    rng = np.random.default_rng(seed)
    p_nodes = _pad_nodes(pocket, shapes.num_protein_nodes, shapes.lap_dim, rng)
    p_ei, p_attr = bond_features(pocket)
    pp = _pad_edges(np.asarray(p_ei), np.asarray(p_attr), shapes.num_pp_edges, 6)

    if ligand is not None:
        l_nodes = _pad_nodes(ligand, shapes.num_ligand_nodes, shapes.lap_dim, rng)
        l_ei, l_attr = bond_features(ligand)
        ll = _pad_edges(np.asarray(l_ei), np.asarray(l_attr), shapes.num_ll_edges, 6)
        if ctx is None:
            raise ValueError("protein context required for interaction edges")
        p2l, l2p, i_attr = interaction_edges(pocket, ligand, ctx, interaction_cutoff)
        lp = _pad_edges(l2p, i_attr, shapes.num_lp_edges, 11)
        pl = _pad_edges(p2l, i_attr, shapes.num_pl_edges, 11)
    else:
        l_nodes = dict(
            x=np.zeros((shapes.num_ligand_nodes, 59), np.float32),
            pos=np.zeros((shapes.num_ligand_nodes, 3), np.float32),
            atomic_num=np.zeros((shapes.num_ligand_nodes,), np.int32),
            mask=np.zeros((shapes.num_ligand_nodes,), bool),
            lap_pe=np.zeros((shapes.num_ligand_nodes, shapes.lap_dim), np.float32),
        )
        ll = _pad_edges(np.zeros((2, 0)), np.zeros((0, 6)), shapes.num_ll_edges, 6)
        lp = _pad_edges(np.zeros((2, 0)), np.zeros((0, 11)), shapes.num_lp_edges, 11)
        pl = _pad_edges(np.zeros((2, 0)), np.zeros((0, 11)), shapes.num_pl_edges, 11)

    if smiles is not None:
        tok_in, tok_tgt = encode(smiles, tgt_len)
    else:
        tok_in = np.full((tgt_len,), PAD_TOKEN, np.int32)
        tok_tgt = np.full((tgt_len,), PAD_TOKEN, np.int32)

    props = props or {}

    def arr1(v):
        return torch.as_tensor(np.asarray([v], np.float32))

    def b(d):
        return {k: torch.as_tensor(v[None]) for k, v in d.items()}

    batch = ComplexBatch(
        protein=NodeSet(**b(p_nodes)),
        ligand=NodeSet(**b(l_nodes)),
        pp=EdgeSet(**b(pp)),
        ll=EdgeSet(**b(ll)),
        lp=EdgeSet(**b(lp)),
        pl=EdgeSet(**b(pl)),
        props=PropertySet(
            sas=arr1(props.get("sas", 0.0)),
            logp=arr1(props.get("logp", 0.0)),
            qed=arr1(props.get("qed", 0.0)),
            weight=arr1(props.get("weight", 0.0)),
            tpsa=arr1(props.get("tpsa", 0.0)),
            vina=arr1(props.get("vina", 0.0)),
        ),
        tokens=TokenSet(torch.as_tensor(tok_in[None]), torch.as_tensor(tok_tgt[None])),
    )
    return attach_tables(batch, shapes=shapes)


def build_from_files(
    protein_pdb: str,
    ligand_sdf: Optional[str],
    shapes: ShapeConfig = ShapeConfig(),
    tgt_len: int = 200,
    pocket_radius: float = 10.0,
    props: Optional[dict] = None,
    seed: int = 0,
) -> ComplexBatch:
    """PDB (+ optional SDF) -> ComplexBatch, extracting the binding pocket."""
    prot = PDBProtein(protein_pdb)
    ligand = parse_sdf(ligand_sdf) if ligand_sdf else None
    if ligand is not None:
        residues = prot.query_residues_ligand(ligand.pos, pocket_radius)
    else:
        residues = prot.residues  # assume the input already is the pocket
    idx = np.array([i for r in residues for i in r.atom_indices], np.int64)
    pocket = prot.to_molecule(idx)
    ctx = ProteinContext(
        res_name=np.array([prot.atoms[i].res_name for i in idx]),
        atom_name=np.array([prot.atoms[i].name for i in idx]),
        res_id=np.array(
            [hash((prot.atoms[i].chain, prot.atoms[i].res_seq)) % (1 << 31) for i in idx]
        ),
    )
    # a canonical SMILES needs RDKit: the ETL passes the source's SMILES to
    # build_complex when training data needs token targets; here the tokens
    # stay PAD
    return build_complex(pocket, ligand, ctx, shapes, tgt_len, props=props, seed=seed)
