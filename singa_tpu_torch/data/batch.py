"""The fixed-shape batch contract between host featurisation and the device
(counterpart of ``singa_tpu/data/batch.py`` and the npz reader of
``singa_tpu/data/dataset.py``).

Every field is a dense padded tensor with an explicit mask. The destination
tables are built on the host in numpy, with the same per-destination edge
drops as the JAX package, and ride the batch as tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from singa_tpu_torch.config import ShapeConfig
from singa_tpu_torch.ops.neighbors import build_dst_table


class NodeSet(NamedTuple):
    x: torch.Tensor  # [B, N, F] float32 node features
    pos: torch.Tensor  # [B, N, 3] float32
    atomic_num: torch.Tensor  # [B, N] int32
    mask: torch.Tensor  # [B, N] bool
    lap_pe: torch.Tensor  # [B, N, K] float32 Laplacian PE (precomputed)


class EdgeSet(NamedTuple):
    index: torch.Tensor  # [B, E, 2] int32 graph-local (src, dst)
    attr: torch.Tensor  # [B, E, A] float32
    mask: torch.Tensor  # [B, E] bool


class PropertySet(NamedTuple):
    sas: torch.Tensor  # [B]
    logp: torch.Tensor
    qed: torch.Tensor
    weight: torch.Tensor
    tpsa: torch.Tensor
    vina: torch.Tensor


class TokenSet(NamedTuple):
    input: torch.Tensor  # [B, T] int32, '&' + tokens + '^' padding
    target: torch.Tensor  # [B, T] int32, tokens + '$' + '^' padding


class BatchTables(NamedTuple):
    """Destination tables of the two merged embedding stages: node index
    space is [protein(0..Np); ligand(Np..Np+Nl)], edge positions index the
    merged lists [pp; ll] (intra) and [lp; pl] (inter), sentinel = length."""

    intra: torch.Tensor  # [B, Np+Nl, K_intra] int32
    inter: torch.Tensor  # [B, Np+Nl, K_inter] int32


class ComplexBatch(NamedTuple):
    protein: NodeSet
    ligand: NodeSet
    pp: EdgeSet  # protein -> protein (covalent)
    ll: EdgeSet  # ligand  -> ligand  (covalent)
    lp: EdgeSet  # ligand  -> protein (interactions)
    pl: EdgeSet  # protein -> ligand  (interactions)
    props: PropertySet
    tokens: TokenSet
    tables: BatchTables | None = None

    @property
    def batch_size(self) -> int:
        return self.protein.x.shape[0]

    def to(self, device) -> "ComplexBatch":
        """The same batch with every tensor on ``device``."""
        return _map(lambda t: t.to(device), self)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    return type(tree)(*(_map(fn, f) for f in tree))


def attach_tables(
    batch: ComplexBatch,
    k_intra: int | None = None,
    k_inter: int | None = None,
    shapes: ShapeConfig | None = None,
) -> ComplexBatch:
    """Compute the merged destination tables on the host and attach them.

    Edges beyond the per-destination cap are dropped, by destination and by
    source (the masks of the returned batch say which), exactly as the JAX
    package drops them, so that both see the same edge set.
    """
    shapes = shapes or ShapeConfig()
    k_intra = k_intra or shapes.max_in_degree_intra
    k_inter = k_inter or shapes.max_in_degree_inter

    n_p = batch.protein.x.shape[1]
    n_l = batch.ligand.x.shape[1]
    n_c = n_p + n_l
    host = lambda t: t.detach().cpu().numpy()
    pp_i, ll_i = host(batch.pp.index), host(batch.ll.index)
    lp_i, pl_i = host(batch.lp.index), host(batch.pl.index)

    # merged layouts must mirror EquivariantEmbedding.forward
    intra_dst = np.concatenate([pp_i[..., 1], ll_i[..., 1] + n_p], axis=1)
    intra_src = np.concatenate([pp_i[..., 0], ll_i[..., 0] + n_p], axis=1)
    intra_mask = np.concatenate([host(batch.pp.mask), host(batch.ll.mask)], axis=1)
    inter_dst = np.concatenate([lp_i[..., 1], pl_i[..., 1] + n_p], axis=1)
    inter_src = np.concatenate([lp_i[..., 0] + n_p, pl_i[..., 0]], axis=1)
    inter_mask = np.concatenate([host(batch.lp.mask), host(batch.pl.mask)], axis=1)

    def _dst_table(dst, src, mask, k):
        """Drops from the destination side and from the source side both
        shrink the mask (the JAX package also keeps a source table for its
        gradients), then the destination table is rebuilt on the kept set."""
        _, kept, _ = build_dst_table(dst, mask, n_c, k)
        _, kept, _ = build_dst_table(src, kept, n_c, k)
        tbl, kept2, dropped = build_dst_table(dst, kept, n_c, k)
        if dropped or not (kept2 == kept).all():
            raise RuntimeError("destination table inconsistent with its kept mask")
        return tbl, kept

    intra_tbl, intra_kept = _dst_table(intra_dst, intra_src, intra_mask, k_intra)
    inter_tbl, inter_kept = _dst_table(inter_dst, inter_src, inter_mask, k_inter)

    dev = batch.pp.mask.device
    t = lambda a: torch.as_tensor(a, device=dev)
    e_pp = pp_i.shape[1]
    e_lp = lp_i.shape[1]
    return batch._replace(
        pp=batch.pp._replace(mask=t(intra_kept[:, :e_pp])),
        ll=batch.ll._replace(mask=t(intra_kept[:, e_pp:])),
        lp=batch.lp._replace(mask=t(inter_kept[:, :e_lp])),
        pl=batch.pl._replace(mask=t(inter_kept[:, e_lp:])),
        tables=BatchTables(intra=t(intra_tbl), inter=t(inter_tbl)),
    )


_NODE_FIELDS = ("x", "pos", "atomic_num", "mask", "lap_pe")
_EDGE_FIELDS = ("index", "attr", "mask")
_PROP_FIELDS = ("sas", "logp", "qed", "weight", "tpsa", "vina")
_TOKEN_FIELDS = ("input", "target")


def stack(files: Sequence[dict]) -> ComplexBatch:
    """Stack unbatched complexes (dicts of numpy arrays, the ETL's ``.npz``
    keys) into one CPU batch with its destination tables attached."""

    def st(key):
        return torch.as_tensor(np.stack([np.asarray(f[key]) for f in files]))

    batch = ComplexBatch(
        protein=NodeSet(*[st(f"protein.{f}") for f in _NODE_FIELDS]),
        ligand=NodeSet(*[st(f"ligand.{f}") for f in _NODE_FIELDS]),
        pp=EdgeSet(*[st(f"pp.{f}") for f in _EDGE_FIELDS]),
        ll=EdgeSet(*[st(f"ll.{f}") for f in _EDGE_FIELDS]),
        lp=EdgeSet(*[st(f"lp.{f}") for f in _EDGE_FIELDS]),
        pl=EdgeSet(*[st(f"pl.{f}") for f in _EDGE_FIELDS]),
        props=PropertySet(*[st(f"props.{f}") for f in _PROP_FIELDS]),
        tokens=TokenSet(*[st(f"tokens.{f}") for f in _TOKEN_FIELDS]),
    )
    return attach_tables(batch)


def load_npz(paths: Sequence[str]) -> ComplexBatch:
    """Read ``.npz`` complexes and stack them into one CPU batch."""
    files = []
    for p in paths:
        with np.load(p) as z:
            files.append({k: z[k] for k in z.files})
    return stack(files)
