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

from singa_tpu_torch.config import EOS_TOKEN, PAD_TOKEN, SOS_TOKEN, ShapeConfig
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

    def to(self, device, non_blocking: bool = False) -> "ComplexBatch":
        """The same batch with every tensor on ``device``."""
        return _map(lambda t: t.to(device, non_blocking=non_blocking), self)

    def rows(self, start: int, stop: int) -> "ComplexBatch":
        """Graphs ``start .. stop-1`` (every field has the batch axis first)."""
        return _map(lambda t: t[start:stop], self)

    def pin_memory(self) -> "ComplexBatch":
        """The same CPU batch in page-locked memory (for async copies)."""
        return _map(lambda t: t.pin_memory(), self)


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


def synthetic_batch(
    seed: int,
    batch_size: int,
    shapes: ShapeConfig | None = None,
    tgt_len: int = 200,
    vocab_size: int = 116,
) -> ComplexBatch:
    """A geometrically plausible random CPU batch (tests and smoke training),
    drawn exactly as ``singa_tpu.data.batch.synthetic_batch`` draws it, so the
    same seed gives the same batch in both packages.

    Node counts vary per graph; positions are packed points; edges have
    bounded in-degree, so degree statistics resemble the featurizer's."""
    rng = np.random.default_rng(seed)
    s = shapes or ShapeConfig()

    def nodes(nmax, lo, hi):
        counts = rng.integers(lo, hi + 1, size=batch_size)
        mask = np.arange(nmax)[None, :] < counts[:, None]
        pos = rng.normal(size=(batch_size, nmax, 3)).astype(np.float32) * 4.0
        x = np.zeros((batch_size, nmax, s.node_feat_dim), dtype=np.float32)
        elem = rng.choice([1, 6, 7, 8, 16], size=(batch_size, nmax))
        onehot_idx = rng.integers(0, 44, size=(batch_size, nmax))
        for b in range(batch_size):
            x[b, np.arange(nmax), onehot_idx[b]] = 1.0
        x[:, :, 44:] = rng.integers(0, 2, size=(batch_size, nmax, s.node_feat_dim - 44))
        x *= mask[..., None]
        lap = (rng.normal(size=(batch_size, nmax, s.lap_dim)) * mask[..., None]).astype(np.float32)
        return x, pos.astype(np.float32), (elem * mask).astype(np.int32), mask, lap, counts

    def edges(emax, counts, attr_dim, counts_dst=None, max_in_degree=6):
        idx = np.zeros((batch_size, emax, 2), dtype=np.int32)
        attr = rng.normal(size=(batch_size, emax, attr_dim)).astype(np.float32)
        mask = np.zeros((batch_size, emax), dtype=bool)
        for b in range(batch_size):
            n_src = counts[b]
            n_dst = counts_dst[b] if counts_dst is not None else n_src
            ne = min(emax, int(1.8 * min(n_src, n_dst)))
            pool = np.tile(np.arange(n_dst), max_in_degree)
            rng.shuffle(pool)
            dst = pool[:ne]
            src = rng.integers(0, n_src, size=ne)
            if counts_dst is None:  # no zero-length self-loop vectors
                src = np.where(src == dst, (src + 1) % n_src, src)
            idx[b, :ne, 0] = src
            idx[b, :ne, 1] = dst
            mask[b, :ne] = True
        attr *= mask[..., None]
        return idx, attr, mask

    P, L = s.num_protein_nodes, s.num_ligand_nodes
    px, ppos, pel, pmask, plap, pcnt = nodes(P, P // 2, P)
    lx, lpos, lel, lmask, llap, lcnt = nodes(L, max(6, L // 3), L)
    ppi, ppa, ppm = edges(s.num_pp_edges, pcnt, 6)
    lli, lla, llm = edges(s.num_ll_edges, lcnt, 6)
    lpi, lpa, lpm = edges(s.num_lp_edges, lcnt, 11, pcnt)
    pli, pla, plm = edges(s.num_pl_edges, pcnt, 11, lcnt)

    # tokens: '&' + body + '$' (in the target) + '^' padding
    tok_in = np.full((batch_size, tgt_len), PAD_TOKEN, dtype=np.int32)
    tok_tgt = np.full((batch_size, tgt_len), PAD_TOKEN, dtype=np.int32)
    for b in range(batch_size):
        n = int(rng.integers(10, min(60, tgt_len - 2)))
        body = rng.integers(3, vocab_size, size=n)
        tok_in[b, 0] = SOS_TOKEN
        tok_in[b, 1 : n + 1] = body
        tok_tgt[b, :n] = body
        tok_tgt[b, n] = EOS_TOKEN

    t = torch.as_tensor
    u = lambda lo, hi: t(rng.uniform(lo, hi, batch_size).astype(np.float32))
    batch = ComplexBatch(
        protein=NodeSet(t(px), t(ppos), t(pel), t(pmask), t(plap)),
        ligand=NodeSet(t(lx), t(lpos), t(lel), t(lmask), t(llap)),
        pp=EdgeSet(t(ppi), t(ppa), t(ppm)),
        ll=EdgeSet(t(lli), t(lla), t(llm)),
        lp=EdgeSet(t(lpi), t(lpa), t(lpm)),
        pl=EdgeSet(t(pli), t(pla), t(plm)),
        props=PropertySet(
            sas=u(1, 8), logp=u(-2, 6), qed=u(0, 1), weight=u(150, 600), tpsa=u(10, 150),
            vina=u(-12, -3),
        ),
        tokens=TokenSet(t(tok_in), t(tok_tgt)),
    )
    return attach_tables(batch, shapes=shapes)
