"""Edge gather/scatter/softmax over padded edge lists (counterpart of
``singa_tpu/ops/neighbors.py``).

The JAX package contracts one-hot incidence matrices on the TPU's matrix
unit. Here a gather is an ``index_select`` and a scatter is a sum over the
host-built destination table ``edge_of[dst, k] -> edge id``: K row gathers
accumulated in a fixed order, so the result is deterministic and needs no
atomics. The sentinel id (one past the last edge) reads a zero row, and
padded edges are masked, so padded edges and nodes give exact zeros.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def build_dst_table(
    dst: np.ndarray, mask: np.ndarray, n_dst: int, k_max: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side destination table from a padded edge list.

    Args:
      dst: [B, E] int graph-local destination of each edge slot.
      mask: [B, E] bool edge validity.
      n_dst: destination node bucket size.
      k_max: max in-degree kept per destination.

    Returns ``(edge_of [B, n_dst, k_max] int32, kept_mask [B, E], dropped)``;
    ``edge_of`` holds per-graph edge positions with sentinel ``E`` for empty
    slots. Edges beyond ``k_max`` per destination (in edge order) are dropped
    from ``kept_mask`` so table and mask stay consistent.
    """
    B, E = dst.shape
    edge_of = np.full((B, n_dst, k_max), E, np.int32)
    kept = np.array(mask, copy=True)
    dropped = 0
    eids = np.arange(E, dtype=np.int32)
    for b in range(B):
        key = np.where(mask[b], dst[b], n_dst)
        order = np.argsort(key, kind="stable")
        ds, es = key[order], eids[order]
        valid = ds < n_dst
        ds, es = ds[valid], es[valid]
        if ds.size == 0:
            continue
        starts = np.searchsorted(ds, ds, side="left")
        rank = np.arange(ds.size) - starts
        keep = rank < k_max
        if not keep.all():
            dropped += int((~keep).sum())
            kept[b, es[~keep]] = False
        edge_of[b, ds[keep], rank[keep]] = es[keep]
    return edge_of, kept, dropped


def _table_sum(v: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum edge rows into table owners: v [E, F], table [N, K] (sentinel E)
    -> [N, F], accumulated in float32 over k = 0..K-1."""
    acc_t = torch.promote_types(v.dtype, torch.float32)
    vp = torch.cat([v.to(acc_t), v.new_zeros((1, v.shape[1]), dtype=acc_t)])
    acc = vp.index_select(0, table[:, 0])
    for k in range(1, table.shape[1]):
        acc = acc + vp.index_select(0, table[:, k])
    return acc


class EdgeEngine(NamedTuple):
    """Flat-index edge operations over one merged (src-set, dst-set) pair.
    All ids are global (graph offset folded in); padded edges point at row 0
    and are masked to exact zeros."""

    src_flat: torch.Tensor  # [B*E] int64 global source row
    dst_flat: torch.Tensor  # [B*E] int64 global destination row
    mask: torch.Tensor  # [B*E] bool
    edge_of: torch.Tensor  # [B*N_dst, K] int64 global edge id, sentinel B*E

    @classmethod
    def create(
        cls,
        index: torch.Tensor,  # [B, E, 2] graph-local (src, dst)
        mask: torch.Tensor,  # [B, E]
        table: torch.Tensor,  # [B, N_dst, K] per-graph edge positions, sentinel E
        n_src: int,
        n_dst: int,
    ) -> "EdgeEngine":
        B, E, _ = index.shape
        dev = index.device
        index = index.long()
        off_src = (torch.arange(B, device=dev) * n_src)[:, None]
        off_dst = (torch.arange(B, device=dev) * n_dst)[:, None]
        zero = torch.zeros((), dtype=torch.long, device=dev)
        src = torch.where(mask, index[..., 0] + off_src, zero).reshape(-1)
        dst = torch.where(mask, index[..., 1] + off_dst, zero).reshape(-1)
        table = table.long()
        off_e = (torch.arange(B, device=dev) * E)[:, None, None]
        tbl = torch.where(table >= E, torch.full_like(table, B * E), table + off_e)
        return cls(src, dst, mask.reshape(-1), tbl.reshape(B * n_dst, -1))

    @property
    def num_dst(self) -> int:
        return self.edge_of.shape[0]

    def _gather(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        orig = x.shape[1:]
        out = x.reshape(x.shape[0], -1).index_select(0, idx)
        out = out * self.mask[:, None].to(out.dtype)
        return out.reshape((-1,) + orig)

    def gather_src(self, x: torch.Tensor) -> torch.Tensor:
        """x [B*N_src, ...] -> per-edge source rows [B*E, ...] (masked zero)."""
        return self._gather(x, self.src_flat)

    def gather_dst(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(x, self.dst_flat)

    def scatter_dst(self, m: torch.Tensor) -> torch.Tensor:
        """Sum per-edge values into destinations: [B*E, ...] -> [B*N_dst, ...],
        accumulated in float32."""
        orig = m.shape[1:]
        m2 = m.reshape(m.shape[0], -1)
        m2 = m2 * self.mask[:, None].to(m2.dtype)
        return _table_sum(m2, self.edge_of).to(m.dtype).reshape((-1,) + orig)

    def softmax_dst(self, logits: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
        """Per-destination softmax over incoming edges; logits [B*E, H].
        Stabilised with the per-destination max over the table."""
        lg = logits.to(torch.promote_types(logits.dtype, torch.float32))
        lp = torch.cat([lg, lg.new_full((1,) + lg.shape[1:], -torch.inf)])
        g = lp.index_select(0, self.edge_of.reshape(-1))
        g = g.reshape(self.num_dst, -1, *lg.shape[1:])  # [N, K, H]
        mx = g.amax(dim=1)
        mx_safe = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        mx_e = mx_safe.index_select(0, self.dst_flat)
        e = torch.exp(lg - mx_e) * self.mask[:, None].to(lg.dtype)
        dn = _table_sum(e, self.edge_of)
        dn_e = dn.index_select(0, self.dst_flat)
        alpha = e / torch.clamp(dn_e, min=eps)
        return alpha.to(logits.dtype)
