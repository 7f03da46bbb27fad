"""PyTorch port vs the JAX package: the batch contract and the edge engine."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import close, jax_batch, load_val, t, torch_batch


def _flat(batch):
    """{name: numpy array} over every field of a ComplexBatch (either package)."""
    out = {}
    for group in ("protein", "ligand", "pp", "ll", "lp", "pl", "props", "tokens"):
        g = getattr(batch, group)
        for f in g._fields:
            out[f"{group}.{f}"] = np.asarray(getattr(g, f))
    out["tables.intra"] = np.asarray(batch.tables.intra)
    out["tables.inter"] = np.asarray(batch.tables.inter)
    return out


@pytest.mark.parametrize("start,n", [(0, 4), (20, 3)])
def test_load_npz_equals_jax_stack(start, n):
    """load_npz + attach_tables on val pockets give every array, both
    destination tables and the kept edge masks of singa_tpu's _stack."""
    from test_torch_common import VAL_FILES

    from singa_tpu_torch.data.batch import load_npz

    ref = _flat(jax_batch(load_val(n, start)))
    got = load_npz(VAL_FILES[start : start + n])
    assert got.batch_size == n
    assert isinstance(got.pp.index, torch.Tensor) and isinstance(got.tables.intra, torch.Tensor)
    flat = _flat(got)
    assert flat.keys() == ref.keys()
    for k in ref:
        assert flat[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)


def test_attach_tables_drops_like_jax_over_cap():
    """With caps small enough to overflow, the port drops exactly the edges
    the JAX package drops (destination- and source-side)."""
    from singa_tpu.data.batch import attach_tables as jattach
    from singa_tpu_torch.data.batch import attach_tables as tattach

    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)
    ja = jattach(jb, k_intra=2, k_inter=3)
    ta = tattach(tb, k_intra=2, k_inter=3)
    assert not np.array_equal(np.asarray(ja.pp.mask), np.asarray(jb.pp.mask))  # it overflowed
    for name in ("pp", "ll", "lp", "pl"):
        np.testing.assert_array_equal(
            getattr(ta, name).mask.numpy(), np.asarray(getattr(ja, name).mask), err_msg=name
        )
    np.testing.assert_array_equal(ta.tables.intra.numpy(), np.asarray(ja.tables.intra))
    np.testing.assert_array_equal(ta.tables.inter.numpy(), np.asarray(ja.tables.inter))


def test_batch_to_moves_every_tensor():
    b = torch_batch(load_val(1)).to("meta")
    assert b.protein.x.device.type == "meta" and b.tables.inter.device.type == "meta"


def _engines():
    """JAX and port EdgeEngines over the merged intra edge set of 2 pockets."""
    from singa_tpu.ops.neighbors import EdgeEngine as JE
    from singa_tpu_torch.ops.neighbors import EdgeEngine as TE

    files = load_val(2, 10)
    jb, tb = jax_batch(files), torch_batch(files)
    n_p = jb.protein.x.shape[1]
    n_c = n_p + jb.ligand.x.shape[1]
    j_idx = jnp.concatenate([jb.pp.index, jb.ll.index + n_p], axis=1)
    j_mask = jnp.concatenate([jb.pp.mask, jb.ll.mask], axis=1)
    je = JE.create(j_idx, j_mask, jb.tables.intra, n_c, n_c, src_table=jb.tables.intra_src)
    t_idx = torch.cat([tb.pp.index, tb.ll.index + n_p], dim=1)
    t_mask = torch.cat([tb.pp.mask, tb.ll.mask], dim=1)
    te = TE.create(t_idx, t_mask, tb.tables.intra, n_c, n_c)
    return je, te, 2 * n_c, np.asarray(j_mask).reshape(-1)


def test_edge_engine_matches_jax_with_exact_zeros():
    """gather_src/gather_dst/scatter_dst/softmax_dst equal JAX's; padded
    edges gather exact zeros, nodes without in-edges scatter exact zeros,
    and padded edges get softmax weight exactly 0 (never NaN)."""
    je, te, n_nodes, emask = _engines()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n_nodes, 9, 4)).astype(np.float32)
    for name in ("gather_src", "gather_dst"):
        got = getattr(te, name)(t(x))
        close(got, getattr(je, name)(jnp.asarray(x)), 0.0, 0.0, name)  # a gather is exact
        assert (got.numpy()[~emask] == 0).all()

    m = rng.normal(size=(emask.size, 9, 4)).astype(np.float32)
    m[~emask] = 1e6  # garbage in padded edges must not leak
    got = te.scatter_dst(t(m))
    # atol 1e-5: the two sum the same <= 8 rows per node in another order
    close(got, je.scatter_dst(jnp.asarray(m)), 1e-5, 1e-6, "scatter_dst")
    indeg = np.zeros(n_nodes)
    np.add.at(indeg, te.dst_flat.numpy()[emask], 1)
    assert (got.numpy()[indeg == 0] == 0).all()

    lg = rng.normal(size=(emask.size, 3)).astype(np.float32) * 4
    a = te.softmax_dst(t(lg))
    close(a, je.softmax_dst(jnp.asarray(lg)), 1e-6, 1e-5, "softmax_dst")
    assert np.isfinite(a.numpy()).all() and (a.numpy()[~emask] == 0).all()
