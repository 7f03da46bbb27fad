"""The port's three kernels (K1 neighbour attention, K2 gate FFN, K3
separable S2 activation): each plain PyTorch version against the JAX XLA
path and against the Pallas kernel in interpret mode; the dispatching
wrappers; the kNN graph construction. The CUDA kernels themselves are held to
their plain versions on the card by ``test_torch_cuda.py``.

Tolerances: float32 throughout; the two sides sum the same products in a
different order, so agreement is at round-off (rtol 1e-5, atol sized by the
magnitude of the outputs as stated per test).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import close, load_val, t


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("lmax,mmax", [(2, 2), (6, 2)])
def test_s2_silu_sep_plain_matches_jax(lmax, mmax):
    """K3 plain == layers.separable_s2_activation (XLA, m-primary) and ==
    the Pallas s2_silu_sep kernel in interpret mode."""
    from singa_tpu.equivariant import layers as jl
    from singa_tpu.ops.pallas.s2_act import s2_silu_sep as pallas_sep
    from singa_tpu_torch.equivariant import layers as tl
    from singa_tpu_torch.equivariant.so3 import num_coeffs_trunc
    from singa_tpu_torch.ops.cuda.s2_act import s2_silu_sep_plain

    I = num_coeffs_trunc(lmax, mmax)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(24, I, 8)).astype(np.float32)
    s = rng.normal(size=(24, 8)).astype(np.float32)
    tg, fg = tl._grid_mats_for(lmax, mmax, True)
    got = s2_silu_sep_plain(t(x), t(s), t(tg), t(fg))
    with compute_dtype_scope("float32"):
        xla = jl.separable_s2_activation(jnp.asarray(s), jnp.asarray(x), lmax, mmax, m_primary=True)
        jtg, jfg = jl._grid_mats_for(lmax, mmax, True)
        pal = pallas_sep(jnp.asarray(x), jnp.asarray(s), jtg, jfg)
    # atol 2e-5: outputs are O(1) sums over G <= 70 grid points
    close(got, xla, 2e-5, 1e-5, "vs XLA")
    close(got, pal, 2e-5, 1e-5, "vs Pallas")
    # the module-level function dispatches to the plain version on the CPU
    close(tl.separable_s2_activation(t(s), t(x), lmax, mmax, m_primary=True), got, 0, 0)


# ---------------------------------------------------------------- K2


def _gate_ffn_params(rng, lmax, C, H, Co):
    L = lmax + 1
    return {
        "w1": (0.3 * rng.normal(size=(L, H, C))).astype(np.float32),
        "b1": (0.1 * rng.normal(size=(H,))).astype(np.float32),
        "w2": (0.1 * rng.normal(size=(L, Co, H))).astype(np.float32),
        "b2": (0.1 * rng.normal(size=(Co,))).astype(np.float32),
        "gate_kernel": (0.3 * rng.normal(size=(C, lmax * H))).astype(np.float32),
        "gate_bias": (0.1 * rng.normal(size=(lmax * H,))).astype(np.float32),
    }


@pytest.mark.parametrize("lmax", [2, 6])
def test_gate_ffn_plain_matches_jax(lmax):
    """K2 plain == the XLA gate path of FeedForwardNetwork and == the Pallas
    so3_gate_ffn_fused kernel in interpret mode; the port's module with the
    same parameters gives the same output."""
    from singa_tpu.equivariant.attention import FeedForwardNetwork as JFFN
    from singa_tpu.ops.pallas.so3_ffn import so3_gate_ffn_fused
    from singa_tpu_torch.equivariant.attention import FeedForwardNetwork as TFFN
    from singa_tpu_torch.ops.cuda.so3_ffn import so3_gate_ffn_plain
    from singa_tpu_torch.params import load_flax_params

    C, H, Co, N = 4, 48, 4, 20
    rng = np.random.default_rng(23)
    p = _gate_ffn_params(rng, lmax, C, H, Co)
    x = rng.normal(size=(N, (lmax + 1) ** 2, C)).astype(np.float32)
    w1t = np.ascontiguousarray(np.swapaxes(p["w1"], 1, 2))
    w2t = np.ascontiguousarray(np.swapaxes(p["w2"], 1, 2))
    got = so3_gate_ffn_plain(
        t(x), t(w1t), t(p["b1"]), t(p["gate_kernel"]), t(p["gate_bias"]), t(w2t), t(p["b2"]), lmax
    )
    with compute_dtype_scope("float32"):
        jffn = JFFN(hidden_channels=H, output_channels=Co, lmax=lmax, activation="gate")
        xla = jffn.apply({"params": p}, jnp.asarray(x))
        pal = so3_gate_ffn_fused(
            jnp.asarray(x), jnp.asarray(w1t), jnp.asarray(p["b1"]), jnp.asarray(p["gate_kernel"]),
            jnp.asarray(p["gate_bias"]), jnp.asarray(w2t), jnp.asarray(p["b2"]), lmax, True,
        )
    # atol 2e-5: O(1) outputs of two chained C=4 / H=48 contractions
    close(got, xla, 2e-5, 1e-5, "vs XLA")
    close(got, pal, 2e-5, 1e-5, "vs Pallas")
    mod = TFFN(C, H, Co, lmax, device="cpu")
    load_flax_params(mod, p)
    close(mod(t(x)), got, 0, 0, "module")


# ---------------------------------------------------------------- K1


def _attn_inputs(rng, B=2, N=20, K=8, H=2, kd=8, vd=8, De=8):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    nbr = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    nbr_mask = rng.random((B, N, K)) > 0.3
    nbr_mask[0, 3] = False  # a node with no neighbours
    return dict(
        qt=f(B, N, H * kd), k=f(B, N, H * kd), v=f(B, N, H * vd), nbr=nbr,
        nbr_mask=nbr_mask, dist=rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32),
        diag_scores=f(B, N, H), diag_value=f(B, N, H * vd),
        centers=np.linspace(0.0, 15.0, De, dtype=np.float32),
        wk1=0.3 * f(De, kd), bk1=0.1 * f(kd), wk2=0.3 * f(kd, kd), bk2=0.1 * f(kd),
        wv1=0.3 * f(De, vd), bv1=0.1 * f(vd), wv2=0.3 * f(vd, vd), bv2=0.1 * f(vd),
    )


def test_neighbor_attn_plain_matches_pallas_interpret():
    """K1 plain == neighbor_attn_fused (Pallas, interpret mode), including a
    node whose neighbour slots are all masked."""
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_fused
    from singa_tpu_torch.ops.cuda.neighbor_attn import neighbor_attn_plain

    inp = _attn_inputs(np.random.default_rng(31))
    width = 15.0 / (8 - 1)
    coeff = -0.5 / (width * width)
    got = neighbor_attn_plain(*(t(v) for v in inp.values()), coeff)
    with compute_dtype_scope("float32"):
        pal = neighbor_attn_fused(*(jnp.asarray(v) for v in inp.values()), coeff, True)
    # atol 2e-5: aggregates of O(1) values over K+1 = 9 slots
    close(got, pal, 2e-5, 1e-5)


def _mha_setup(seed=0, B=2, N=20, C=16, knn=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    pos = (3.0 * rng.normal(size=(B, N, 3))).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, N - 5 :] = False  # padded nodes
    return x, pos, mask, knn


def test_neighbor_graph_mha_matches_jax_xla():
    """NeighborGraphMHA on the CPU (K1's plain version) == the unfused XLA
    NeighborGraphMHA of the JAX package with the same (bridged) weights."""
    from singa_tpu.models.neighbor_graph import NeighborGraphMHA as JMHA
    from singa_tpu.models.neighbor_graph import build_neighbor_graph as jbuild
    from singa_tpu_torch.models.neighbor_graph import NeighborGraphMHA as TMHA
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph as tbuild
    from singa_tpu_torch.params import load_flax_params

    x, pos, mask, knn = _mha_setup()
    C, H, EDGE, STOP = x.shape[2], 2, 8, 15.0
    with compute_dtype_scope("float32"):
        jg = jbuild(jnp.asarray(pos), jnp.asarray(mask), knn, STOP, EDGE)
        jm = JMHA(hidden_channels=C, key_channels=16, num_heads=H, edge_channels=EDGE, smear_stop=STOP)
        params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jg)
        want = jm.apply(params, jnp.asarray(x), jg)
    tm = TMHA(C, 16, H, EDGE, STOP, device="cpu")
    load_flax_params(tm, params)
    tg = tbuild(t(pos), t(mask), knn, STOP, EDGE)
    with torch.no_grad():
        got = tm(t(x), tg)
    # atol 1e-5 on LayerNorm'd O(1) outputs
    close(got, want, 1e-5, 1e-5)
    assert (got.numpy()[~mask] == 0).all()


def _graph_fields(g):
    return {f: np.asarray(getattr(g, f)) for f in ("nbr", "nbr_mask", "dist", "deg_attr")}


def _check_graph(pos, mask, k, k_in=None):
    from singa_tpu.models.neighbor_graph import build_neighbor_graph as jbuild
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph as tbuild

    with compute_dtype_scope("float32"):
        want = _graph_fields(jbuild(jnp.asarray(pos), jnp.asarray(mask), k, 15.0, 64, k_in=k_in))
    got = {f: v for f, v in _graph_fields(tbuild(t(pos), t(mask), k, 15.0, 64, k_in=k_in)).items()}
    np.testing.assert_array_equal(got["nbr"], want["nbr"])
    np.testing.assert_array_equal(got["nbr_mask"], want["nbr_mask"])
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["deg_attr"], want["deg_attr"], rtol=1e-5, atol=1e-5)
    return got


def test_build_neighbor_graph_matches_jax_on_real_pocket():
    """kNN lists (k = 48, K = 96) on two val pockets equal JAX's exactly."""
    files = load_val(2, 30)
    pos = np.stack([f["protein.pos"] for f in files])
    mask = np.stack([f["protein.mask"] for f in files])
    _check_graph(pos, mask, 48)


def test_build_neighbor_graph_ties_and_overflow():
    """Lattice coordinates (many tied distances at the k-th neighbour) and
    in-degrees above K: the port keeps the same neighbours in the same order."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3), indexing="ij"), -1)
    pos = np.stack([g.reshape(-1, 3), g.reshape(-1, 3)[::-1]]).astype(np.float32) * 1.5
    mask = np.ones(pos.shape[:2], bool)
    mask[1, -4:] = False
    got = _check_graph(pos, mask, 5, k_in=6)
    assert got["nbr_mask"].all(axis=-1).any()  # some lists are full: overflow happened


# ---------------------------------------------------------------- wrappers


def test_wrappers_dispatch_plain_on_cpu_and_refuse_other_devices():
    """On CPU tensors every wrapper returns its plain version's result and
    launches nothing; on another device it raises instead of falling back."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import s2_act as k3
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    rng = np.random.default_rng(3)
    before = (k1.launches, k2.launches, k3.launches)
    inp = [t(v) for v in _attn_inputs(rng).values()]
    close(k1.neighbor_attn(*inp, -0.1), k1.neighbor_attn_plain(*inp, -0.1), 0, 0)
    p = _gate_ffn_params(rng, 2, 4, 8, 4)
    args = [t(rng.normal(size=(5, 9, 4)).astype(np.float32)),
            t(np.swapaxes(p["w1"], 1, 2).copy()), t(p["b1"]), t(p["gate_kernel"]),
            t(p["gate_bias"]), t(np.swapaxes(p["w2"], 1, 2).copy()), t(p["b2"])]
    close(k2.so3_gate_ffn(*args, 2), k2.so3_gate_ffn_plain(*args, 2), 0, 0)
    x, s = t(rng.normal(size=(6, 9, 4)).astype(np.float32)), t(rng.normal(size=(6, 4)).astype(np.float32))
    tg, fg = t(rng.normal(size=(20, 9)).astype(np.float32)), t(rng.normal(size=(20, 9)).astype(np.float32))
    close(k3.s2_silu_sep(x, s, tg, fg), k3.s2_silu_sep_plain(x, s, tg, fg), 0, 0)
    assert (k1.launches, k2.launches, k3.launches) == before
    with pytest.raises(ValueError):
        k3.s2_silu_sep(x.to("meta"), s.to("meta"), tg.to("meta"), fg.to("meta"))
