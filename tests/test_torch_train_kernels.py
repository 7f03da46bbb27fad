"""The backward of the port's three kernels (K1b neighbour attention, K2b gate
FFN, K3b separable S2 activation), reached through their autograd Functions
on CPU tensors (where each takes its plain backward), against the JAX
package's custom VJPs with the Pallas ``_bwd`` kernels in interpret mode.

Inputs and cotangents are random (numpy, fixed seeds), with the cases the
kernels must get right: padded nodes, a node with no live neighbour slot, a
padded node whose scores are all -1e9 (uniform softmax over masked slots), a
repeated neighbour index, ragged sizes. Float32 throughout; both sides add
the same products in another order, so gradients agree at round-off: atol
1e-4 of each gradient's largest magnitude (they are sums over up to a few
hundred O(1) terms), rtol 1e-4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import t


def _close_grads(got, want, names):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-4 * scale, rtol=1e-4, err_msg=name)


def _port_grads(fn, arrays, diff, extra, g):
    """Gradients of ``sum(fn(...) * g)`` in the inputs ``diff`` (indices
    into ``arrays``), through the port's autograd Function on the CPU."""
    ts = [t(a) for a in arrays]
    for i in diff:
        ts[i].requires_grad_()
    out = fn(*ts, *extra)
    out.backward(t(g))
    return [ts[i].grad for i in diff]


# ---------------------------------------------------------------- K3b


@pytest.mark.parametrize("lmax,mmax", [(2, 2), (6, 2)])
def test_s2_silu_sep_backward_matches_pallas(lmax, mmax):
    """dx and dscalars == the Pallas _sep_bwd (interpret mode); row 0 of the
    cotangent reaches only the scalars."""
    from singa_tpu.equivariant import layers as jl
    from singa_tpu.ops.pallas.s2_act import s2_silu_sep as pallas_sep
    from singa_tpu_torch.equivariant import layers as tl
    from singa_tpu_torch.equivariant.so3 import num_coeffs_trunc
    from singa_tpu_torch.ops.cuda import s2_act as k3

    I = num_coeffs_trunc(lmax, mmax)
    rng = np.random.default_rng(71)
    x = rng.normal(size=(19, I, 8)).astype(np.float32)
    s = rng.normal(size=(19, 8)).astype(np.float32)
    g = rng.normal(size=(19, I, 8)).astype(np.float32)
    tg, fg = tl._grid_mats_for(lmax, mmax, True)
    jtg, jfg = jl._grid_mats_for(lmax, mmax, True)
    with compute_dtype_scope("float32"):
        _, vjp = jax.vjp(lambda a, b: pallas_sep(a, b, jtg, jfg), jnp.asarray(x), jnp.asarray(s))
        want = vjp(jnp.asarray(g))
    got = _port_grads(k3.s2_silu_sep, [x, s, tg, fg], [0, 1], (), g)
    _close_grads(got, want, ["dx", "ds"])
    # the Function's backward is the plain backward, and row 0 goes to ds only
    g0 = np.zeros_like(g)
    g0[:, 0] = g[:, 0]
    dx0, ds0 = k3.s2_silu_sep_bwd_plain(t(x), t(s), t(tg), t(fg), t(g0))
    assert float(dx0.abs().max()) == 0.0 and float(ds0.abs().max()) > 0.0


# ---------------------------------------------------------------- K2b


@pytest.mark.parametrize("lmax,N", [(2, 13), (6, 5)])
def test_gate_ffn_backward_matches_pallas(lmax, N):
    """dx and the six weight/bias gradients == the Pallas _gate_bwd
    (interpret mode)."""
    from singa_tpu.ops.pallas.so3_ffn import so3_gate_ffn_fused
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    C, H, Co = 4, 24, 4
    L = lmax + 1
    rng = np.random.default_rng(73 + lmax)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    arrays = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
              0.1 * f(lmax * H), 0.1 * f(L, H, Co), 0.1 * f(Co)]
    g = f(N, L * L, Co)
    with compute_dtype_scope("float32"):
        _, vjp = jax.vjp(lambda *a: so3_gate_ffn_fused(*a, lmax, True), *map(jnp.asarray, arrays))
        want = vjp(jnp.asarray(g))
    got = _port_grads(k2.so3_gate_ffn, arrays, range(7), (lmax,), g)
    _close_grads(got, want, ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"])


# ---------------------------------------------------------------- K1b


def _attn_case(rng, B=2, N=16, K=7, H=2, kd=8, vd=8, De=8):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    nbr = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    nbr[0, 2, :4] = 9  # a repeated neighbour index
    mask = rng.random((B, N, K)) > 0.3
    mask[0, 3] = False  # no live slot, finite self score
    ds = f(B, N, H)
    mask[1, N - 3 :] = False  # padded nodes: every score -1e9, the self slot too
    ds[1, N - 3 :] = -1e9
    nbr[1, N - 3 :] = np.arange(K)  # as top_k of an all-zero adjacency row
    arrays = [
        f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd), nbr, mask,
        rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * vd),
        np.linspace(0.0, 15.0, De, dtype=np.float32),
        0.3 * f(De, kd), 0.1 * f(kd), 0.3 * f(kd, kd), 0.1 * f(kd),
        0.3 * f(De, vd), 0.1 * f(vd), 0.3 * f(vd, vd), 0.1 * f(vd),
    ]
    width = 15.0 / (De - 1)
    return arrays, -0.5 / (width * width), f(B, N, H * vd)


DIFF = [0, 1, 2, 6, 7, *range(9, 17)]
NAMES = ["dqt", "dk", "dv", "d diag_scores", "d diag_value", "dwk1", "dbk1", "dwk2", "dbk2",
         "dwv1", "dbv1", "dwv2", "dbv2"]


def test_neighbor_attn_backward_matches_pallas():
    """Every gradient == the Pallas _bwd (interpret mode), whose dk/dv are
    the one-hot transpose over every slot: the padded nodes' uniform softmax
    sends dv through their masked slots at a random cotangent."""
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_fused
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    arrays, coeff, g = _attn_case(np.random.default_rng(79))
    fixed = {i: jnp.asarray(a) for i, a in enumerate(arrays) if i not in DIFF}

    def jfn(*diff):
        full = dict(fixed)
        full.update(zip(DIFF, diff))
        return neighbor_attn_fused(*(full[i] for i in range(17)), coeff, True)

    with compute_dtype_scope("float32"):
        _, vjp = jax.vjp(jfn, *(jnp.asarray(arrays[i]) for i in DIFF))
        want = vjp(jnp.asarray(g))
    got = _port_grads(k1.neighbor_attn, arrays, DIFF, (coeff, *k1.transpose_slots(t(arrays[3]))), g)
    _close_grads(got, want, NAMES)
    # the padded nodes' masked slots carried dv to rows 0..K-1
    assert float(got[2][1, :7].abs().max()) > 0.0


def test_transpose_slots_is_the_csr_transpose_of_nbr():
    """K1b's dk/dv gather reads, for each row j of each graph, the flat slots
    (i, p) with nbr[i, p] == j in ascending order: every slot once, masked
    ones and repeated neighbours included, whatever the symmetry of nbr."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    arrays, _, _ = _attn_case(np.random.default_rng(89))
    nbr = arrays[3]
    B, N, K = nbr.shape
    offsets, slots = (a.numpy() for a in k1.transpose_slots(t(nbr)))
    assert offsets.dtype == slots.dtype == np.int32
    assert offsets.shape == (B * N + 1,) and offsets[0] == 0 and offsets[-1] == B * N * K
    for b in range(B):
        for j in range(N):
            want = [b * N * K + s for s in range(N * K) if nbr[b].reshape(-1)[s] == j]
            row = b * N + j
            assert slots[offsets[row]:offsets[row + 1]].tolist() == want, (b, j)


def test_backward_functions_give_no_gradient_to_indices_and_constants():
    """Through the Functions, nbr/nbr_mask/dist/centers (K1) and the grid
    matrices (K3) get no gradient, as in the JAX custom VJPs; on CPU tensors
    no kernel launches, forward or backward."""
    from singa_tpu_torch.equivariant import layers as tl
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import s2_act as k3
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    before = (k1.launches_bwd, k2.launches_bwd, k3.launches_bwd)
    arrays, coeff, g = _attn_case(np.random.default_rng(83))
    ts = [t(a) for a in arrays]
    for i in (5, 8):  # dist, centers: floating inputs that get no gradient
        ts[i].requires_grad_()
    for i in DIFF:
        ts[i].requires_grad_()
    k1.neighbor_attn(*ts, coeff, *k1.transpose_slots(ts[3])).backward(t(g))
    assert ts[5].grad is None and ts[8].grad is None
    assert all(ts[i].grad is not None for i in DIFF)

    tg, fg = (t(m).requires_grad_() for m in tl._grid_mats_for(2, 2, True))
    x = t(np.ones((3, tg.shape[1], 4), np.float32)).requires_grad_()
    s = t(np.ones((3, 4), np.float32)).requires_grad_()
    k3.s2_silu_sep(x, s, tg, fg).sum().backward()
    assert tg.grad is None and fg.grad is None and x.grad is not None and s.grad is not None
    assert (k1.launches_bwd, k2.launches_bwd, k3.launches_bwd) == before
