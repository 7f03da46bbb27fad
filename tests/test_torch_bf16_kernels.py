"""The bfloat16 instances of the training path's kernels (K1/K1b neighbour
attention, K2/K2b gate FFN, K3/K3b separable S2 activation), through their
autograd Functions on CPU tensors (where each takes its bfloat16 plain
twin), against the JAX package's Pallas kernels and their VJPs in interpret
mode on the same bfloat16 inputs (float32 weights, distances and self
scores, as the model passes them).

The cases are those of ``test_torch_train_kernels.py``: padded nodes, a node
with no live slot, a padded node whose scores are all -1e9, a repeated
neighbour, ragged sizes.

Tolerance (``close_bf16``): both sides round at the same points and sum in
float32 in another order, so a bfloat16 output may land one step away where
a value sits on a rounding boundary, and a sum with cancellation (dx =
tg^T h) carries such a step of a larger term: every bfloat16 element within
one bfloat16 step of the output's largest magnitude (2^-7 of it), at most 1%
of the elements unequal; float32 outputs (d diag_scores and the weight gradients) within
1e-5 of their largest magnitude. The Pallas kernels' float32 result on the
same inputs misses it by far (``test_float32_results_fail_the_bf16_tolerance``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_train_kernels import DIFF, NAMES, _attn_case

BF = jnp.bfloat16
STEP = 2.0 ** -7  # one bfloat16 step, relative (8 significant bits)
UNEQUAL = 0.01
F32_RTOL = 1e-5


def close_bf16(got, want, name: str) -> None:
    """``got`` (a torch tensor) against ``want`` (a JAX array) by the
    module's tolerance, the rule of ``want``'s dtype; raises AssertionError."""
    a = got.detach().float().numpy()
    b = np.asarray(jnp.asarray(want, jnp.float32))
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if want.dtype == BF:
        off = np.abs(a - b) > STEP * float(np.abs(b).max())
        unequal = float(np.mean(a != b))
        assert not off.any() and unequal <= UNEQUAL, (
            f"{name}: {int(off.sum())} elements beyond one step, {unequal:.4f} unequal")
    else:
        err = float(np.abs(a - b).max())
        assert err <= F32_RTOL * float(np.abs(b).max()), f"{name}: {err}"


def _k1_jax(arrays, coeff, g, dt):
    """Pallas K1's output and K1b's gradients with qt, k, v, diag_value and
    the cotangent in ``dt``."""
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_fused

    low = (0, 1, 2, 7)
    full = [jnp.asarray(a, dt) if i in low else jnp.asarray(a) for i, a in enumerate(arrays)]

    def fn(*diff):
        args = list(full)
        for i, d in zip(DIFF, diff):
            args[i] = d
        return neighbor_attn_fused(*args, coeff, True)

    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(fn, *(full[i] for i in DIFF))
        return out, vjp(jnp.asarray(g, dt))


def _k1_port(arrays, coeff, g):
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    ts = [torch.tensor(a) for a in arrays]
    for i in (0, 1, 2, 7):
        ts[i] = ts[i].to(torch.bfloat16)
    for i in DIFF:
        ts[i].requires_grad_()
    out = k1.neighbor_attn(*ts, coeff, *k1.transpose_slots(ts[3]))
    out.backward(torch.tensor(g).to(torch.bfloat16))
    return out, [ts[i].grad for i in DIFF]


def test_k1_bf16_twin_matches_pallas():
    """K1's and K1b's bfloat16 twins == the Pallas kernel and its VJP at
    bfloat16 qt, k, v, diag_value and cotangent: qt, k, v, d diag_value and
    the output bfloat16, d diag_scores and the eight weight gradients
    float32, as JAX returns them."""
    arrays, coeff, g = _attn_case(np.random.default_rng(79))
    want_out, want = _k1_jax(arrays, coeff, g, BF)
    out, got = _k1_port(arrays, coeff, g)
    assert out.dtype == torch.bfloat16 and want_out.dtype == BF
    close_bf16(out, want_out, "out")
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == (torch.bfloat16 if b.dtype == BF else torch.float32), name
        close_bf16(a, b, name)
    # the padded nodes' masked slots carried dv to rows 0..K-1
    assert float(got[2][1, :7].float().abs().max()) > 0.0


def _k2(lmax, N, dt, arrays, g):
    from singa_tpu.ops.pallas.so3_ffn import so3_gate_ffn_fused

    ja = [jnp.asarray(a, dt) if i == 0 else jnp.asarray(a) for i, a in enumerate(arrays)]
    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(lambda *a: so3_gate_ffn_fused(*a, lmax, True), *ja)
        return out, vjp(jnp.asarray(g, dt))


def _k2_case(lmax, N, C=8, H=24, Co=8):
    L = lmax + 1
    rng = np.random.default_rng(73 + lmax)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    arrays = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
              0.1 * f(lmax * H), 0.1 * f(L, H, Co), 0.1 * f(Co)]
    return arrays, f(N, L * L, Co)


@pytest.mark.parametrize("lmax,N", [(2, 13), (6, 5)])
def test_k2_bf16_twin_matches_pallas(lmax, N):
    """K2's and K2b's bfloat16 twins == the Pallas kernel and its VJP at a
    bfloat16 x (float32 weights): y and dx bfloat16, the six weight and bias
    gradients float32."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    arrays, g = _k2_case(lmax, N)
    want_out, want = _k2(lmax, N, BF, arrays, g)
    ts = [torch.tensor(a) for a in arrays]
    ts[0] = ts[0].to(torch.bfloat16)
    for x in ts:
        x.requires_grad_()
    out = k2.so3_gate_ffn(*ts, lmax)
    out.backward(torch.tensor(g).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and ts[0].grad.dtype == torch.bfloat16
    close_bf16(out, want_out, "y")
    for name, x, b in zip(["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"], ts, want):
        close_bf16(x.grad, b, name)


def _k3(lmax, dt, x, s, g):
    from singa_tpu.equivariant import layers as jl
    from singa_tpu.ops.pallas.s2_act import s2_silu_sep as pallas_sep

    jtg, jfg = jl._grid_mats_for(lmax, 2, True)
    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(lambda a, b: pallas_sep(a, b, jtg, jfg), jnp.asarray(x, dt),
                           jnp.asarray(s, dt))
        return out, vjp(jnp.asarray(g, dt))


def _k3_case(lmax):
    from singa_tpu_torch.equivariant.so3 import num_coeffs_trunc

    I = num_coeffs_trunc(lmax, 2)
    rng = np.random.default_rng(71)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(19, I, 8), f(19, 8), f(19, I, 8)


@pytest.mark.parametrize("lmax", [2, 6])
def test_k3_bf16_twin_matches_pallas(lmax):
    """K3's and K3b's bfloat16 twins == the Pallas kernel and its VJP at
    bfloat16 x, scalars and cotangent, with the grid matrices cast to
    bfloat16 as the module casts them: out, dx and dscalars bfloat16."""
    from singa_tpu_torch.equivariant import layers as tl
    from singa_tpu_torch.ops.cuda import s2_act as k3

    x, s, g = _k3_case(lmax)
    want_out, want = _k3(lmax, BF, x, s, g)
    tg, fg = (torch.tensor(m).to(torch.bfloat16) for m in tl._grid_mats_for(lmax, 2, True))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    st = torch.tensor(s).to(torch.bfloat16).requires_grad_()
    out = k3.s2_silu_sep(xt, st, tg, fg)
    out.backward(torch.tensor(g).to(torch.bfloat16))
    assert out.dtype == xt.grad.dtype == st.grad.dtype == torch.bfloat16
    close_bf16(out, want_out, "out")
    close_bf16(xt.grad, want[0], "dx")
    close_bf16(st.grad, want[1], "dscalars")


def test_float32_results_fail_the_bf16_tolerance():
    """The tolerance tells the bfloat16 function from the float32 one: each
    Pallas kernel's float32 result on the same (bfloat16-valued) inputs, held
    to its bfloat16 result by ``close_bf16``, fails it, outputs and weight
    gradients alike; all but K2b's db2, the sum of the cotangent's row 0,
    which is the same bfloat16 values at either precision."""
    def fails(got, want, name):
        with pytest.raises(AssertionError):
            close_bf16(torch.tensor(np.asarray(jnp.asarray(got, jnp.float32))), want, name)

    arrays, coeff, g = _attn_case(np.random.default_rng(79))
    rounded = [np.asarray(jnp.asarray(a, BF).astype(jnp.float32)) if i in (0, 1, 2, 7) else a
               for i, a in enumerate(arrays)]
    g16 = np.asarray(jnp.asarray(g, BF).astype(jnp.float32))
    out16, grads16 = _k1_jax(arrays, coeff, g, BF)
    out32, grads32 = _k1_jax(rounded, coeff, g16, jnp.float32)
    fails(out32, out16, "K1 out")
    for name, a, b in zip(NAMES, grads32, grads16):
        fails(a, b, f"K1b {name}")

    arrays2, g2 = _k2_case(6, 5)
    arrays2[0] = np.asarray(jnp.asarray(arrays2[0], BF).astype(jnp.float32))
    out16, grads16 = _k2(6, 5, BF, arrays2, g2)
    out32, grads32 = _k2(6, 5, jnp.float32, arrays2, np.asarray(jnp.asarray(g2, BF), np.float32))
    fails(out32, out16, "K2 y")
    for name, a, b in zip(["dx", "dw1", "db1", "dwg", "dbg", "dw2"], grads32, grads16):
        fails(a, b, f"K2b {name}")
    close_bf16(torch.tensor(np.asarray(grads32[6])), grads16[6], "K2b db2")

    x, s, g3 = (np.asarray(jnp.asarray(a, BF).astype(jnp.float32)) for a in _k3_case(6))
    out16, grads16 = _k3(6, BF, x, s, g3)
    out32, grads32 = _k3(6, jnp.float32, x, s, g3)
    fails(out32, out16, "K3 out")
    fails(grads32[0], grads16[0], "K3b dx")
    fails(grads32[1], grads16[1], "K3b dscalars")
