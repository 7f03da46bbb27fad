"""The s2 FFN at bfloat16: K4's and K4b's bfloat16 instances, through their
autograd Function on CPU tensors (where it takes the bfloat16 plain twins
``so3_ffn_bf16_plain`` / ``so3_ffn_bf16_bwd_plain``), against the JAX
package's Pallas ``so3_ffn_fused`` and its VJP in interpret mode on the same
bfloat16 x and cotangent (float32 weights; the grid matrices float32 on the
JAX side, which its kernel casts to x.dtype, bfloat16 on the port's, as its
module passes them); and the port's bfloat16 training step under
``ffn_activation: s2`` against JAX's.

Tolerances (``close_k4``): the bfloat16 outputs y and dx by ``close_bf16``
of ``test_torch_bf16_kernels.py`` (every element within one bfloat16 step
of the output's largest magnitude, at most 1% unequal); the six float32
weight and bias gradients within ``W_RTOL`` = 7e-4 of their largest
magnitude. Both sides round dh, mid and the activated grid at the same
points but sum in float32 in other orders (and the Pallas kernel's sigmoid
is tanh's), so a value near a rounding boundary lands one bfloat16 step
apart on the two sides, and the weight gradients sum such terms over every
node: measured at most 2.8e-4 of the largest (dw2 at lmax 4), where K2b's
stay within 1e-5. The two bias sums are held apart: db1 sums dh unrounded
and dbg sums dg0 rounded in the Pallas kernel, and the other rounding of
either misses Pallas's by 1.8e-3 or more of its largest
(``test_k4b_bf16_bias_sums_round_as_pallas``).

The step: the port's bfloat16 step nearer JAX's bfloat16 step (the s2
FFN's ``so3_ffn_fused`` dispatched as on JAX's TPU, in interpret mode, with
the attention kernels as ``test_torch_bf16_step.py`` dispatches them) than
JAX's own float32 step is, by the gradients' largest difference over the
largest gradient and by the logits' mean difference; the logits within
three bfloat16 steps of the largest logit. The loss does not tell the
precisions apart at this size (JAX float32's is 0.93e-4 of it from JAX
bfloat16's, the port's 1.09e-4: a mean over every token of bfloat16
logits that differ by whole steps where a rounding lands the other way),
so it is held within ``LOSS_RTOL`` = 2e-4 of JAX bfloat16's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_bf16_kernels import BF, STEP, close_bf16
from test_torch_common import jax_batch, load_val, port_config, singa_params, torch_batch

NAMES = ["dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"]
W_RTOL = 7e-4  # the float32 weight and bias gradients, of each one's largest magnitude
LOSS_RTOL = 2e-4  # the bfloat16 step's loss, of JAX's


def close_k4(got, want, name: str) -> None:
    """``close_bf16`` for a bfloat16 ``want``; a float32 one within W_RTOL
    of its largest magnitude."""
    if want.dtype == BF:
        close_bf16(got, want, name)
        return
    a, b = got.detach().float().numpy(), np.asarray(want)
    err = float(np.abs(a - b).max())
    assert err <= W_RTOL * float(np.abs(b).max()), f"{name}: {err}"


def _case(lmax: int, N: int, C: int = 8, H: int = 256, Co: int = 8):
    """Seeded inputs with non-zero biases (b1 reaches every row through the
    grid) and a bfloat16-valued cotangent."""
    L = lmax + 1
    rng = np.random.default_rng(131 + 7 * lmax + N)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    arrays = [f(N, L * L, C), 0.3 * f(L, C, H), 0.2 * f(H), 0.3 * f(C, H), 0.2 * f(H),
              0.1 * f(L, H, Co), 0.1 * f(Co)]
    return arrays, f(N, L * L, Co)


def _grids(lmax: int):
    """(port tg, fg [G, I] float32, JAX's padded tgp, fgp)."""
    from singa_tpu.equivariant import layers as jl
    from singa_tpu.ops.pallas.so3_ffn import pad_grid_mat
    from singa_tpu_torch.equivariant import layers as tl

    I = (lmax + 1) ** 2
    tg, fg = tl._grid_mats_for(lmax, lmax, False)
    jtg, jfg = jl._grid_mats_for(lmax, lmax, False)
    return (tg, fg, jnp.asarray(pad_grid_mat(jtg.reshape(-1, I), lmax)),
            jnp.asarray(pad_grid_mat(jfg.reshape(-1, I), lmax)))


def _pallas(lmax, arrays, g, tgp, fgp):
    from singa_tpu.ops.pallas.so3_ffn import so3_ffn_fused

    ja = [jnp.asarray(a, BF) if i == 0 else jnp.asarray(a) for i, a in enumerate(arrays)]
    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(lambda *a: so3_ffn_fused(*a, tgp, fgp, lmax, True), *ja)
        return out, vjp(jnp.asarray(g, BF))[:7]


def _port(lmax, arrays, g, tg, fg):
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    ts = [torch.tensor(a) for a in arrays]
    ts[0] = ts[0].to(torch.bfloat16)
    for x in ts:
        x.requires_grad_()
    n = (k4.launches_s2_bf16, k4.launches_s2_bwd_bf16)
    bf = lambda m: torch.as_tensor(np.asarray(m)).to(torch.bfloat16)
    out = k4.so3_ffn(*ts, bf(tg), bf(fg), lmax)
    out.backward(torch.tensor(g).to(torch.bfloat16))
    assert (k4.launches_s2_bf16, k4.launches_s2_bwd_bf16) == n  # CPU: the twins, no launch
    return out, [x.grad for x in ts]


@pytest.mark.parametrize("lmax,N", [(2, 1), (2, 37), (4, 1), (4, 37)])
def test_k4_bf16_twin_matches_pallas(lmax, N):
    """K4's and K4b's bfloat16 twins == so3_ffn_fused and its VJP at a
    bfloat16 x and cotangent: y and dx bfloat16, the six weight and bias
    gradients float32, as JAX returns them (two hidden chunks of 128 on the
    Pallas side)."""
    arrays, g = _case(lmax, N)
    tg, fg, tgp, fgp = _grids(lmax)
    want_out, want = _pallas(lmax, arrays, g, tgp, fgp)
    out, got = _port(lmax, arrays, g, tg, fg)
    assert out.dtype == torch.bfloat16 and want_out.dtype == BF
    close_k4(out, want_out, "y")
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == (torch.bfloat16 if b.dtype == BF else torch.float32), name
        close_k4(a, b, name)
    # b1 reaches every output row through the grid, not row 0 alone
    assert float(got[2].abs().max()) > 0.0


def _bias_terms(lmax, arrays, g, tg, fg):
    """dh's row 0 [N, H] and dg0 [N, H] in float32, as _ffn_bwd_kernel forms
    them before it rounds them (its steps, in plain PyTorch)."""
    from singa_tpu_torch.dtypes import rounded
    from singa_tpu_torch.ops.cuda.so3_ffn import _l_of, _silu_grad

    bf = torch.bfloat16
    x, w1, b1, wg, bg, w2, _ = (torch.tensor(a) for a in arrays)
    l_of = _l_of(lmax, "cpu")
    xf, dy = rounded(x, bf), rounded(torch.tensor(g), bf)
    tgr, fgr = rounded(torch.as_tensor(np.asarray(tg)), bf), rounded(torch.as_tensor(np.asarray(fg)), bf)
    g0 = xf[:, 0] @ rounded(wg, bf) + bg
    h = torch.einsum("nic,ich->nih", xf, rounded(w1, bf)[l_of])
    h = rounded(torch.cat([h[:, :1] + b1, h[:, 1:]], 1), bf)
    dmid = torch.einsum("nio,iho->nih", dy, rounded(w2, bf)[l_of])
    dg0 = _silu_grad(g0) * dmid[:, 0]
    dmid = rounded(torch.cat([torch.zeros_like(dmid[:, :1]), dmid[:, 1:]], 1), bf)
    grid = torch.einsum("gi,nih->ngh", tgr, h)
    dgrid = rounded(_silu_grad(grid) * torch.einsum("gi,nih->ngh", fgr, dmid), bf)
    return torch.einsum("gi,ngh->nih", tgr, dgrid)[:, 0], dg0


@pytest.mark.parametrize("lmax,N", [(2, 37), (4, 37)])
def test_k4b_bf16_bias_sums_round_as_pallas(lmax, N):
    """db1 is the sum of dh's row 0 unrounded and dbg the sum of dg0
    rounded, as in _ffn_bwd_kernel: each == Pallas's within W_RTOL of its
    largest magnitude, while the other rounding of either misses that."""
    from singa_tpu_torch.dtypes import rounded

    arrays, g = _case(lmax, N)
    tg, fg, tgp, fgp = _grids(lmax)
    _, want = _pallas(lmax, arrays, g, tgp, fgp)
    _, got = _port(lmax, arrays, g, tg, fg)
    dh0, dg0 = _bias_terms(lmax, arrays, g, tg, fg)
    bf = torch.bfloat16
    for name, i, right, wrong in (("db1", 2, dh0.sum(0), rounded(dh0, bf).sum(0)),
                                  ("dbg", 4, rounded(dg0, bf).sum(0), dg0.sum(0))):
        b = np.asarray(want[i])
        tol = W_RTOL * float(np.abs(b).max())
        assert float(np.abs(right.numpy() - b).max()) <= tol, name
        assert float(np.abs(got[i].numpy() - b).max()) <= tol, name
        assert float(np.abs(wrong.numpy() - b).max()) > tol, name


def test_k4_bf16_twin_is_not_the_float32_function():
    """The tolerance tells the two functions apart: the float32 plain
    functions on the same bfloat16-valued inputs (y and dx cast to
    bfloat16) fail ``close_k4`` against Pallas's bfloat16 results, each
    output but db2 (the sum of the cotangent's row 0, the same bfloat16
    values at either precision)."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k4

    lmax, N = 2, 37
    arrays, g = _case(lmax, N)
    tg, fg, tgp, fgp = _grids(lmax)
    want_out, want = _pallas(lmax, arrays, g, tgp, fgp)
    r = lambda a: torch.as_tensor(np.asarray(a)).to(torch.bfloat16).float()
    ts = [torch.tensor(a) for a in arrays]
    ts[0] = r(ts[0])
    args = (*ts[:6], r(tg), r(fg), lmax)
    out = k4.so3_ffn_plain(*ts, r(tg), r(fg), lmax).to(torch.bfloat16)
    grads = k4.so3_ffn_bwd_plain(*args, r(g))
    failed = []
    for name, a, b in zip(["y", *NAMES], (out, *grads), (want_out, *want)):
        try:
            close_k4(a.to(torch.bfloat16) if b.dtype == BF else a, b, name)
        except AssertionError:
            failed.append(name)
    assert failed == ["y", *NAMES[:-1]], failed


@pytest.fixture(scope="module")
def s2_steps():
    """{"bfloat16", "float32"}: JAX's (loss, logits, gradients) at the tiny
    s2 config, its kernels dispatched as on its TPU; "port": the port's
    bfloat16 step's (loss, logits, gradients, logits dtype)."""
    import singa_tpu.equivariant.layers as jlayers
    import singa_tpu.ops.pallas.so3_ffn as jffn
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import cross_entropy_loss as jce
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    jcfg, params = singa_params(2, 2, ffn_activation="s2")
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)

    def loss_fn(p, b):
        logits = JSINGA(jcfg).apply(p, b)
        return jce(logits, b.tokens.target), logits

    fused = jffn.so3_ffn_fused
    mp = pytest.MonkeyPatch()
    mp.setenv("SINGA_TPU_FORCE_FUSED_ATTN", "1")
    mp.setattr(jlayers, "_use_pallas", lambda: True)
    # the FFN calls the kernel without the interpret flag (it is TPU-only there)
    mp.setattr(jffn, "so3_ffn_fused", lambda *a: fused(*a, True) if len(a) == 10 else fused(*a))
    out = {}
    try:
        for dt in ("bfloat16", "float32"):
            with compute_dtype_scope(dt):
                (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jb)
            out[dt] = (float(loss), np.asarray(logits, np.float32),
                       from_flax_grads(jax.tree_util.tree_map(np.asarray, grads)))
    finally:
        mp.undo()
    model = SINGA(port_config(jcfg), device="cpu")
    load_flax_params(model, params)
    with port_scope("bfloat16"):
        logits = model(tb)
        loss = cross_entropy_loss(logits, tb.tokens.target)
        loss.backward()
    out["port"] = (loss.item(), logits.detach().float().numpy(),
                   {n: p.grad.numpy() for n, p in model.named_parameters()}, logits.dtype)
    return out


def _grad_gap(got: dict, want: dict) -> float:
    top = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(np.asarray(got[n]) - w).max()) for n, w in want.items()) / top


def test_bf16_s2_step_is_nearer_jax_bf16_than_jax_f32_is(s2_steps):
    jloss, jlogits, jgrads = s2_steps["bfloat16"]
    floss, flogits, fgrads = s2_steps["float32"]
    loss, logits, grads, logits_dtype = s2_steps["port"]
    assert logits_dtype == torch.bfloat16
    assert set(grads) == set(jgrads)
    assert all(np.isfinite(g).all() for g in grads.values())
    # the s2 FFN's weights are in the model, and trained
    assert any(n.endswith("ffn.gate_kernel") and np.abs(g).max() > 0 for n, g in grads.items())
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss, floss)
    port_gap, f32_gap = _grad_gap(grads, jgrads), _grad_gap(fgrads, jgrads)
    assert port_gap < f32_gap, (port_gap, f32_gap)
    d_port, d_f32 = np.abs(logits - jlogits), np.abs(flogits - jlogits)
    assert d_port.mean() < d_f32.mean(), (d_port.mean(), d_f32.mean())
    assert d_port.max() <= 3 * STEP * np.abs(jlogits).max(), d_port.max()
