"""The bfloat16 instances of the kNN encoder's hybrid and dense attention:
K7/K7b (``neighbor_attn_hybrid``, ``SINGA_TPU_HYBRID_ATTN``) and K8/K8b
(``dense_edge_attn``, ``SINGA_TPU_DENSE_ATTN``), each through its autograd
Function on CPU tensors (where it takes its bfloat16 plain twin), against
the JAX package's Pallas kernels and their VJPs in interpret mode on the
same bfloat16 qt, k, v, diag_value and cotangent (float32 distances, self
scores and EdgeMLP weights, as the model passes them); then the tiny
config's bfloat16 training step under each switch against JAX's.

The cases are ``test_torch_encoder_attn_forms.py``'s (B 2, N 20, H 2, kd 8,
vd 8, De 8): K7's with a node whose slots are all masked, a padded node and
a repeated neighbour; K8's with an isolated live node and padded rows that
carry a cotangent. Tolerance (``close``): bfloat16 outputs by
``close_bf16`` (one bfloat16 step of each output's largest, at most 1 % of
the elements unequal); float32 outputs (d diag_scores, the weight
gradients) within F32_SUM_TOL = 2e-4 of their largest. Each
weight-gradient element sums bfloat16 terms (a rounded hidden times a
rounded dw), and a term that lands a step apart where a value sits on a
rounding boundary (both sides round the same values, their float32 sums in
other orders) moves its element by that step (2^-8) of the term: K7's case
shows 2 of dwv2's 64 elements at 3.4e-5 of its largest (the port's K1 twin
gives the same numbers, bit for bit), beyond ``close_bf16``'s 1e-5 for
float32 outputs. The Pallas kernels' float32 results on the same
bfloat16-valued inputs miss the tolerance by far (their weight gradients
by 1.3e-3 of the largest and more, on both forms' cases;
``test_float32_results_fail_the_tolerance``).

The step test is ``test_torch_bf16_step.py``'s with the form's switch: the
port's bfloat16 loss and gradients must be nearer JAX's bfloat16 step (its
kernels in interpret mode, the form's included, through
``SINGA_TPU_FORCE_FUSED_ATTN``) than JAX's float32 step is.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_bf16_kernels import BF, close_bf16
from test_torch_common import jax_batch, load_val, port_config, singa_params, torch_batch
from test_torch_encoder_attn_forms import (
    DENSE,
    DIFF_AT,
    FORCE,
    GRAD_NAMES,
    HYBRID,
    _coeff,
    _counting,
    _dense_inputs,
    _weights,
)

LOW_K7 = (0, 1, 2, 7)  # qt, k, v, diag_value: bfloat16 in K7's arguments
LOW_K8 = (0, 1, 2, 5)  # ... in K8's
DIFF_K8 = [0, 1, 2, 4, 5, *range(7, 15)]
F32_SUM_TOL = 2e-4  # float32 outputs: sums of bfloat16 terms (the module's note)


def _k7_case(seed=37, B=2, N=20, K=8, H=2, kd=8, vd=8, De=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    nbr = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    nbr[1, 4, :3] = 7  # a repeated neighbour
    mask = rng.random((B, N, K)) > 0.3
    mask[0, 3] = False  # a node with no live slot
    ds = f(B, N, H)
    ds[0, 5], mask[0, 5] = -1e9, False  # a padded node
    arrays = [f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd), nbr, mask,
              rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * vd),
              *_weights(rng, De, kd, vd)]
    return arrays, _coeff(De), f(B, N, H * vd)


def _jax(fn, arrays, coeff, g, low, diff, dt):
    """``fn``'s output and VJP (Pallas, interpret mode) with the arguments
    ``low`` and the cotangent in ``dt``."""
    full = [jnp.asarray(a, dt) if i in low else jnp.asarray(a) for i, a in enumerate(arrays)]

    def f(*d):
        args = list(full)
        for i, x in zip(diff, d):
            args[i] = x
        return fn(*args, coeff, True)

    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(f, *(full[i] for i in diff))
        return out, vjp(jnp.asarray(g, dt))


def _port(fn, arrays, coeff, g, low, diff, extra=lambda ts: ()):
    """``fn``'s output and the gradients of its arguments ``diff`` through its
    Function on CPU tensors, with the arguments ``low`` and the cotangent
    bfloat16."""
    ts = [torch.tensor(a) for a in arrays]
    for i in low:
        ts[i] = ts[i].to(torch.bfloat16)
    for i in diff:
        ts[i].requires_grad_()
    out = fn(*ts, coeff, *extra(ts))
    out.backward(torch.tensor(g).to(torch.bfloat16))
    return out, [ts[i].grad for i in diff]


def close(got, want, name: str) -> None:
    """``got`` (a torch tensor) against ``want`` (a JAX array) by the
    module's tolerance: ``close_bf16`` for a bfloat16 ``want``; a float32
    one within F32_SUM_TOL of its largest magnitude."""
    if want.dtype == BF:
        close_bf16(got, want, name)
        return
    a = got.detach().float().numpy()
    b = np.asarray(want)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= F32_SUM_TOL * float(np.abs(b).max()), f"{name}: {err}"


def _check(out, grads, want_out, want):
    assert out.dtype == torch.bfloat16 and want_out.dtype == BF
    close(out, want_out, "out")
    for name, a, b in zip(GRAD_NAMES, grads, want):
        assert a.dtype == (torch.bfloat16 if b.dtype == BF else torch.float32), name
        close(a, b, name)


def test_k7_bf16_twins_match_pallas(monkeypatch):
    """K7's and K7b's bfloat16 twins, through ``neighbor_attn_hybrid`` on
    CPU tensors, == the hybrid Pallas kernel and its VJP at bfloat16 qt, k,
    v, diag_value and cotangent: out, dqt, dk, dv and d diag_value
    bfloat16, d diag_scores and the weight gradients float32; the rows
    gathered in bfloat16, and the function K1's bfloat16 twin computes."""
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_hybrid as jhybrid
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7

    arrays, coeff, g = _k7_case()
    want_out, want = _jax(jhybrid, arrays, coeff, g, LOW_K7, DIFF_AT, BF)
    fwd = _counting(monkeypatch, k7, "neighbor_attn_hybrid_bf16_plain")
    bwd = _counting(monkeypatch, k7, "neighbor_attn_hybrid_bf16_bwd_plain")
    before = (k7.launches_hybrid_bf16, k7.launches_bwd_hybrid_bf16)
    out, grads = _port(k7.neighbor_attn_hybrid, arrays, coeff, g, LOW_K7, DIFF_AT,
                       lambda ts: k7.transpose_slots(ts[3]))
    assert (len(fwd), len(bwd)) == (1, 1)
    assert (k7.launches_hybrid_bf16, k7.launches_bwd_hybrid_bf16) == before  # CPU: the twins
    _check(out, grads, want_out, want)
    # the padded node's masked slots carried dv to the rows they name
    assert float(grads[2][0].float().abs().max()) > 0.0
    k1_out, k1_grads = _port(k7.neighbor_attn, arrays, coeff, g, LOW_K7, DIFF_AT,
                             lambda ts: k7.transpose_slots(ts[3]))
    torch.testing.assert_close(out, k1_out, rtol=0, atol=0)
    for a, b in zip(grads, k1_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k8_bf16_twins_match_pallas(monkeypatch):
    """K8's and K8b's bfloat16 twins, through ``dense_edge_attn`` on CPU
    tensors, == the dense Pallas kernel and its VJP at bfloat16 qt, k, v,
    diag_value and cotangent, with padded rows (a uniform softmax over all
    N + 1 slots) carrying a cotangent and an isolated live row; dtypes as
    K7's."""
    from singa_tpu.ops.pallas.dense_edge_attn import dense_edge_attn as jdense
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    arrays, g, _ = _dense_inputs(np.random.default_rng(43))
    coeff = _coeff(8)
    want_out, want = _jax(jdense, arrays, coeff, g, LOW_K8, DIFF_K8, BF)
    fwd = _counting(monkeypatch, k8, "dense_edge_attn_bf16_plain")
    bwd = _counting(monkeypatch, k8, "dense_edge_attn_bf16_bwd_plain")
    before = (k8.launches_bf16, k8.launches_bwd_bf16)
    out, grads = _port(k8.dense_edge_attn, arrays, coeff, g, LOW_K8, DIFF_K8)
    assert (len(fwd), len(bwd)) == (1, 1)
    assert (k8.launches_bf16, k8.launches_bwd_bf16) == before  # CPU: the twins
    _check(out, grads, want_out, want)
    # the padded rows' dv reaches every column, the padded nodes' too
    assert float(grads[2][1, -4:].float().abs().max()) > 0


def test_k8_bf16_does_not_round_like_k1():
    """K8's bfloat16 function is not K1's on its live columns: the dense TPU
    kernel keeps w_k, w_v, the score terms and the softmax weights in
    float32, so K7's bfloat16 twin on the same pairs (every column a slot)
    misses the dense Pallas kernel's bfloat16 output by the tolerance."""
    from singa_tpu.ops.pallas.dense_edge_attn import dense_edge_attn as jdense
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7

    arrays, g, _ = _dense_inputs(np.random.default_rng(43))
    coeff = _coeff(8)
    want_out, _ = _jax(jdense, arrays, coeff, g, LOW_K8, DIFF_K8, BF)
    ts = [torch.tensor(a) for a in arrays]
    for i in LOW_K8:
        ts[i] = ts[i].to(torch.bfloat16)
    B = ts[0].shape[0]
    as_k1 = torch.cat([k7.neighbor_attn_hybrid_bf16_plain(
        *k8._graph_rows(ts[0][b], ts[1][b], ts[2][b], ts[3][b], ts[4][b], ts[5][b]), *ts[6:], coeff)
        for b in range(B)])
    with pytest.raises(AssertionError):
        close(as_k1, want_out, "K8 as K1's bfloat16 function")
    close(k8.dense_edge_attn_bf16_plain(*ts, coeff), want_out, "K8's twin")


def test_float32_results_fail_the_tolerance():
    """The tolerance tells the bfloat16 functions from the float32 ones: each
    Pallas kernel's float32 result on the same (bfloat16-valued) inputs and
    cotangent, held to its bfloat16 result by ``close_bf16``, fails it, the
    output and every gradient but d diag_scores, which at either precision
    is a float32 sum of the same float32 weights; and so does it by
    ``close_bf16``'s rule for float32 outputs, 1e-5 of the largest
    everywhere."""
    from singa_tpu.ops.pallas.dense_edge_attn import dense_edge_attn as jdense
    from singa_tpu.ops.pallas.neighbor_attn import neighbor_attn_hybrid as jhybrid

    def fails(got, want, name):
        for rule in (close, close_bf16):
            with pytest.raises(AssertionError):
                rule(torch.tensor(np.asarray(jnp.asarray(got, jnp.float32))), want, name)

    def as_bf16(a):
        return np.asarray(jnp.asarray(a, BF).astype(jnp.float32))

    k7_arrays, coeff7, g7 = _k7_case()
    k8_arrays, g8, _ = _dense_inputs(np.random.default_rng(43))
    for form, fn, (arrays, coeff, g), low, diff in (
            ("K7", jhybrid, (k7_arrays, coeff7, g7), LOW_K7, DIFF_AT),
            ("K8", jdense, (k8_arrays, _coeff(8), g8), LOW_K8, DIFF_K8)):
        out16, grads16 = _jax(fn, arrays, coeff, g, low, diff, BF)
        rounded = [as_bf16(a) if i in low else a for i, a in enumerate(arrays)]
        out32, grads32 = _jax(fn, rounded, coeff, as_bf16(g), low, diff, jnp.float32)
        fails(out32, out16, f"{form} out")
        for name, a, b in zip(GRAD_NAMES, grads32, grads16):
            if name != "dds":
                fails(a, b, f"{form}b {name}")


@pytest.fixture(scope="module", params=["hybrid", "dense"])
def steps(request):
    """The tiny config (lmax 2) on 2 val complexes under the form's switch:
    JAX's (loss, gradients) at bfloat16 and float32, with its kernels
    dispatched as on its TPU in interpret mode (the form's through
    SINGA_TPU_FORCE_FUSED_ATTN), and the port's bfloat16 step, with the
    calls of the form's bfloat16 twins counted."""
    import singa_tpu.equivariant.layers as jlayers
    import singa_tpu.ops.pallas.so3_ffn as jffn
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import cross_entropy_loss as jce
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8
    from singa_tpu_torch.ops.cuda import neighbor_attn as k7
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    form = request.param
    jcfg, params = singa_params(2, 2)
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)

    def loss_fn(p, b):
        return jce(JSINGA(jcfg).apply(p, b), b.tokens.target)

    fused = jffn.so3_gate_ffn_fused
    mp = pytest.MonkeyPatch()
    mp.setenv(FORCE, "1")
    mp.setenv(HYBRID if form == "hybrid" else DENSE, "1")
    mp.setattr(jlayers, "_use_pallas", lambda: True)
    # the FFN calls the kernel without the interpret flag (it is TPU-only there)
    mp.setattr(jffn, "so3_gate_ffn_fused", lambda *a: fused(*a, True) if len(a) == 8 else fused(*a))
    module, name = (k8, "dense_edge_attn_bf16_plain") if form == "dense" else (
        k7, "neighbor_attn_hybrid_bf16_plain")
    calls = _counting(mp, module, name)
    out = {"form": form}
    try:
        for dt in ("bfloat16", "float32"):
            with compute_dtype_scope(dt):
                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jb)
            out[dt] = (float(loss), from_flax_grads(jax.tree_util.tree_map(np.asarray, grads)))
        model = SINGA(port_config(jcfg), device="cpu")
        load_flax_params(model, params)
        with port_scope("bfloat16"):
            loss = cross_entropy_loss(model(tb), tb.tokens.target)
            loss.backward()
        out["port"] = (loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters()},
                       {p.grad.dtype for p in model.parameters()})
        out["calls"] = len(calls)
        out["layers"] = jcfg.model.encoder.num_interactions
    finally:
        mp.undo()
    return out


def _grad_gap(got: dict, want: dict) -> float:
    top = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(np.asarray(got[n]) - w).max()) for n, w in want.items()) / top


def test_bf16_step_under_each_switch_is_nearer_jax_bf16_than_jax_f32_is(steps):
    """Under SINGA_TPU_HYBRID_ATTN and under SINGA_TPU_DENSE_ATTN the
    port's bfloat16 step runs the form's bfloat16 twin once per encoder-1
    layer, and its loss and every gradient (float32) are nearer JAX's
    bfloat16 step in the same form than JAX's float32 step is."""
    jloss, jgrads = steps["bfloat16"]
    floss, fgrads = steps["float32"]
    loss, grads, dtypes = steps["port"]
    assert steps["calls"] == steps["layers"]
    assert set(grads) == set(jgrads) and dtypes == {torch.float32}
    assert all(np.isfinite(g).all() for g in grads.values())
    assert abs(loss - jloss) < abs(floss - jloss), (steps["form"], loss, jloss, floss)
    port_gap, f32_gap = _grad_gap(grads, jgrads), _grad_gap(fgrads, jgrads)
    assert port_gap < f32_gap, (steps["form"], port_gap, f32_gap)
