"""The port's bfloat16 training step against the JAX package's, at the tiny
config (lmax 2) on 2 ``data/corpus/val`` complexes with bridged weights:
port under ``singa_tpu_torch.dtypes.compute_dtype_scope("bfloat16")``, JAX
under its own ``compute_dtype_scope("bfloat16")``, with JAX's kernels
dispatched as on its TPU (the gate FFN's ``so3_gate_ffn_fused``, the
separable S2 activation's ``s2_silu_sep`` and, with
``SINGA_TPU_FORCE_FUSED_ATTN``, the encoder's ``neighbor_attn_fused``, all in
interpret mode), since the port's kernels round where those do.

The yardstick is JAX's own float32 step on the same weights and data: the
port's bfloat16 step must be nearer JAX's bfloat16 step than that is, by
the loss's relative difference and by the gradients' largest difference
over the largest gradient (leaf by leaf through the gradient bridge). The
logits are bfloat16 on both sides, so each differs from the other by whole
bfloat16 steps where anything upstream rounded the other way; their mean
difference must be below JAX float32's, and their largest within three
bfloat16 steps of the largest logit (measured: port 1.17e-2, JAX float32
1.06e-2 of a largest logit near 1.7; the port does not beat float32 on that
one measure).

``test_module_dtypes_match_jax`` holds every module's output dtype, the
whole model's, to JAX's under bfloat16 (``jax.eval_shape``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import jax_batch, load_val, port_config, singa_params, torch_batch

STEP = 2.0 ** -7


@pytest.fixture(scope="module")
def steps():
    """{"bf16", "f32"}: JAX's (loss, logits, gradients); "port": the port's
    bfloat16 step's."""
    import singa_tpu.equivariant.layers as jlayers
    import singa_tpu.ops.pallas.so3_ffn as jffn
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import cross_entropy_loss as jce
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    jcfg, params = singa_params(2, 2)
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)

    def loss_fn(p, b):
        logits = JSINGA(jcfg).apply(p, b)
        return jce(logits, b.tokens.target), logits

    fused = jffn.so3_gate_ffn_fused
    mp = pytest.MonkeyPatch()
    mp.setenv("SINGA_TPU_FORCE_FUSED_ATTN", "1")
    mp.setattr(jlayers, "_use_pallas", lambda: True)
    # the FFN calls the kernel without the interpret flag (it is TPU-only there)
    mp.setattr(jffn, "so3_gate_ffn_fused", lambda *a: fused(*a, True) if len(a) == 8 else fused(*a))
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
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    out["port"] = (loss.item(), logits.detach().float().numpy(), grads, logits.dtype,
                   {n: p.grad.dtype for n, p in model.named_parameters()})
    return out


def _grad_gap(got: dict, want: dict) -> float:
    top = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(np.asarray(got[n]) - w).max()) for n, w in want.items()) / top


def test_bf16_step_is_nearer_jax_bf16_than_jax_f32_is(steps):
    jloss, jlogits, jgrads = steps["bfloat16"]
    floss, flogits, fgrads = steps["float32"]
    loss, logits, grads, logits_dtype, grad_dtypes = steps["port"]
    # logits bfloat16 as JAX's; every parameter and its gradient float32
    assert logits_dtype == torch.bfloat16
    assert set(grads) == set(jgrads) and set(grad_dtypes.values()) == {torch.float32}
    assert all(np.isfinite(g).all() for g in grads.values())
    assert abs(loss - jloss) < abs(floss - jloss)
    port_gap, f32_gap = _grad_gap(grads, jgrads), _grad_gap(fgrads, jgrads)
    assert port_gap < f32_gap, (port_gap, f32_gap)
    d_port, d_f32 = np.abs(logits - jlogits), np.abs(flogits - jlogits)
    assert d_port.mean() < d_f32.mean(), (d_port.mean(), d_f32.mean())
    assert d_port.max() <= 3 * STEP * np.abs(jlogits).max(), d_port.max()


def test_module_dtypes_match_jax():
    """Each module the port shares with the JAX model (by path) returns the
    dtype its JAX counterpart returns under bfloat16: bfloat16 out of the
    linears, embeddings, SO(2) convolutions, attention and FFN blocks and
    norms of [N, coeffs, C] features; float32 out of every LayerNorm and the
    blocks that end in one; the logits bfloat16."""
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.params import load_flax_params

    jcfg, params = singa_params(2, 2)
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)
    with compute_dtype_scope("bfloat16"):
        shapes = jax.eval_shape(
            lambda p, b: JSINGA(jcfg).apply(p, b, capture_intermediates=True,
                                            mutable=["intermediates"]), params, jb)
    want = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif k == "__call__":
                want[".".join(path)] = [str(jax.tree_util.tree_leaves(x)[0].dtype) for x in v]

    walk(shapes[1]["intermediates"], [])
    model = SINGA(port_config(jcfg), device="cpu")
    load_flax_params(model, params)
    got = {}
    for name, module in model.named_modules():
        module.register_forward_hook(
            lambda m, i, o, name=name: got.setdefault(name, []).append(
                str((o[0] if isinstance(o, tuple) else o).dtype).replace("torch.", "")))
    with port_scope("bfloat16"), torch.no_grad():
        model(tb)
    shared = [n for n in want if n in got]
    assert len(shared) > 100 and "" in shared and "embedding.block_0.ffn" in shared
    for n in shared:
        assert set(got[n]) == set(want[n]), (n, got[n], want[n])
