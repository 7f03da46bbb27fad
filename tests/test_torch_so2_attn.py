"""The fused SO(2) edge-attention slice of the port against the JAX package:
K6 (``so2_attn``), reached through its autograd Function on CPU tensors
(where it takes its plain version), against the Pallas ``so2_attn_fused``
in interpret mode, forward and backward; ``GraphAttention`` with
``SINGA_TPU_FUSED_SO2`` set against the JAX module with
``SINGA_TPU_FORCE_FUSED_SO2`` set (its interpret-mode hook) and against the
port's own unfused path; and SINGA's ``encode_pocket`` and training loss
with every gradient, both packages on their fused paths.

Inputs are numpy-seeded and float32. Tolerances: the kernel test's are
those of the JAX package's own (tests/test_equivariant_layers.py): forward
atol 1e-4 / rtol 2e-4, since the Pallas kernel folds the z-rotation flips
into its J matmuls and so reassociates the float32 sums against the port's
elementwise z-combine; gradients 1e-4. Modules: 2e-4, the JAX module test's
tolerance for its fused path against its XLA path; gradients leaf by leaf
to 2e-4 of the leaf's largest magnitude (``close_grads``). The port's fused
and unfused paths run the same float32 operations on the CPU and agree to
round-off (1e-6).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_common import (
    close,
    close_grads,
    jax_batch,
    load_val,
    port_config,
    port_grads,
    t,
    tiny_jax_config,
    torch_batch,
)

LMAX, MMAX = 6, 2
NAMES = ["dx", "drad", "dw1_0", "dw1_1", "dw1_2", "db1", "dw2_0", "dw2_1", "dw2_2", "db2"]


def _kernel_inputs():
    """The inputs of tests/test_equivariant_layers.py's fused-kernel test:
    E 10, c_in 8, H 128, F2 8, alpha_ch 6, non-zero b1 and b2."""
    from singa_tpu_torch.ops.cuda.so2_attn import sections

    secs = sections(LMAX, MMAX)
    n0, n_trunc = secs[0], sum(secs)
    c_in, H, F2, alpha_ch = 8, 128, 8, 6
    extra = alpha_ch + H
    E = 10
    rng = np.random.default_rng(23)
    r = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    arrays = {
        "x": r(E, (LMAX + 1) ** 2, c_in),
        "rad": r(E, n_trunc, c_in) + 1.0,
        "phi": rng.uniform(-np.pi, np.pi, E).astype(np.float32),
        "beta": rng.uniform(0, np.pi, E).astype(np.float32),
        "w1s": [r(rows * c_in, rows * H + (extra if i == 0 else 0)) for i, rows in enumerate(secs)],
        "b1": r(n0 * H + extra),
        "w2s": [r(rows * H, rows * F2) for rows in secs],
        "b2": r(n0 * F2),
    }
    return arrays, (LMAX, MMAX, H, F2, alpha_ch)


def test_so2_attn_matches_pallas():
    """K6's plain forward and K6b's plain backward (dx, drad, each conv
    weight and bias gradient) == the Pallas so2_attn_fused and its _bwd in
    interpret mode, through the port's autograd Function."""
    from singa_tpu.ops.pallas.so2_attn import _grids, so2_attn_fused
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    a, meta = _kernel_inputs()
    tgj, fgj = (jnp.asarray(g) for g in _grids(LMAX, MMAX))
    phi, beta = jnp.asarray(a["phi"]), jnp.asarray(a["beta"])

    def fused(x, rad, w1s, b1, w2s, b2):
        return so2_attn_fused(x, rad, phi, beta, w1s, b1, w2s, b2, tgj, fgj, *meta, True)

    jargs = jax.tree_util.tree_map(jnp.asarray, (a["x"], a["rad"], a["w1s"], a["b1"], a["w2s"], a["b2"]))
    with compute_dtype_scope("float32"):
        want, vjp = jax.vjp(fused, *jargs)
        rng = np.random.default_rng(29)
        cts = [rng.normal(size=o.shape).astype(np.float32) for o in want]
        jgrads = jax.tree_util.tree_leaves(vjp(tuple(jnp.asarray(c) for c in cts)))

    leaves = [t(a["x"]), t(a["rad"]), *map(t, a["w1s"]), t(a["b1"]), *map(t, a["w2s"]), t(a["b2"])]
    for leaf in leaves:
        leaf.requires_grad_()
    tg, fg = _grid_mats_for(LMAX, MMAX, True)
    n, nb = k6.launches, k6.launches_bwd
    got = k6.so2_attn(leaves[0], leaves[1], t(a["phi"]), t(a["beta"]), leaves[2:5], leaves[5],
                      leaves[6:9], leaves[9], t(tg), t(fg), *meta)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, 1e-4, 2e-4, f"output {i}")
    torch.autograd.backward(got, [t(c) for c in cts])
    assert (k6.launches, k6.launches_bwd) == (n, nb)  # CPU tensors: the plain versions
    assert len(jgrads) == len(leaves) == len(NAMES)
    for name, leaf, w in zip(NAMES, leaves, jgrads):
        close(leaf.grad, w, 1e-4, 1e-4, name)


def _graph_attention_case():
    """A JAX and a port GraphAttention (hidden 128, so JAX may take its fused
    branch) with the same flax parameters, and matching edge inputs."""
    from singa_tpu.equivariant import so3 as jso3
    from singa_tpu.equivariant.attention import GraphAttention as JGA
    from singa_tpu.ops.neighbors import EdgeEngine as JE
    from singa_tpu_torch.equivariant import so3 as tso3
    from singa_tpu_torch.equivariant.attention import GraphAttention as TGA
    from singa_tpu_torch.ops.neighbors import EdgeEngine as TE
    from singa_tpu_torch.params import load_flax_params

    N, E, K, C, De = 6, 12, 4, 8, 8
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(N, (LMAX + 1) ** 2, C)) * 0.3).astype(np.float32)
    x_edge = rng.normal(size=(E, De)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = np.repeat(np.arange(N), E // N).astype(np.int32)
    index = np.stack([src, dst], -1)[None]
    table = np.full((1, N, K), E, np.int32)
    fill = np.zeros(N, np.int32)
    for e, d in enumerate(dst):
        table[0, d, fill[d]] = e
        fill[d] += 1
    vec = rng.normal(size=(E, 3)).astype(np.float32)
    je = JE.create(jnp.asarray(index), jnp.ones((1, E), bool), jnp.asarray(table), N, N)
    te = TE.create(t(index), torch.ones((1, E), dtype=torch.bool), t(table), N, N)
    jframe, tframe = jso3.edge_frame(jnp.asarray(vec)), tso3.edge_frame(t(vec))
    jga = JGA(sphere_channels=C, hidden_channels=128, num_heads=2, attn_alpha_channels=3,
              attn_value_channels=4, output_channels=C, lmax=LMAX, mmax=MMAX,
              edge_channels=(16, 16))
    with compute_dtype_scope("float32"):
        params = jax.tree_util.tree_map(
            np.asarray, jga.init(jax.random.PRNGKey(0), x, x, x_edge, je, jframe))
    tga = TGA(C, 128, 2, 3, 4, C, LMAX, MMAX, (De, 16, 16), device="cpu")
    load_flax_params(tga, params["params"])
    w = rng.normal(size=x.shape).astype(np.float32)
    return (jga, params, je, jframe), (tga, te, tframe), x, x_edge, w


def _port_graph_attention(tga, te, tframe, x, x_edge, w):
    """(output, d x, {param: grad}) of sum(tga(x, x, x_edge) * w)."""
    tga.zero_grad(set_to_none=True)
    xt = t(x).requires_grad_()
    out = tga(xt, xt, t(x_edge), te, tframe)
    (out * t(w)).sum().backward()
    return out.detach(), xt.grad, port_grads(tga)


def test_graph_attention_fused_matches_jax(monkeypatch):
    """GraphAttention with SINGA_TPU_FUSED_SO2 set == the JAX module on its
    fused branch (SINGA_TPU_FORCE_FUSED_SO2, the Pallas kernel in interpret
    mode), one parameter set bridged from flax: the output, the input
    gradient and every parameter gradient."""
    from singa_tpu_torch.ops.cuda import so2_attn as k6
    from singa_tpu_torch.params import from_flax_grads

    (jga, params, je, jframe), port, x, x_edge, w = _graph_attention_case()
    monkeypatch.setenv("SINGA_TPU_FORCE_FUSED_SO2", "1")

    def loss(p, xx):
        out = jga.apply(p, xx, xx, jnp.asarray(x_edge), je, jframe)
        return jnp.sum(out * w), out

    with compute_dtype_scope("float32"):
        (_, want), (jp, jdx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x))

    monkeypatch.setenv("SINGA_TPU_FUSED_SO2", "1")
    calls = []
    plain = k6.so2_attn_plain
    monkeypatch.setattr(k6, "so2_attn_plain", lambda *a: calls.append(1) or plain(*a))
    out, dx, grads = _port_graph_attention(*port, x, x_edge, w)
    assert calls, "the fused branch was not taken"
    close(out, want, 2e-4, 2e-4, "output")
    close(dx, jdx, 2e-4, 2e-4, "d x")
    close_grads(grads, from_flax_grads(jax.tree_util.tree_map(np.asarray, jp["params"])), rtol=2e-4)


def test_graph_attention_fused_equals_unfused(monkeypatch):
    """The port's fused branch (K6's plain version on the CPU) and its
    unfused one (rotate, SO2Conv, K3, SO2Conv) at the same weights: the same
    output, input gradient and parameter gradients, one state dict for both
    settings of the switch."""
    _, port, x, x_edge, w = _graph_attention_case()
    monkeypatch.delenv("SINGA_TPU_FUSED_SO2", raising=False)
    out0, dx0, g0 = _port_graph_attention(*port, x, x_edge, w)
    g0 = {n: g.clone() for n, g in g0.items()}
    monkeypatch.setenv("SINGA_TPU_FUSED_SO2", "1")
    out1, dx1, g1 = _port_graph_attention(*port, x, x_edge, w)
    close(out1, out0.numpy(), 1e-6, 1e-6, "output")
    close(dx1, dx0.numpy(), 1e-6, 1e-6, "d x")
    close_grads(g1, {n: g.numpy() for n, g in g0.items()}, rtol=1e-6)


@pytest.fixture(scope="module")
def slice_run():
    """SINGA at the tiny config with lmax 2, mmax 2 and an attention hidden
    width of 128 (so JAX takes its fused branch) on one val complex, both
    packages switched on: JAX's encode_pocket, loss and gradients, and the
    port's, from bridged weights."""
    import os

    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import cross_entropy_loss as jce
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    base = tiny_jax_config(2, 2)
    jcfg = dataclasses.replace(base, embedding=dataclasses.replace(base.embedding,
                                                                   attn_hidden_channels=128))
    files = load_val(1)
    jb, tb = jax_batch(files), torch_batch(files)
    jm = JSINGA(jcfg)
    with compute_dtype_scope("float32"):  # the parameters do not depend on the switch
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jb))
    saved = {k: os.environ.get(k) for k in ("SINGA_TPU_FORCE_FUSED_SO2", "SINGA_TPU_FUSED_SO2")}
    os.environ.update({k: "1" for k in saved})
    try:
        def loss_fn(p, b):
            return jce(jm.apply(p, b), b.tokens.target)

        with compute_dtype_scope("float32"):
            jenc, _ = jax.jit(lambda p, b: jm.apply(p, b, method="encode_pocket"))(params, jb)
            jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params, jb)

        from singa_tpu_torch.ops.cuda import so2_attn as k6

        calls = []
        plain = k6.so2_attn_plain
        k6.so2_attn_plain = lambda *a: calls.append(1) or plain(*a)
        try:
            model = SINGA(port_config(jcfg), device="cpu")
            load_flax_params(model, params)
            with torch.no_grad():
                tenc, _ = model.encode_pocket(tb)
            n_encode = len(calls)
            loss = cross_entropy_loss(model(tb), tb.tokens.target)
            n_train = len(calls) - n_encode
            loss.backward()
        finally:
            k6.so2_attn_plain = plain
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return {
        "encode": (tenc, np.asarray(jenc)), "loss": (loss.item(), float(jloss)),
        "grads": (port_grads(model), from_flax_grads(jax.tree_util.tree_map(np.asarray, jgrads))),
        "calls": (n_encode, n_train), "layers": jcfg.embedding.num_layers,
    }


def test_encode_pocket_fused_matches_jax(slice_run):
    """Serving: encode_pocket with the switch on runs K6 once per TransBlock
    of stage 1 and equals JAX's fused encode_pocket (1e-4, a stack of
    layers)."""
    tenc, jenc = slice_run["encode"]
    assert slice_run["calls"][0] == slice_run["layers"]
    close(tenc, jenc, 1e-4, 1e-4, "encode_pocket")


def test_training_loss_and_gradients_fused_match_jax(slice_run):
    """Training: the loss and every gradient (both embedding stages through
    K6's backward) equal jax.value_and_grad on the fused path."""
    loss, jloss = slice_run["loss"]
    assert slice_run["calls"][1] == 2 * slice_run["layers"]  # stage 1 and stage 2
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    grads, jgrads = slice_run["grads"]
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads.values())
    close_grads(grads, jgrads)
