"""The bfloat16 instances of the fused SO(2) edge attention, K6·bf16 and
K6b·bf16 (``so2_attn`` under ``SINGA_TPU_FUSED_SO2``), through their
autograd Function on CPU tensors (where they take their bfloat16 plain
twins), against the JAX package's Pallas ``so2_attn_fused`` and its VJP in
interpret mode on the same bfloat16 x, rad and cotangents (float32 angles,
weights, biases and grid matrices, as the model passes them); then the
tiny config's bfloat16 training step under the switch against JAX's, and
every module's output dtype against JAX's.

The case is lmax 2, mmax 2, 37 edges, 8 input channels, hidden 128, F2 8,
6 alpha channels, non-zero b1 and b2. Tolerance (``close`` of
``test_torch_bf16_attn_forms.py``): bfloat16 outputs (z, extra, dx, drad)
by ``close_bf16``, one bfloat16 step of each output's largest and at most
1 % of the elements unequal; float32 outputs (dw1, db1, db2) within
F32_SUM_TOL = 2e-4 of their largest (each element sums bfloat16 terms, and
a term whose cotangent lands a step apart where a value sits on a rounding
boundary moves it: the case measures 1.4e-5 on dw1_0).

dw2: the JAX wrapper returns dw2 in bfloat16 (``_bwd`` rebinds ``w2s`` to
its bfloat16 copies, so2_attn.py:461, before ``g.astype(w.dtype)`` at
:520), dw1 in float32. The port returns both float32, as the parameters
are, never rounded on the way out: its dw2 rounded to bfloat16 is held to
JAX's by ``close_bf16``, and its float32 values are shown not to be
bfloat16 values. The Pallas kernel's float32 results on the same
bfloat16-valued inputs miss the tolerance
(``test_float32_results_fail_the_tolerance``).

The step test is ``test_torch_bf16_step.py``'s with the switch, at the
tiny config with 128 attention hidden channels (the fused branch's
width): the port's bfloat16 loss and gradients must be nearer JAX's
bfloat16 step (its kernels in interpret mode, the fused SO(2) one through
``SINGA_TPU_FORCE_FUSED_SO2``) than JAX's float32 step is.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.dtypes import compute_dtype_scope
from test_torch_bf16_attn_forms import close
from test_torch_bf16_kernels import BF, close_bf16
from test_torch_common import jax_batch, load_val, port_config, tiny_jax_config, torch_batch
from test_torch_encoder_attn_forms import _counting

LMAX, MMAX = 2, 2
META = (LMAX, MMAX, 128, 8, 6)  # lmax, mmax, H, F2, alpha_ch
OUTS = ("z0", "z1", "z2", "extra")
GRADS = ("dx", "drad", "dw1_0", "dw1_1", "dw1_2", "db1", "dw2_0", "dw2_1", "dw2_2", "db2")
SWITCHES = ("SINGA_TPU_FUSED_SO2", "SINGA_TPU_FORCE_FUSED_SO2")


def _case(seed=41, E=37, c_in=8):
    """Seeded inputs and cotangents (float32 numpy; x, rad and the
    cotangents are cast to bfloat16 where used)."""
    from singa_tpu_torch.ops.cuda.so2_attn import sections

    _, _, H, F2, alpha_ch = META
    secs = sections(LMAX, MMAX)
    n0, n_trunc = secs[0], sum(secs)
    extra = alpha_ch + H
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    a = {
        "x": r(E, (LMAX + 1) ** 2, c_in),
        "rad": r(E, n_trunc, c_in) + 1.0,
        "phi": rng.uniform(-np.pi, np.pi, E).astype(np.float32),
        "beta": rng.uniform(0, np.pi, E).astype(np.float32),
        "w1s": [r(rows * c_in, rows * H + (extra if i == 0 else 0)) for i, rows in enumerate(secs)],
        "b1": r(n0 * H + extra),
        "w2s": [r(rows * H, rows * F2) for rows in secs],
        "b2": r(n0 * F2),
    }
    cts = [r(E, rows * F2) for rows in secs] + [r(E, extra)]
    return a, cts


def _jax(a, cts, dt):
    """Pallas so2_attn_fused (interpret mode) and its VJP with x, rad and the
    cotangents in ``dt``: (outputs, gradients in GRADS order)."""
    from singa_tpu.ops.pallas.so2_attn import _grids, so2_attn_fused

    tgj, fgj = (jnp.asarray(g) for g in _grids(LMAX, MMAX))
    phi, beta = jnp.asarray(a["phi"]), jnp.asarray(a["beta"])

    def fused(x, rad, w1s, b1, w2s, b2):
        return so2_attn_fused(x, rad, phi, beta, w1s, b1, w2s, b2, tgj, fgj, *META, True)

    args = (jnp.asarray(a["x"], dt), jnp.asarray(a["rad"], dt), [jnp.asarray(w) for w in a["w1s"]],
            jnp.asarray(a["b1"]), [jnp.asarray(w) for w in a["w2s"]], jnp.asarray(a["b2"]))
    with compute_dtype_scope("float32"):
        out, vjp = jax.vjp(fused, *args)
        grads = jax.tree_util.tree_leaves(vjp(tuple(jnp.asarray(c, dt) for c in cts)))
    return out, grads


def _port(a, cts):
    """so2_attn on CPU tensors at bfloat16 x, rad and cotangents: (outputs,
    gradients in GRADS order)."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    t = torch.tensor
    bf = lambda v: t(v).to(torch.bfloat16)
    leaves = [bf(a["x"]), bf(a["rad"]), *map(t, a["w1s"]), t(a["b1"]), *map(t, a["w2s"]),
              t(a["b2"])]
    for leaf in leaves:
        leaf.requires_grad_()
    tg, fg = _grid_mats_for(LMAX, MMAX, True)
    out = k6.so2_attn(leaves[0], leaves[1], t(a["phi"]), t(a["beta"]), leaves[2:5], leaves[5],
                      leaves[6:9], leaves[9], t(tg), t(fg), *META)
    torch.autograd.backward(out, [bf(c) for c in cts])
    return out, [leaf.grad for leaf in leaves]


def test_k6_bf16_twins_match_pallas(monkeypatch):
    """K6·bf16's and K6b·bf16's twins, through ``so2_attn`` on CPU tensors,
    == the Pallas so2_attn_fused and its VJP at bfloat16 x, rad and
    cotangents: z and extra, dx and drad bfloat16, every weight and bias
    gradient float32; dw2 rounded to bfloat16 == JAX's bfloat16 dw2, its
    float32 values not bfloat16 values."""
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    a, cts = _case()
    want_out, want = _jax(a, cts, BF)
    fwd = _counting(monkeypatch, k6, "so2_attn_bf16_plain")
    bwd = _counting(monkeypatch, k6, "so2_attn_bwd_bf16_plain")
    before = (k6.launches, k6.launches_bwd, k6.launches_bf16, k6.launches_bwd_bf16)
    out, grads = _port(a, cts)
    assert (len(fwd), len(bwd)) == (1, 1)
    assert (k6.launches, k6.launches_bwd, k6.launches_bf16, k6.launches_bwd_bf16) == before
    for name, got, w in zip(OUTS, out, want_out):
        assert got.dtype == torch.bfloat16 and w.dtype == BF, name
        close(got, w, name)
    for name, got, w in zip(GRADS, grads, want):
        if name.startswith("dw2"):
            assert got.dtype == torch.float32 and w.dtype == BF, name
            close_bf16(got.to(torch.bfloat16), w, name)
            assert bool((got != got.to(torch.bfloat16).float()).any()), name
            continue
        assert got.dtype == (torch.bfloat16 if name in ("dx", "drad") else torch.float32), name
        assert w.dtype == (BF if name in ("dx", "drad") else jnp.float32), name
        close(got, w, name)


def test_bf16_twins_are_not_the_float32_chain_rounded():
    """The twins round inside the chain, not only at its ends: the float32
    plain version on the same bfloat16-valued inputs, its outputs rounded
    to bfloat16, misses the Pallas kernel's bfloat16 outputs."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import so2_attn as k6

    a, cts = _case()
    want_out, _ = _jax(a, cts, BF)
    t = torch.tensor
    as_bf = lambda v: t(v).to(torch.bfloat16).float()
    tg, fg = _grid_mats_for(LMAX, MMAX, True)
    with torch.no_grad():
        f32 = k6.so2_attn_plain(as_bf(a["x"]), as_bf(a["rad"]), t(a["phi"]), t(a["beta"]),
                                [t(w) for w in a["w1s"]], t(a["b1"]), [t(w) for w in a["w2s"]],
                                t(a["b2"]), t(tg), t(fg), *META)
    with pytest.raises(AssertionError):
        for name, got, w in zip(OUTS, f32, want_out):
            close_bf16(got.to(torch.bfloat16), w, name)


def test_float32_results_fail_the_tolerance():
    """The tolerance tells the bfloat16 function from the float32 one: the
    Pallas kernel's float32 result on the same bfloat16-valued inputs and
    cotangents, held to its bfloat16 result, fails it on every output and
    on dx, drad, dw1 and db1 (dw2 as its bfloat16 rounding), by ``close``
    and by ``close_bf16``'s rule."""
    a, cts = _case()
    out16, grads16 = _jax(a, cts, BF)
    as_bf16 = lambda v: np.asarray(jnp.asarray(v, BF).astype(jnp.float32))
    rounded = dict(a, x=as_bf16(a["x"]), rad=as_bf16(a["rad"]))
    out32, grads32 = _jax(rounded, [as_bf16(c) for c in cts], jnp.float32)

    def fails(got, want, name):
        for rule in (close, close_bf16):
            with pytest.raises(AssertionError):
                rule(got, want, name)

    for name, got, want in zip(OUTS, out32, out16):
        fails(torch.tensor(np.asarray(got)), want, name)
    for name, got, want in zip(GRADS, grads32, grads16):
        if name == "db2":  # a float32 column sum of the same cotangent at either precision
            continue
        got = torch.tensor(np.asarray(got))
        fails(got.to(torch.bfloat16) if want.dtype == BF and got.dtype == torch.float32
              and name.startswith("dw2") else got, want, name)


def _so2_config():
    """The tiny config (lmax 2) with 128 attention hidden channels, the
    width at which both packages take the fused branch."""
    base = tiny_jax_config(LMAX, MMAX)
    return dataclasses.replace(base, embedding=dataclasses.replace(base.embedding,
                                                                   attn_hidden_channels=128))


@pytest.fixture(scope="module")
def step():
    """The tiny config under SINGA_TPU_FUSED_SO2 on 2 val complexes: JAX's
    (loss, gradients) at bfloat16 and float32, with its kernels dispatched
    as on its TPU in interpret mode (the fused SO(2) one through
    SINGA_TPU_FORCE_FUSED_SO2), and the port's bfloat16 step, with the
    calls of K6's bfloat16 twins counted."""
    import singa_tpu.equivariant.layers as jlayers
    import singa_tpu.ops.pallas.so3_ffn as jffn
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu.models.singa import cross_entropy_loss as jce
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
    from singa_tpu_torch.ops.cuda import so2_attn as k6
    from singa_tpu_torch.params import from_flax_grads, load_flax_params

    jcfg = _so2_config()
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)
    jm = JSINGA(jcfg)
    with compute_dtype_scope("float32"):
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jb))

    def loss_fn(p, b):
        return jce(jm.apply(p, b), b.tokens.target)

    fused = jffn.so3_gate_ffn_fused
    mp = pytest.MonkeyPatch()
    for var in (*SWITCHES, "SINGA_TPU_FORCE_FUSED_ATTN"):
        mp.setenv(var, "1")
    mp.setattr(jlayers, "_use_pallas", lambda: True)
    # the FFN calls the kernel without the interpret flag (it is TPU-only there)
    mp.setattr(jffn, "so3_gate_ffn_fused", lambda *a: fused(*a, True) if len(a) == 8 else fused(*a))
    fwd = _counting(mp, k6, "so2_attn_bf16_plain")
    bwd = _counting(mp, k6, "so2_attn_bwd_bf16_plain")
    out = {}
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
        out["calls"] = (len(fwd), len(bwd))
        out["layers"] = jcfg.embedding.num_layers
    finally:
        mp.undo()
    return out


def _grad_gap(got: dict, want: dict) -> float:
    top = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(np.asarray(got[n]) - w).max()) for n, w in want.items()) / top


def test_bf16_step_under_fused_so2_is_nearer_jax_bf16_than_jax_f32_is(step):
    """Under SINGA_TPU_FUSED_SO2 the port's bfloat16 step runs K6·bf16's
    and K6b·bf16's twins once per GraphAttention of both embedding stages,
    and its loss and every gradient (float32) are nearer JAX's bfloat16
    step on its fused path than JAX's float32 step is."""
    jloss, jgrads = step["bfloat16"]
    floss, fgrads = step["float32"]
    loss, grads, dtypes = step["port"]
    assert step["calls"] == (2 * step["layers"],) * 2
    assert set(grads) == set(jgrads) and dtypes == {torch.float32}
    assert all(np.isfinite(g).all() for g in grads.values())
    assert abs(loss - jloss) < abs(floss - jloss), (loss, jloss, floss)
    port_gap, f32_gap = _grad_gap(grads, jgrads), _grad_gap(fgrads, jgrads)
    assert port_gap < f32_gap, (port_gap, f32_gap)


def test_module_dtypes_match_jax_under_fused_so2(monkeypatch):
    """Under the switch, each module the port shares with the JAX model (by
    path) returns the dtype its JAX counterpart returns under bfloat16
    (``jax.eval_shape``), the fused GraphAttentions included."""
    from singa_tpu.models.singa import SINGA as JSINGA
    from singa_tpu_torch.dtypes import compute_dtype_scope as port_scope
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.ops.cuda import so2_attn as k6
    from singa_tpu_torch.params import load_flax_params

    for var in SWITCHES:
        monkeypatch.setenv(var, "1")
    jcfg = _so2_config()
    files = load_val(2)
    jb, tb = jax_batch(files), torch_batch(files)
    jm = JSINGA(jcfg)
    with compute_dtype_scope("float32"):
        params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jb))
    with compute_dtype_scope("bfloat16"):
        shapes = jax.eval_shape(
            lambda p, b: jm.apply(p, b, capture_intermediates=True, mutable=["intermediates"]),
            params, jb)
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
    calls = _counting(monkeypatch, k6, "so2_attn_bf16_plain")
    with port_scope("bfloat16"), torch.no_grad():
        model(tb)
    assert len(calls) == 2 * jcfg.embedding.num_layers
    shared = [n for n in want if n in got]
    assert len(shared) > 100 and "embedding.block_0.ga" in shared
    for n in shared:
        assert set(got[n]) == set(want[n]), (n, got[n], want[n])
