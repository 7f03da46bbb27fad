"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine without JAX;
there ``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from fixed seeds, at the main path's widths and
at ragged sizes that exercise each kernel's edge handling. Everything runs
in float32 with TF32 off; the kernel and the plain version add the same
products in a different order, so they agree to atol/rtol 1e-4 on outputs
of order 1-100.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dev)


def _check(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,K", [(2, 64, 24), (3, 50, 96)])
def test_neighbor_attn_kernel_matches_plain(dev, B, N, K):
    """K1, at the encoder's widths (H 4, kd 32, vd 64, De 64), with random
    masks, a node with no live slot and a padded node (self score -1e9)."""
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1

    H, kd, vd, De = 4, 32, 64, 64
    rng = np.random.default_rng(41 + K)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    mask = rng.random((B, N, K)) > 0.6
    mask[0, 3] = False
    ds = f(B, N, H)
    ds[0, 5] = -1e9
    mask[0, 5] = False
    args = [
        f(B, N, H * kd), f(B, N, H * kd), f(B, N, H * vd),
        rng.integers(0, N, size=(B, N, K)).astype(np.int32), mask,
        rng.uniform(0.5, 14.0, size=(B, N, K)).astype(np.float32), ds, f(B, N, H * vd),
        np.linspace(0.0, 15.0, De, dtype=np.float32),
        0.3 * f(De, kd), 0.1 * f(kd), 0.3 * f(kd, kd), 0.1 * f(kd),
        0.3 * f(De, vd), 0.1 * f(vd), 0.3 * f(vd, vd), 0.1 * f(vd),
    ]
    args = [_t(a, dev) for a in args] + [-0.5 / (15.0 / (De - 1)) ** 2]
    n = k1.launches
    got = k1.neighbor_attn(*args)
    assert k1.launches == n + 1
    _check(got, k1.neighbor_attn_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H", [(37, 512), (8, 40)])
def test_so3_gate_ffn_kernel_matches_plain(dev, N, H):
    """K2 at lmax 6 with 16 channels; N not a multiple of the node tile and
    H not a multiple of the hidden chunk."""
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    lmax, C, Co = 6, 16, 16
    L = lmax + 1
    rng = np.random.default_rng(43 + N)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
            0.1 * f(lmax * H), 0.1 * f(L, H, Co), 0.1 * f(Co)]
    args = [_t(a, dev) for a in args]
    n = k2.launches
    got = k2.so3_gate_ffn(*args, lmax)
    assert k2.launches == n + 1
    _check(got, k2.so3_gate_ffn_plain(*args, lmax))


@pytest.mark.cuda
@pytest.mark.parametrize("E,C", [(50, 128), (9, 100)])
def test_s2_silu_sep_kernel_matches_plain(dev, E, C):
    """K3 with the lmax 6 / mmax 2 grid (I 29, G 70); C not a multiple of the
    channel block."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import s2_act as k3

    rng = np.random.default_rng(47 + E)
    tg, fg = (_t(m, dev) for m in _grid_mats_for(6, 2, True))
    x = _t(rng.normal(size=(E, tg.shape[1], C)).astype(np.float32), dev)
    s = _t(rng.normal(size=(E, C)).astype(np.float32), dev)
    n = k3.launches
    got = k3.s2_silu_sep(x, s, tg, fg)
    assert k3.launches == n + 1
    _check(got, k3.s2_silu_sep_plain(x, s, tg, fg))
