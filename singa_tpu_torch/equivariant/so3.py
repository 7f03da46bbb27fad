"""SO(3) feature layout, coefficient bookkeeping and edge-frame rotations.

Counterpart of ``singa_tpu/equivariant/so3.py``. An equivariant feature is a
tensor ``[N, (lmax+1)^2, C]`` in l-primary order (block ``l`` occupies
``l^2 .. l^2+2l``, within-block order ``m = -l..l``). Edge-frame features are
truncated to ``|m| <= mmax`` and kept m-primary. All index bookkeeping is
numpy, built once per (lmax, mmax); ``as_const`` hands it to a device once.

Only the J-factorised ``EdgeFrame`` path is ported: the deterministic,
gamma-free frame ``R = Ry(-beta) Rz(-phi)`` and the rotations
``D = J Z(-beta) J^T Z(-phi)`` with the m-flip folded into the constants.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from singa_tpu_torch.equivariant.wigner import _load_jd

_CONSTS: dict = {}


def as_const(arr: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy constant as a tensor on ``device``, copied there once.

    Keyed on the array's identity: callers pass arrays owned by the cached
    layout objects below, which live as long as the process."""
    key = (id(arr), str(torch.device(device)), dtype)
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not arr:
        hit = (arr, torch.as_tensor(np.asarray(arr), dtype=dtype, device=device))
        _CONSTS[key] = hit
    return hit[1]


def num_coeffs(lmax: int) -> int:
    return (lmax + 1) ** 2


def num_coeffs_trunc(lmax: int, mmax: int) -> int:
    return sum(2 * min(l, mmax) + 1 for l in range(lmax + 1))


@functools.lru_cache(maxsize=None)
class CoefficientMapping:
    """Static index bookkeeping for one (lmax, mmax) resolution.

    m-primary (on truncated): ``m=0`` coeffs for all l, then for each
    ``m=1..mmax`` the cos (+m) coeffs for ``l=m..lmax`` followed by the sin
    (-m) coeffs — the blocking the SO(2) convolutions need.
    """

    def __init__(self, lmax: int, mmax: int):
        self.lmax = lmax
        self.mmax = mmax
        self.n_full = num_coeffs(lmax)
        self.n_trunc = num_coeffs_trunc(lmax, mmax)

        self.trunc_offset = []
        off = 0
        for l in range(lmax + 1):
            self.trunc_offset.append(off)
            off += 2 * min(l, mmax) + 1

        def t_idx(l: int, m: int) -> int:
            mm = min(l, mmax)
            if not -mm <= m <= mm:
                raise ValueError(f"order {m} outside |m| <= {mm} at degree {l}")
            return self.trunc_offset[l] + (m + mm)

        perm = []
        self.m_size = []
        for l in range(lmax + 1):
            perm.append(t_idx(l, 0))
        self.m_size.append(lmax + 1)
        for m in range(1, mmax + 1):
            ls = list(range(m, lmax + 1))
            self.m_size.append(len(ls))
            for l in ls:  # cos (+m) part
                perm.append(t_idx(l, m))
            for l in ls:  # sin (-m) part
                perm.append(t_idx(l, -m))
        self.l_to_m = np.asarray(perm, dtype=np.int32)
        inv = np.zeros_like(self.l_to_m)
        inv[self.l_to_m] = np.arange(self.n_trunc, dtype=np.int32)
        self.m_to_l = inv

        self.m0_trunc = np.asarray(
            [t_idx(l, 0) for l in range(lmax + 1)], dtype=np.int32
        )
        self.l_of_full = np.asarray(
            [l for l in range(lmax + 1) for _ in range(2 * l + 1)], dtype=np.int32
        )
        self.l_of_trunc = np.asarray(
            [l for l in range(lmax + 1) for _ in range(2 * min(l, mmax) + 1)],
            dtype=np.int32,
        )
        # rescale applied when rotating back with truncated m (reference
        # EF_layers.py:1530-1549): sqrt((2l+1)/(2mmax+1)) for l > mmax.
        scale = np.ones(lmax + 1)
        for l in range(lmax + 1):
            if l > mmax:
                scale[l] = np.sqrt((2 * l + 1) / (2 * mmax + 1))
        self.rotate_inv_rescale = scale[self.l_of_full].astype(np.float32)


@functools.lru_cache(maxsize=None)
class _JLayout:
    """Constants for J-factorised rotations at one (lmax, mmax).

    For any constant M and z-rotation z(th, u) = c(th)*u - s(th)*(F u)
    (c/s diagonal in m, F the m-flip), M z(th, u) = M (c*u) + (M F)(s*u):
    the two halves stack along the contraction axis, so a z-rotation followed
    by a constant matrix is one matmul against ``[M | MF]``.
    """

    def __init__(self, lmax: int, mmax: int):
        jd = _load_jd()
        if lmax >= len(jd):
            raise ValueError(f"lmax={lmax} exceeds the shipped J constants ({len(jd) - 1})")
        n_full = num_coeffs(lmax)
        J = np.zeros((n_full, n_full), np.float32)
        for l in range(lmax + 1):
            s = l * l
            J[s : s + 2 * l + 1, s : s + 2 * l + 1] = jd[l]
        self.J = J
        keep = []
        for l in range(lmax + 1):
            mm = min(l, mmax)
            for m in range(-mm, mm + 1):
                keep.append(l * l + (m + l))
        self.J_kept = J[np.asarray(keep, np.int32)]  # [n_trunc, n_full]
        self.m_of = np.concatenate(
            [np.arange(-l, l + 1) for l in range(lmax + 1)]
        ).astype(np.float32)
        self.flip = np.concatenate(
            [l * l + np.arange(2 * l, -1, -1) for l in range(lmax + 1)]
        ).astype(np.int32)
        self.inv_rescale = CoefficientMapping(lmax, mmax).rotate_inv_rescale
        self.J_kept_m = self.J_kept[CoefficientMapping(lmax, mmax).l_to_m]

        F = np.zeros_like(J)
        F[np.arange(n_full), self.flip] = 1.0
        self.rot_stage1 = np.concatenate([J.T, J.T @ F], axis=1)  # [n, 2n]
        self.rot_stage2 = np.concatenate([self.J_kept, self.J_kept @ F], axis=1)
        self.rot_stage2_m = np.concatenate(
            [self.J_kept_m, self.J_kept_m @ F], axis=1
        )
        # rotate_inv needs both v = J w and F v in one pass (w = z(beta, u)):
        # [[J, JF], [FJ, FJF]] @ [c*u; s*u] -> [v; Fv]
        JF = J @ F
        self.inv_stage2 = np.block([[J, JF], [F @ J, F @ JF]])  # [2n, 2n]


class EdgeFrame(NamedTuple):
    """Per-edge frame as (azimuth, polar) angles; the frame rotation
    ``R = Ry(-beta) Rz(-phi)`` maps the edge direction onto +z."""

    phi: torch.Tensor  # [E]
    beta: torch.Tensor  # [E]


def edge_frame(edge_vec: torch.Tensor, eps: float = 1e-8) -> EdgeFrame:
    """Deterministic gamma-free edge frame angles from edge vectors [E, 3]."""
    v = edge_vec.float()
    n = torch.linalg.vector_norm(v, dim=-1)
    vn = v / torch.clamp(n, min=eps)[:, None]
    beta = torch.arccos(torch.clamp(vn[:, 2], -1.0, 1.0))
    phi = torch.where(n > eps, torch.atan2(vn[:, 1], vn[:, 0]), torch.zeros_like(n))
    return EdgeFrame(phi=phi, beta=beta)


def _z_parts(theta: torch.Tensor, t: torch.Tensor, m_of: torch.Tensor) -> torch.Tensor:
    """[c(theta)*t ; s(theta)*t] stacked on the coefficient axis."""
    ang = m_of[None] * theta[:, None]
    cm = torch.cos(ang).to(t.dtype)
    sm = torch.sin(ang).to(t.dtype)
    return torch.cat([cm[..., None] * t, sm[..., None] * t], dim=1)


def rotate(
    frame: EdgeFrame, x: torch.Tensor, lmax: int, mmax: int, m_primary: bool = False
) -> torch.Tensor:
    """Rotate full l-primary features ``[E, (lmax+1)^2, C]`` into the
    truncated edge frame ``[E, n_trunc, C]`` (m-primary if asked)."""
    lay = _JLayout(lmax, mmax)
    dev, dt = x.device, x.dtype
    m_of = as_const(lay.m_of, dev)
    ab = _z_parts(-frame.phi, x, m_of)
    t = torch.matmul(as_const(lay.rot_stage1, dev, dt), ab)
    ab = _z_parts(-frame.beta, t, m_of)
    jk2 = lay.rot_stage2_m if m_primary else lay.rot_stage2
    return torch.matmul(as_const(jk2, dev, dt), ab)


def rotate_inv(
    frame: EdgeFrame,
    x: torch.Tensor,
    lmax: int,
    mmax: int,
    rescale: bool = True,
    m_primary: bool = False,
) -> torch.Tensor:
    """Rotate truncated edge-frame features back: ``[E, n_trunc, C] ->
    [E, (lmax+1)^2, C]`` via D^T, with the m-truncation rescale."""
    lay = _JLayout(lmax, mmax)
    dev, dt = x.device, x.dtype
    n_full = lay.J.shape[0]
    m_of = as_const(lay.m_of, dev)
    jk = lay.J_kept_m if m_primary else lay.J_kept
    u = torch.matmul(as_const(jk, dev, dt).T, x)
    ab = _z_parts(frame.beta, u, m_of)
    vv = torch.matmul(as_const(lay.inv_stage2, dev, dt), ab)
    v, fv = vv[:, :n_full], vv[:, n_full:]
    ang = m_of[None] * frame.phi[:, None]
    cm = torch.cos(ang).to(dt)
    sm = torch.sin(ang).to(dt)
    t = cm[..., None] * v - sm[..., None] * fv
    if rescale:
        t = t * as_const(lay.inv_rescale, dev, dt)[None, :, None]
    return t
