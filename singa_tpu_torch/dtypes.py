"""Compute-dtype policy for mixed precision (counterpart of
``singa_tpu/dtypes.py``).

Parameters, positions, distances, the optimizer state and checkpoints stay
float32; network compute runs in ``compute_dtype()`` at the sites where the
JAX package casts (its ``Linear``/``Embed`` with ``dtype=compute_dtype()``,
its ``.astype(dt)`` before the SO(3)/SO(2) products, the grouped
projections and the kernels). Modules read the policy at every call;
``set_compute_dtype`` switches it and ``compute_dtype_scope`` switches it
for a block. The default is float32, so nothing changes until a caller asks.
"""
from __future__ import annotations

import contextlib

import torch

_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_COMPUTE_DTYPE = torch.float32


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NAMES[str(dtype)]


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def set_compute_dtype(dtype) -> None:
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = as_dtype(dtype)


def rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back to float32: a plain kernel twin's
    ``.astype(dt)`` of the TPU kernel, whose arithmetic goes on in float32."""
    return t.to(dtype).float()


@contextlib.contextmanager
def compute_dtype_scope(dtype):
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    set_compute_dtype(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev
