"""The constant ``J_l = D_l(Rx(-pi/2))`` blocks of the factorised Wigner
rotations (counterpart of ``singa_tpu/equivariant/wigner.py::_load_jd``).
The port ships its own copy of ``jd.npz``."""
from __future__ import annotations

import functools
import os

import numpy as np


@functools.lru_cache(maxsize=None)
def _load_jd() -> tuple[np.ndarray, ...]:
    path = os.path.join(os.path.dirname(__file__), "jd.npz")
    with np.load(path) as data:
        lmax = int(data["lmax"])
        return tuple(data[f"J{l}"] for l in range(lmax + 1))
