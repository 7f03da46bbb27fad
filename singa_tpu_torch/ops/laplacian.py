"""Laplacian positional encodings, computed once per graph on the host
(counterpart of ``singa_tpu/ops/laplacian.py::laplacian_pe_numpy``; the
reference runs ``dgl.lap_pe(g, 8)`` every forward, model/CProMG.py:562-571).
"""
from __future__ import annotations

import numpy as np


def laplacian_pe_numpy(
    edge_index: np.ndarray,
    num_nodes: int,
    k: int = 8,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """k smallest non-trivial eigenvectors of the symmetric-normalised Laplacian.

    Matches DGL ``lap_pe`` semantics: L = I - D^-1/2 A D^-1/2 on the undirected
    simple graph; eigenvectors of the k smallest non-zero eigenvalues, padded
    with zeros when the graph has fewer than k+1 nodes; random sign flip per
    eigenvector (sign is arbitrary), drawn from ``rng`` (seed 0 by default).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    A = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    if edge_index.size:
        A[edge_index[0], edge_index[1]] = 1.0
        A[edge_index[1], edge_index[0]] = 1.0
    np.fill_diagonal(A, 0.0)
    deg = A.sum(axis=1)
    inv_sqrt = np.where(deg > 0, deg, 1.0) ** -0.5
    L = np.eye(num_nodes) - (inv_sqrt[:, None] * A * inv_sqrt[None, :])
    vals, vecs = np.linalg.eigh(L)
    order = np.argsort(vals)
    # Skip the trivial (near-zero) eigenvector, take the next k.
    take = order[1 : k + 1]
    pe = np.zeros((num_nodes, k), dtype=np.float32)
    got = vecs[:, take].astype(np.float32)
    sign = rng.choice([-1.0, 1.0], size=got.shape[1]).astype(np.float32)
    pe[:, : got.shape[1]] = got * sign
    return pe
