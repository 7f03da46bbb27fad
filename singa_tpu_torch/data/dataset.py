"""Datasets: the ``.npz`` shard readers (the ETL contract) and the synthetic
generator (counterpart of ``singa_tpu/data/dataset.py``).

Each complex is one ``.npz`` with the fixed-shape ``ComplexBatch`` fields
(unbatched); batching is a stack, done on the host, tables included. The
order of files and batches follows the JAX package draw for draw (the same
numpy ``default_rng`` calls), so one seed gives both packages the same
batches.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from singa_tpu_torch.config import ShapeConfig
from singa_tpu_torch.data.batch import ComplexBatch, load_npz, synthetic_batch


def _npz_files(root: str) -> list[str]:
    files = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".npz"))
    if not files:
        raise FileNotFoundError(f"no .npz complexes under {root}")
    return files


def _upsample(order: np.ndarray, batch_size: int, rng) -> np.ndarray:
    """Pad a (shuffled) index/path array to at least one full batch by
    sampling existing entries with replacement. No-op when already full."""
    if len(order) >= batch_size:
        return order
    extra = rng.choice(order, size=batch_size - len(order), replace=True)
    return np.concatenate([order, extra])


class NpzDataset:
    """Directory of ``.npz`` complexes -> shuffled fixed-size CPU batches."""

    def __init__(self, root: str, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.files = _npz_files(root)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return max(1, len(self.files) // self.batch_size)

    def plans(self) -> list[list[str]]:
        """The files of each batch of the next epoch (advances the rng)."""
        order = np.arange(len(self.files))
        if self.shuffle:
            self.rng.shuffle(order)
        # a dataset smaller than one batch upsamples with replacement to one
        # full batch: every batch has exactly batch_size graphs
        order = _upsample(order, self.batch_size, self.rng)
        return [
            [self.files[i] for i in order[s : s + self.batch_size]]
            for s in range(0, len(order) - self.batch_size + 1, self.batch_size)
        ]

    def epoch(self) -> Iterator[ComplexBatch]:
        for plan in self.plans():
            yield load_npz(plan)

    def __iter__(self):
        while True:
            yield from self.epoch()


class BucketedNpzDataset:
    """Mixed pocket-size shards -> homogeneous fixed-shape batches per bucket.

    Files are grouped by (protein node capacity, protein edge capacity), as
    the JAX package groups them; each bucket is shuffled on its own, and the
    batches of all buckets are shuffled together, so an epoch visits every
    complex once."""

    def __init__(self, root: str, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.buckets: dict[tuple, list[str]] = {}
        for path in _npz_files(root):
            with np.load(path) as z:
                sig = (z["protein.x"].shape[0], z["pp.index"].shape[0])
            self.buckets.setdefault(sig, []).append(path)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return sum(max(1, len(v) // self.batch_size) for v in self.buckets.values())

    def plans(self) -> list[list[str]]:
        """The files of each batch of the next epoch (advances the rng)."""
        plans: list[list[str]] = []
        for sig in sorted(self.buckets):
            order = np.array(self.buckets[sig], dtype=object)
            if self.shuffle:
                self.rng.shuffle(order)
            order = _upsample(order, self.batch_size, self.rng)
            for s in range(0, len(order) - self.batch_size + 1, self.batch_size):
                plans.append(list(order[s : s + self.batch_size]))
        if self.shuffle:
            self.rng.shuffle(plans)
        return plans

    def epoch(self) -> Iterator[ComplexBatch]:
        for plan in self.plans():
            yield load_npz(plan)

    def __iter__(self):
        while True:
            yield from self.epoch()


class SyntheticDataset:
    """Endless synthetic CPU batches (smoke training)."""

    def __init__(
        self,
        batch_size: int,
        shapes: ShapeConfig | None = None,
        tgt_len: int = 200,
        seed: int = 0,
        num_distinct: int = 8,
    ):
        self.batches = [
            synthetic_batch(seed + i, batch_size, shapes, tgt_len) for i in range(num_distinct)
        ]

    def __len__(self):
        return len(self.batches)

    def epoch(self) -> Iterator[ComplexBatch]:
        yield from self.batches

    def __iter__(self):
        i = 0
        while True:
            yield self.batches[i % len(self.batches)]
            i += 1
