"""Deterministic shuffled epoch batching over aligned numpy arrays.

Counterpart of `repro.data.pipeline.BatchIterator` without the mesh
placement: batches are dicts of numpy arrays, and the caller moves them
to its device. The shuffle comes from `numpy.random.default_rng(seed)`;
JAX's iterator draws the same generator, seeded 0 when given no key, so
``seed=0`` yields JAX's ``key=None`` batch order.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchIterator:
    """Shuffled epoch iterator over arrays that share their first axis."""

    def __init__(self, arrays: dict, batch_size: int, *, seed=0,
                 drop_last: bool = True):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        sizes = {v.shape[0] for v in self.arrays.values()}
        if len(sizes) != 1:
            raise ValueError(f"misaligned arrays: "
                             f"{ {k: v.shape for k, v in self.arrays.items()} }")
        self.n = sizes.pop()
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return int(np.ceil(self.n / self.batch_size))

    def epoch(self) -> Iterator[dict]:
        order = self._rng.permutation(self.n)
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield {k: v[idx] for k, v in self.arrays.items()}

    def forever(self) -> Iterator[dict]:
        while True:
            yield from self.epoch()
