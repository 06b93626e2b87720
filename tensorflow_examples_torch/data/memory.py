"""In-memory datasets: deterministic shuffling train iterator + eval batches.

A copy of ``tensorflow_examples_tpu/data/memory.py`` (numpy only, so the
port keeps its own copy instead of importing the JAX package). Batch
order is a pure function of (seed, epoch), so resuming from step N
reproduces the exact batch sequence of the uninterrupted run, and the
port's batches equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping

import numpy as np


@dataclasses.dataclass
class InMemoryDataset:
    """A dict of equally-long numpy arrays (e.g. {'tokens': ...})."""

    arrays: Mapping[str, np.ndarray]

    def __post_init__(self):
        sizes = {k: len(v) for k, v in self.arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged dataset: {sizes}")

    @property
    def size(self) -> int:
        return len(next(iter(self.arrays.values())))


def train_iterator(
    ds: InMemoryDataset,
    batch_size: int,
    *,
    seed: int = 0,
    start_step: int = 0,
    augment=None,
) -> Iterator[dict[str, np.ndarray]]:
    """Infinite shuffled batches; order is a pure function of (seed, epoch)."""
    n = ds.size
    if batch_size > n:
        raise ValueError(f"batch {batch_size} > dataset {n}")
    steps_per_epoch = n // batch_size
    step = start_step
    while True:
        epoch = step // steps_per_epoch
        order = np.random.default_rng(seed + epoch).permutation(n)
        while step // steps_per_epoch == epoch:
            i = (step % steps_per_epoch) * batch_size
            idx = order[i : i + batch_size]
            batch = {k: v[idx] for k, v in ds.arrays.items()}
            if augment is not None:
                batch = augment(batch, np.random.default_rng((seed, step)))
            yield batch
            step += 1


def eval_batches(
    ds: InMemoryDataset, batch_size: int, *, drop_remainder: bool = False
) -> Iterator[dict[str, np.ndarray]]:
    """One sequential pass; the final partial batch is padded with
    weight 0 (a ``mask`` entry), so every batch has the same shape."""
    n = ds.size
    for i in range(0, n, batch_size):
        batch = {k: v[i : i + batch_size] for k, v in ds.arrays.items()}
        actual = len(next(iter(batch.values())))
        if actual < batch_size:
            if drop_remainder:
                return
            pad = batch_size - actual
            batch = {
                k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                for k, v in batch.items()
            }
            mask = np.concatenate([np.ones(actual), np.zeros(pad)])
        else:
            mask = np.ones(actual)
        batch["mask"] = mask.astype(np.float32)
        yield batch
