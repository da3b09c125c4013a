"""Shuffle-and-batch over aligned in-memory arrays.

Port of ``adunet/data/array_dataset.py``: ``ArrayDataset`` yields tuples of
numpy batches, one per array, in the same order as the reference's: with
``shuffle`` the n-th pass is permuted by ``np.random.default_rng(seed + n)``;
``drop_remainder`` drops a short last batch and refuses fewer samples than
one batch. ``make_array_dataset`` is the reference's ``(lr, hr, indices)``
constructor.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence, Tuple

import numpy as np

__all__ = ["ArrayDataset", "make_array_dataset"]


class ArrayDataset:
    """Re-iterable batches of aligned arrays; each pass reshuffles."""

    def __init__(self, *arrays: np.ndarray, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = False):
        if not arrays:
            raise ValueError("At least one array required.")
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("All arrays must share the leading dimension.")
        if drop_remainder and n < batch_size:
            raise ValueError(f"drop_remainder=True but only {n} samples for "
                             f"batch_size={batch_size} — not enough for one full batch.")
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self.steps_per_epoch = n // batch_size if drop_remainder else math.ceil(n / batch_size)

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_remainder and len(idx) < self.batch_size:
                return
            yield tuple(a[idx] for a in self.arrays)


def make_array_dataset(lr_images: np.ndarray, hr_images: np.ndarray, indices: Sequence[int],
                       batch_size: int, shuffle: bool, seed: int) -> ArrayDataset:
    """``(lr, hr)`` batches of the samples at ``indices``."""
    idx = np.asarray(indices)
    return ArrayDataset(lr_images[idx], hr_images[idx], batch_size=batch_size, shuffle=shuffle,
                        seed=seed)
