"""Natural-order sorting and seeded dataset splits.

The port's own copy of ``adunet/utils/misc.py`` (which imports no JAX, but
the port imports nothing of the reference package). ``split_indices`` keeps
the reference's RNG stream (``np.random.default_rng(seed).shuffle`` over
``arange``), so a seed splits a corpus the same way in both packages.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Tuple

import numpy as np

__all__ = ["sorted_alphanumeric", "split_indices"]


def sorted_alphanumeric(items: Iterable[str]) -> List[str]:
    """Sort strings so entries with embedded numbers follow numeric order.
    Keys alternate (str, int, str, ...) with a leading string, so a name that
    starts with a digit compares with one that starts with a letter."""

    def split_key(text: str):
        parts = re.split(r"(\d+)", text)  # even idx: non-digit (may be ''), odd: digits
        return [int(p) if i % 2 else p.lower() for i, p in enumerate(parts)]

    return sorted(items, key=split_key)


def split_indices(
    n_samples: int, train: float, val: float, test: float, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded shuffle → fractional train/val/test split, keeping at least one
    val and one test element when possible (the reference's guards)."""
    if not 0 < train < 1:
        raise ValueError("train fraction: expected a value inside [0, 1].")
    if not 0 <= val < 1 or not 0 <= test < 1:
        raise ValueError("val/test fractions: expected values inside [0, 1].")
    total = train + val + test
    if total <= 0:
        raise ValueError("split fractions sum to zero: nothing to split.")

    rng = np.random.default_rng(seed)
    indices = np.arange(n_samples)
    rng.shuffle(indices)

    train_count = int(round(n_samples * train / total))
    val_count = int(round(n_samples * val / total))
    train_count = min(train_count, n_samples - 2) if n_samples > 2 else train_count
    val_count = (
        min(val_count, n_samples - train_count - 1)
        if n_samples > (train_count + 1)
        else val_count
    )

    if train_count <= 0:
        raise ValueError("no indices left for the train split after val/test allocation.")

    train_idx = indices[:train_count]
    val_idx = indices[train_count : train_count + val_count]
    test_idx = indices[train_count + val_count :]
    return train_idx, val_idx, test_idx
