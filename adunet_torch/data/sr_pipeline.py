"""The grid-tile evaluation stream of the SR trainer.

Port of ``adunet/data/sr_pipeline.py:186-274`` (``GridPatchDataset``,
``make_eval_patch_dataset``): a finite iterator of (B, P, P, 3) float32 HR
patch batches, tiled per image at a stride, with ``"<file>#patch0007"``
labels counted from image headers before any pixel is decoded. The LR side
is made on the device by the eval / val step. The streamed random-patch
training pipeline (``TrainingPatchDataset``) is not ported yet (ROADMAP
Queue 1 item 7): the port trains from the device cache.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from adunet_torch.data.io import load_rgb_image_full, read_image_size
from adunet_torch.data.patches import grid_patch_count, grid_patches

__all__ = ["GridPatchDataset", "make_eval_patch_dataset"]


class GridPatchDataset:
    """Finite, re-iterable stream of (B, P, P, 3) HR patch batches."""

    def __init__(self, hr_files: Sequence[str], patch_size: int, scale: float,
                 batch_size: int, stride: Optional[int] = None):
        hr_files = list(hr_files)
        if not hr_files:
            raise ValueError("empty hr_files list: need at least one training image.")
        stride = stride or patch_size
        if stride <= 0:
            raise ValueError("stride: expected a value >= 1.")
        self.hr_files = hr_files
        self.patch_size = patch_size
        self.scale = float(scale)
        self.batch_size = batch_size
        self.stride = stride
        self.patch_labels: List[str] = []
        for path in hr_files:
            h, w = read_image_size(path)
            n = grid_patch_count(h, w, patch_size, stride=stride)
            stem = Path(path).name
            self.patch_labels.extend(f"{stem}#patch{i:04d}" for i in range(n))
        self.total_patches = len(self.patch_labels)

    def __iter__(self) -> Iterator[np.ndarray]:
        pending: List[np.ndarray] = []
        for path in self.hr_files:
            image = load_rgb_image_full(path)
            for patch in grid_patches(image, self.patch_size, stride=self.stride):
                pending.append(patch)
                if len(pending) == self.batch_size:
                    yield np.stack(pending, axis=0)
                    pending = []
        if pending:
            yield np.stack(pending, axis=0)


def make_eval_patch_dataset(hr_files: Sequence[str], patch_size: int, scale: float,
                            batch_size: int, *, stride: Optional[int] = None
                            ) -> Tuple[GridPatchDataset, int, List[str]]:
    """(dataset, patch count, patch labels) — the reference's signature."""
    ds = GridPatchDataset(hr_files, patch_size, scale, batch_size, stride)
    return ds, ds.total_patches, ds.patch_labels
