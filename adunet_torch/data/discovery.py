"""File discovery: ``find_images``, the port's copy of
``adunet/data/discovery.py:55`` (glob + natural sort)."""

from __future__ import annotations

import glob as _glob
from pathlib import Path
from typing import List, Optional

from adunet_torch.utils.misc import sorted_alphanumeric

__all__ = ["find_images"]


def find_images(directory: str | Path, suffix: str = ".png", limit: Optional[int] = None) -> List[str]:
    directory = Path(directory).expanduser()
    if not directory.exists():
        raise FileNotFoundError(f"Image directory not found: {directory}")
    paths = sorted_alphanumeric(_glob.glob(str(directory / f"*{suffix}")))
    if limit is not None and limit > 0:
        paths = paths[:limit]
    if not paths:
        raise ValueError(f"found no *{suffix} images under {directory}")
    return paths
