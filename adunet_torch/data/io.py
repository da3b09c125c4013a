"""Host-side image IO.

Port of ``adunet/data/io.py:45-110`` (``read_image_size``, ``_read_rgb``,
``load_rgb_image_full``, ``load_rgb_image_full_u8``). ``.npy`` arrays are
always read; PNG / JPEG need cv2 (BGR→RGB) or, without it, PIL, each
imported at first use. Without either a PNG / JPEG raises.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

__all__ = ["read_image_size", "load_rgb_image_full", "load_rgb_image_full_u8"]


def _have(module: str) -> bool:
    return importlib.util.find_spec(module) is not None


def read_image_size(path: str | Path) -> tuple:
    """(height, width) of an image without decoding its pixels where the
    format allows it: ``.npy`` reads the array header (mmap), PIL the file
    header; otherwise a full decode."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(str(path), mmap_mode="r")
        return (arr.shape[0], arr.shape[1])
    if _have("PIL"):
        from PIL import Image

        with Image.open(path) as im:
            width, height = im.size
        return (height, width)
    return _read_rgb(path).shape[:2]


def _read_rgb(path: Path) -> np.ndarray:
    """Decode to an RGB (H, W, 3) array (uint8 for image files)."""
    if path.suffix == ".npy":
        arr = np.load(str(path))
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr
    if _have("cv2"):
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"image failed to decode: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if _have("PIL"):
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    raise RuntimeError(f"no image decoder for {path} (need cv2 or PIL; .npy needs neither)")


def _to_float01(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def load_rgb_image_full(path: str | Path) -> np.ndarray:
    """RGB float32 in [0, 1] at native size."""
    return _to_float01(_read_rgb(Path(path)))


def load_rgb_image_full_u8(path: str | Path) -> np.ndarray:
    """RGB uint8 at native size; float sources are rounded to uint8."""
    arr = _read_rgb(Path(path))
    if arr.dtype == np.uint8:
        return arr
    if arr.dtype == np.uint16:
        return (arr // 257).astype(np.uint8)
    return np.clip(np.round(arr.astype(np.float32) * 255.0), 0, 255).astype(np.uint8)
