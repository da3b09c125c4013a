"""Host-side image IO.

Port of ``adunet/data/io.py`` (``read_image_size``, ``_read_rgb``,
``load_rgb_image_full``, ``load_rgb_image_full_u8``, ``load_rgb_image`` with
its square resize, ``load_image_stack`` (a directory of square-resized
images, the vanilla SR trainer's), and for segmentation ``_read_gray``,
``_nearest_resize``, ``load_mask``, ``load_label_mask``). ``.npy`` arrays are
always read; PNG / JPEG need cv2 (BGR→RGB) or, without it, PIL. Which of
the two there is, is decided once, when this module is imported, as the
reference decides (``adunet/data/io.py:19-32``): decode threads must not
probe for cv2 while another thread is still importing it. Without either a
PNG / JPEG raises. Resizes go
through cv2 where it is importable, as in the reference, and otherwise
through the same sampling matrices the reference falls back to
(``adunet_torch.ops.resize.resize_matrix``), so a batch is byte for byte the
reference's on the same host.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from adunet_torch.utils.misc import sorted_alphanumeric

try:
    import cv2
except ImportError:
    cv2 = None
try:
    from PIL import Image
except ImportError:
    Image = None

__all__ = [
    "read_image_size",
    "load_rgb_image",
    "load_image_stack",
    "load_rgb_image_full",
    "load_rgb_image_full_u8",
    "load_mask",
    "load_label_mask",
]


def read_image_size(path: str | Path) -> tuple:
    """(height, width) of an image without decoding its pixels where the
    format allows it: ``.npy`` reads the array header (mmap), PIL the file
    header; otherwise a full decode."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(str(path), mmap_mode="r")
        return (arr.shape[0], arr.shape[1])
    if Image is not None:
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
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"image failed to decode: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if Image is not None:
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


def load_rgb_image(path: str | Path, size: int, interp: str = "area") -> np.ndarray:
    """RGB float32 in [0, 1], resized to (size, size): ``interp="area"``
    (cv2 INTER_AREA, the protocol trainer's) or ``"linear"`` (INTER_LINEAR,
    the vanilla trainer's)."""
    img = _read_rgb(Path(path))
    cv2_interp = {"area": "INTER_AREA", "linear": "INTER_LINEAR"}
    if interp not in cv2_interp:
        raise ValueError(f"unknown interp {interp!r} (expected area|linear)")
    if cv2 is not None:
        img = cv2.resize(img, (size, size), interpolation=getattr(cv2, cv2_interp[interp]))
        return _to_float01(img)
    img = _to_float01(img)
    from adunet_torch.ops.resize import resize_matrix

    method = "area" if interp == "area" else "bilinear"
    wh = resize_matrix(img.shape[0], size, method)
    ww = resize_matrix(img.shape[1], size, method)
    return np.einsum("ih,hwc->iwc", wh, np.einsum("jw,hwc->hjc", ww, img)).astype(np.float32)


def load_image_stack(directory: str | Path, size: int, limit: Optional[int] = None) -> np.ndarray:
    """Every file of ``directory`` in natural order (the first ``limit``),
    area-resized to (size, size): an (N, size, size, 3) float32 stack."""
    directory = Path(directory)
    names = sorted_alphanumeric([p.name for p in directory.iterdir() if p.is_file()])
    if limit is not None:
        names = names[:limit]
    images: List[np.ndarray] = [load_rgb_image(directory / n, size) for n in names]
    if not images:
        raise ValueError(f"found no images under {directory}")
    return np.stack(images, axis=0)


def _read_gray(path: Path) -> np.ndarray:
    """Decode a mask file to a 2-D array, no resize."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(str(path))
    elif cv2 is not None:
        arr = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if arr is None:
            raise FileNotFoundError(f"mask failed to decode: {path}")
    elif Image is not None:
        with Image.open(path) as im:
            arr = np.asarray(im.convert("L"))
    else:
        raise RuntimeError(f"no image decoder for {path} (need cv2 or PIL; .npy needs neither)")
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def _nearest_resize(arr: np.ndarray, size: int) -> np.ndarray:
    if arr.shape[:2] == (size, size):
        return arr
    if cv2 is not None and arr.dtype != np.int64:
        return cv2.resize(arr, (size, size), interpolation=cv2.INTER_NEAREST)
    ys = (np.arange(size) * arr.shape[0] // size).clip(0, arr.shape[0] - 1)
    xs = (np.arange(size) * arr.shape[1] // size).clip(0, arr.shape[1] - 1)
    return arr[np.ix_(ys, xs)]


def load_label_mask(path: str | Path, size: int, num_classes: int) -> np.ndarray:
    """Integer class ids (nearest resize) → one-hot float32 (size, size,
    num_classes); ids at or above ``num_classes`` go to the last class."""
    arr = _nearest_resize(_read_gray(Path(path)), size)
    labels = np.clip(arr.astype(np.int64), 0, num_classes - 1)
    return np.eye(num_classes, dtype=np.float32)[labels]


def load_mask(path: str | Path, size: int, threshold: float = 0.5) -> np.ndarray:
    """Binary mask float32 (size, size, 1): nearest resize, binarised at 0.5."""
    mask = _to_float01(_nearest_resize(_read_gray(Path(path)), size))
    return (mask > threshold).astype(np.float32)[..., None]
