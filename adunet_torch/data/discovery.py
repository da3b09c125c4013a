"""File discovery and image / mask pairing.

The port's copy of ``adunet/data/discovery.py``: ``find_images`` (glob +
natural sort, :55), ``pair_lr_files`` (:28, the ``--low_res_dir`` pairing by
file name), ``collect_isic_pairs`` with its superpixel filter and
hard errors (:74-134), ``normalise_isic_key``, and ``canonical_key`` /
``discover_pairs`` (:137-189), the generic pairing of the vanilla trainer.
"""

from __future__ import annotations

import glob as _glob
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from adunet_torch.utils.misc import sorted_alphanumeric

__all__ = ["find_images", "pair_lr_files", "collect_isic_pairs", "normalise_isic_key", "canonical_key",
           "discover_pairs"]


def pair_lr_files(hr_paths: List[str], low_res_dir: str | Path) -> List[str]:
    """Each HR file's LR counterpart: the file of the same name in
    ``low_res_dir``. Any missing counterpart raises, naming up to five."""
    low_res_dir = Path(low_res_dir).expanduser()
    if not low_res_dir.is_dir():
        raise FileNotFoundError(f"Low-res directory not found: {low_res_dir}")
    lr_paths: List[str] = []
    missing: List[str] = []
    for hr in hr_paths:
        candidate = low_res_dir / Path(hr).name
        if candidate.is_file():
            lr_paths.append(str(candidate))
        else:
            missing.append(Path(hr).name)
    if missing:
        shown = ", ".join(missing[:5]) + ("…" if len(missing) > 5 else "")
        raise ValueError(f"Missing {len(missing)} LR counterparts in {low_res_dir}; examples: {shown}")
    return lr_paths


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


# ISIC-2017 ships JPEG photographs, PNG masks and *_superpixels sidecars;
# .npy is the decoded-array format both packages read
_ISIC_IMAGE_EXTS = frozenset({".jpg", ".jpeg", ".png", ".npy"})
_ISIC_MASK_EXTS = frozenset({".png", ".jpg", ".npy"})
_MASK_TOKEN = "_segmentation"


def normalise_isic_key(path: Path) -> str:
    """Lower-case ISIC identifier without the segmentation token."""
    return path.stem.lower().replace(_MASK_TOKEN, "")


def _isic_inventory(directory: Path, role: str) -> List[Path]:
    """The usable files of one ISIC directory: ``role="image"`` keeps any
    supported file that is not a superpixel sidecar, ``role="mask"`` the
    files whose stem ends with ``_segmentation``."""
    if not directory.exists():
        raise FileNotFoundError(f"ISIC {role} directory is absent: {directory}")
    allowed = _ISIC_IMAGE_EXTS if role == "image" else _ISIC_MASK_EXTS
    keep: List[Path] = []
    for entry in directory.iterdir():
        if not entry.is_file() or entry.suffix.lower() not in allowed:
            continue
        stem = entry.stem.lower()
        if role == "image" and "superpixels" in stem:
            continue
        if role == "mask" and not stem.endswith(_MASK_TOKEN):
            continue
        keep.append(entry)
    if not keep:
        raise FileNotFoundError(f"no usable ISIC {role} files under {directory}")
    return keep


def collect_isic_pairs(image_dir: str | Path, mask_dir: str | Path) -> List[Tuple[str, str]]:
    """Pair each image with its ``*_segmentation`` mask, ordered by the
    lower-cased image stem. A key shared by several masks takes the
    lexicographically last name; any image without a mask raises, naming up
    to five."""
    images = sorted(_isic_inventory(Path(image_dir), "image"), key=lambda p: p.stem.lower())
    masks_by_key: Dict[str, Path] = {}
    for mask in sorted(_isic_inventory(Path(mask_dir), "mask"),
                       key=lambda p: (normalise_isic_key(p), p.name)):
        masks_by_key[normalise_isic_key(mask)] = mask

    keyed_images = [(normalise_isic_key(p), p) for p in images]
    unmatched = [p.name for key, p in keyed_images if key not in masks_by_key]
    if unmatched:
        shown = ", ".join(unmatched[:5])
        more = "" if len(unmatched) <= 5 else f", +{len(unmatched) - 5} more"
        raise ValueError(
            f"Missing {len(unmatched)} segmentation masks in {mask_dir} "
            f"(unmatched images: {shown}{more})"
        )
    return [(str(p), str(masks_by_key[key])) for key, p in keyed_images]


_CANONICAL_TOKENS = [
    "_segmentation",
    "_mask",
    "_leftimg8bit",
    "_gtfine_labelids",
    "_gtfine_polygons",
    "_gtfine_color",
    "_gtfine_instanceids",
    "_gtcoarse_labelids",
    "_gtcoarse_color",
    "_gtcoarse_instanceids",
    "_instanceids",
]


def canonical_key(path: Path) -> str:
    """A stem without the dataset suffix tokens (ISIC and Cityscapes)."""
    stem = path.stem.lower()
    for token in _CANONICAL_TOKENS:
        stem = stem.replace(token, "")
    return stem


def discover_pairs(
    image_dir: str | Path,
    mask_dir: str | Path,
    image_suffix: str = ".jpg",
    mask_suffix: str = "_segmentation.png",
    limit: Optional[int] = None,
) -> List[Tuple[str, str]]:
    """Recursive image / mask pairing by canonical stem, images in natural order."""
    image_dir = Path(image_dir)
    mask_dir = Path(mask_dir)
    image_candidates = [str(p) for p in image_dir.rglob(f"*{image_suffix}") if p.is_file()]
    image_paths = [Path(p) for p in sorted_alphanumeric(image_candidates)]
    mask_lookup = {canonical_key(p): p for p in mask_dir.rglob(f"*{mask_suffix}") if p.is_file()}

    if not image_paths:
        raise ValueError(f"found no *{image_suffix} images under {image_dir}")
    if not mask_lookup:
        raise ValueError(f"found no *{mask_suffix} masks under {mask_dir}")

    pairs: List[Tuple[str, str]] = []
    for image_path in image_paths:
        key = canonical_key(image_path)
        mask_path = mask_lookup.get(key)
        if mask_path is None:
            raise ValueError(f"no mask pairs with image {image_path.name} (looked for key {key})")
        pairs.append((str(image_path), str(mask_path)))

    if limit is not None:
        pairs = pairs[:limit]
    return pairs
