"""Dataset path configuration (port of ``adunet/configs/paths.py``).

Replaces the reference's hard-coded cluster constants
(Super_resolution/code/dataset_paths.py:13-31,
Segmenation/code/dataset_paths.py:13-35) with env-var-driven defaults, so
the same three-tier override story holds (defaults → env → CLI flags)
without baking machine-specific paths into the source. The reference's
``MODEL_ROOT`` relative-path bug (missing leading '/') is deliberately not
reproduced.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = [
    "HR_TRAIN_DIR",
    "HR_VALID_DIR",
    "LR_TRAIN_DIR",
    "TRAIN_IMAGE_DIR",
    "TRAIN_MASK_DIR",
    "VALID_IMAGE_DIR",
    "VALID_MASK_DIR",
    "TEST_IMAGE_DIR",
    "TEST_MASK_DIR",
    "MODEL_ROOT",
    "LOG_ROOT",
]


def _env_path(name: str, default: str) -> Path:
    return Path(os.environ.get(name, default)).expanduser()


# DIV2K (super-resolution)
HR_TRAIN_DIR = _env_path("ADUNET_HR_TRAIN_DIR", "data/DIV2K/DIV2K_train_HR")
HR_VALID_DIR = _env_path("ADUNET_HR_VALID_DIR", "data/DIV2K/DIV2K_valid_HR")
LR_TRAIN_DIR = _env_path("ADUNET_LR_TRAIN_DIR", "data/DIV2K/DIV2K_train_LR")

# ISIC-2017 (segmentation)
TRAIN_IMAGE_DIR = _env_path("ADUNET_ISIC_TRAIN_IMAGES", "data/ISIC2017/train/images")
TRAIN_MASK_DIR = _env_path("ADUNET_ISIC_TRAIN_MASKS", "data/ISIC2017/train/masks")
VALID_IMAGE_DIR = _env_path("ADUNET_ISIC_VALID_IMAGES", "data/ISIC2017/valid/images")
VALID_MASK_DIR = _env_path("ADUNET_ISIC_VALID_MASKS", "data/ISIC2017/valid/masks")
TEST_IMAGE_DIR = _env_path("ADUNET_ISIC_TEST_IMAGES", "data/ISIC2017/test/images")
TEST_MASK_DIR = _env_path("ADUNET_ISIC_TEST_MASKS", "data/ISIC2017/test/masks")

# Run artifacts
MODEL_ROOT = _env_path("ADUNET_MODEL_ROOT", "runs/models")
LOG_ROOT = _env_path("ADUNET_LOG_ROOT", "runs/logs")
