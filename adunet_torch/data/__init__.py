"""Data: image IO, discovery and pairing, random crops and grid tiling, the
streamed training and eval patch streams and their copy to the card, the
in-memory paired dataset, the device-resident training corpus, the
segmentation pipeline and its on-device augmentation."""

from adunet_torch.data.array_dataset import ArrayDataset, make_array_dataset

from adunet_torch.data.augment import augment_pair_batch, flip_pair_batch
from adunet_torch.data.device_cache import load_device_cache, sample_patch_batch
from adunet_torch.data.discovery import (
    canonical_key,
    collect_isic_pairs,
    discover_pairs,
    find_images,
    normalise_isic_key,
    pair_lr_files,
)
from adunet_torch.data.io import (
    load_image_stack,
    load_label_mask,
    load_mask,
    load_rgb_image,
    load_rgb_image_full,
    load_rgb_image_full_u8,
    read_image_size,
)
from adunet_torch.data.patches import grid_patch_count, grid_patches, random_patch, random_patches
from adunet_torch.data.seg_pipeline import SegPairDataset, build_isic_dataset
from adunet_torch.data.sr_pipeline import (
    GridPatchDataset,
    TrainingPatchDataset,
    device_feed,
    make_eval_patch_dataset,
    make_training_patch_dataset,
)

__all__ = [
    "ArrayDataset",
    "make_array_dataset",
    "pair_lr_files",
    "load_image_stack",
    "random_patch",
    "random_patches",
    "TrainingPatchDataset",
    "make_training_patch_dataset",
    "device_feed",
    "augment_pair_batch",
    "flip_pair_batch",
    "load_device_cache",
    "sample_patch_batch",
    "find_images",
    "collect_isic_pairs",
    "normalise_isic_key",
    "canonical_key",
    "discover_pairs",
    "load_rgb_image",
    "load_rgb_image_full",
    "load_rgb_image_full_u8",
    "load_mask",
    "load_label_mask",
    "read_image_size",
    "grid_patches",
    "grid_patch_count",
    "GridPatchDataset",
    "make_eval_patch_dataset",
    "SegPairDataset",
    "build_isic_dataset",
]
