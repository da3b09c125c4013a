"""Data: image IO, discovery, grid tiling, the eval patch stream and the
device-resident training corpus."""

from adunet_torch.data.device_cache import load_device_cache, sample_patch_batch
from adunet_torch.data.discovery import find_images
from adunet_torch.data.io import load_rgb_image_full, load_rgb_image_full_u8, read_image_size
from adunet_torch.data.patches import grid_patch_count, grid_patches
from adunet_torch.data.sr_pipeline import GridPatchDataset, make_eval_patch_dataset

__all__ = [
    "load_device_cache",
    "sample_patch_batch",
    "find_images",
    "load_rgb_image_full",
    "load_rgb_image_full_u8",
    "read_image_size",
    "grid_patches",
    "grid_patch_count",
    "GridPatchDataset",
    "make_eval_patch_dataset",
]
