"""Run configuration."""

from adunet_torch.configs.config import SRTrainConfig

__all__ = ["SRTrainConfig"]
