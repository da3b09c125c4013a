"""Run configuration."""

from adunet_torch.configs.config import PROTOCOLS, ProtocolConfig, SegTrainConfig, SRTrainConfig

__all__ = ["SRTrainConfig", "ProtocolConfig", "PROTOCOLS", "SegTrainConfig"]
