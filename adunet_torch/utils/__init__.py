"""Device resolution, runtime switches and card identity."""

from adunet_torch.utils.runtime import (
    deterministic_cudnn,
    gpu_identity,
    resolve_device,
    setup_runtime,
)

__all__ = ["deterministic_cudnn", "gpu_identity", "resolve_device", "setup_runtime"]
