"""Device resolution, runtime switches and card identity."""

from adunet_torch.utils.runtime import gpu_identity, resolve_device, setup_runtime

__all__ = ["gpu_identity", "resolve_device", "setup_runtime"]
