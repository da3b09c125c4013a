"""Serving artifacts: load an int8 weight-file export into the port's model."""

from adunet_torch.export.aot import MANIFEST_FILE, load_artifact

__all__ = ["MANIFEST_FILE", "load_artifact"]
