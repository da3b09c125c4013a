"""Serving artifacts: write the port's models as weight-file artifacts, load
them (and the reference's int8 SR and joint exports) into the port's models."""

from adunet_torch.export.aot import MANIFEST_FILE, load_artifact, quantize_params_int8, save_artifact

__all__ = ["MANIFEST_FILE", "load_artifact", "quantize_params_int8", "save_artifact"]
