"""Serving artifacts: write the port's models as a ``torch.export`` program
(``program``) beside a weights file, and load them (the program, with no
model code) or the reference's int8 SR and joint exports (rebuilt into the
port's models)."""

from adunet_torch.export.aot import MANIFEST_FILE, load_artifact, quantize_params_int8, save_artifact

__all__ = ["MANIFEST_FILE", "load_artifact", "quantize_params_int8", "save_artifact"]
