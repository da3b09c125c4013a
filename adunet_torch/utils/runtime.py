"""Device resolution and numeric switches shared by every entry point.

Counterpart of ``adunet/utils/runtime.py::setup_runtime``: there the runtime
set-up is a compile cache; here it is the choice of device and the float32
precision of cuBLAS / cuDNN. PyTorch runs float32 convolutions through cuDNN
in TF32 by default (about three decimal digits), while the reference's
resizes run at ``Precision.HIGHEST`` (``adunet/ops/resize.py:175``) and its
CPU oracle in full float32. With TF32 off, the float32 serving path on the
card computes what the CPU oracle computes.
"""

from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "setup_runtime", "gpu_identity"]


def setup_runtime() -> None:
    """Turn TF32 off for float32 matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and no
    GPU is present. Never falls back to the CPU: a caller that wants the CPU
    passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA GPU is available; "
                "pass device='cpu' to run on the CPU."
            )
        setup_runtime()
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r} (expected cuda, cpu or meta)")
    return dev


def gpu_identity() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
