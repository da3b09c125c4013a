"""Load an exported SR serving artifact and run it on the port's model.

Port of the loading half of ``adunet/export/aot.py``. An artifact directory
holds ``manifest.json``, ``model.stablehlo`` and, for int8 weight-only
exports, ``weights.npz``: the param tree's leaves ``w0..wN`` in flattening
order (``adunet_torch.convert.flax_leaf_paths``), each conv kernel as an
int8 ``q`` plus a float32 per-output-channel ``scale``
(``quantize_params_int8``, :32). The port never reads the StableHLO program:
it dequantizes the leaves as ``q.astype(f32) * scale`` (``_dequantize_params``,
:55) into the port's own ``AdaptiveSRUNet``. An artifact without a weights
file has its float32 weights baked into the program and cannot be served by
the port.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from adunet_torch.convert import flax_leaf_paths, state_dict_from_flax
from adunet_torch.models.sr_adaptive import AdaptiveSRUNet
from adunet_torch.utils.runtime import resolve_device

__all__ = ["MANIFEST_FILE", "load_artifact"]

MANIFEST_FILE = "manifest.json"
_LEAVES_PER_LEVEL = 23  # quantized leaves: enc + dec blocks (10 each) + smooth conv (3)


def _dequantize(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Replace every ``{"q", "scale"}`` leaf pair by ``q.astype(f32) * scale``."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, dict) and set(value) == {"q", "scale"}:
            out[key] = value["q"].astype(np.float32) * value["scale"]
        elif isinstance(value, dict):
            out[key] = _dequantize(value)
        else:
            out[key] = value
    return out


def _read_manifest(path: str | Path) -> Tuple[Path, Dict[str, Any]]:
    path = Path(path).expanduser()
    base = path if path.is_dir() else path.parent
    mf = base / MANIFEST_FILE
    if not mf.exists():
        raise ValueError(f"artifact at {path} has no {MANIFEST_FILE}")
    manifest = json.loads(mf.read_text())
    if not manifest.get("weights_file"):
        raise ValueError(
            f"artifact at {path} has its float32 weights baked into the StableHLO "
            "program (no 'weights_file' in the manifest); the PyTorch port can serve "
            "only weight-file artifacts. Re-export with --quantize int8."
        )
    if manifest.get("model", "adaptive_sr_unet") != "adaptive_sr_unet":
        raise ValueError(f"artifact model {manifest['model']!r} is not ported yet "
                         "(only adaptive_sr_unet)")
    return base, manifest


def _read_params(path: str | Path) -> Tuple[Dict[str, Any], int, Dict[str, Any]]:
    """(dequantized flax-style param tree, depth, manifest) of an artifact."""
    base, manifest = _read_manifest(path)
    n = int(manifest["weights_leaves"])
    if n % _LEAVES_PER_LEVEL or n < 2 * _LEAVES_PER_LEVEL:
        raise ValueError(f"{n} weight leaves do not form an adaptive SR U-Net param tree")
    depth = n // _LEAVES_PER_LEVEL - 1
    if int(manifest.get("depth", depth)) != depth:
        raise ValueError(f"manifest depth {manifest['depth']} but {n} leaves imply depth {depth}")
    paths = flax_leaf_paths(depth, quantized=True)
    tree: Dict[str, Any] = {}
    with np.load(base / manifest["weights_file"]) as z:
        for i, path_keys in enumerate(paths):
            leaf = z[f"w{i}"]
            if path_keys[-1] == "q" and (leaf.dtype != np.int8 or leaf.ndim != 4):
                raise ValueError(f"leaf w{i} ({'/'.join(path_keys)}) is {leaf.dtype} {leaf.shape}, "
                                 "expected an int8 HWIO kernel")
            node = tree
            for key in path_keys[:-1]:
                node = node.setdefault(key, {})
            node[path_keys[-1]] = leaf
    return _dequantize(tree), depth, manifest


def load_artifact(
    path: str | Path, device: str | torch.device = "cuda"
) -> Tuple[Callable[[np.ndarray], np.ndarray], Dict[str, Any]]:
    """Build the artifact's model on ``device`` and return ``(call, manifest)``.

    ``call(tiles)`` takes float32 numpy (B, P, P, 3) and returns the clipped
    restoration as float32 numpy (``adunet/export/aot.py:151-156``). It runs
    under ``torch.inference_mode()``, entered in the calling thread (the mode
    is thread-local). ``call.model`` is the ``AdaptiveSRUNet``."""
    dev = resolve_device(device)
    params, depth, manifest = _read_params(path)
    model = AdaptiveSRUNet(
        scale=float(manifest["scale"]),
        depth=depth,
        base_channels=params["enc0"]["conv0"]["kernel"].shape[-1],
        residual_head_channels=params["head"]["conv0"]["kernel"].shape[-1],
        device=dev,
    ).eval()
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    if "param_count" in manifest and int(manifest["param_count"]) != n_params:
        raise ValueError(f"manifest param_count {manifest['param_count']} != model's {n_params}")
    patch = tuple(manifest["input_shape"][1:]) if "input_shape" in manifest else None

    def call(tiles: np.ndarray) -> np.ndarray:
        arr = np.asarray(tiles, dtype=np.float32)
        if arr.ndim != 4 or (patch is not None and arr.shape[1:] != patch):
            raise ValueError(f"expected (B, *{patch}) tiles, got {arr.shape}")
        with torch.inference_mode():
            out = model(torch.tensor(arr, device=dev))
            return torch.clamp(out.to(torch.float32), 0.0, 1.0).cpu().numpy()

    call.model = model
    return call, manifest
