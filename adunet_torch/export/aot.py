"""Serving artifacts: write them from the port's models, load them into it.

Port of ``adunet/export/aot.py``. An artifact directory holds
``manifest.json`` and ``weights.npz``: the param tree's leaves ``w0..wN`` in
flattening order (``adunet_torch.convert.model_leaf_paths``), each conv
kernel, when quantized, as an int8 ``q`` plus a float32 per-output-channel
``scale`` (``quantize_params_int8``, :32).

- ``save_artifact`` writes the port's artifacts: ``"format":
  "adunet_torch.weights"``, the serving program ``model.pt2``
  (``adunet_torch.export.program``: a ``torch.export`` program with the
  weights, and a segmentation model's BatchNorm statistics, inside; int8
  weights as int8 buffers with ``quantize``), exported on the model's device
  (``"platforms"`` in the manifest), beside the weights file. Without
  ``quantize`` the leaves are the float32 weights, the counterpart of the
  reference's float32 program. A segmentation model's BatchNorm statistics
  go into the weights file too, as the extra leaves ``s0..sM`` (the
  ``batch_stats`` tree in flattening order; ``batch_stats_leaves`` in the
  manifest), where the reference bakes them into its program (:164-199).
  The artifacts load only in the port (no ``model.stablehlo``).
- ``load_artifact`` runs an artifact's program where it has one
  (``"program_file"``), with no model code. Otherwise it reads the
  manifest's ``model`` (``adaptive_sr_unet``, ``adaptive_seg_unet`` or
  ``joint_sr_seg_unet``), dequantizes the leaves as ``q.astype(f32) *
  scale`` (``_dequantize_params``, :55) and builds that model on the device:
  the reference's int8 SR and joint artifacts (it never reads their
  StableHLO program) and the port's artifacts from before it wrote
  programs. A reference float32 artifact has its weights only inside the
  program, and a reference seg artifact its BatchNorm statistics: both are
  refused.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from adunet_torch.convert import flax_trees_from_state_dict, model_leaf_paths, state_dict_from_flax
from adunet_torch.export import program
from adunet_torch.utils.runtime import resolve_device

__all__ = ["MANIFEST_FILE", "WEIGHTS_FILE", "FORMAT", "quantize_params_int8", "save_artifact",
           "load_artifact"]

MANIFEST_FILE = "manifest.json"
WEIGHTS_FILE = "weights.npz"
FORMAT = "adunet_torch.weights"
_STABLEHLO_FILE = "model.stablehlo"
# the models by class name (imported only to rebuild one: a program needs none)
_MODELS = {"AdaptiveSRUNet": "adaptive_sr_unet", "AdaptiveSegUNet": "adaptive_seg_unet",
           "JointSRSegUNet": "joint_sr_seg_unet"}
_EXPORTS = {"adaptive_sr_unet": program.export_sr_forward,
            "adaptive_seg_unet": program.export_seg_forward,
            "joint_sr_seg_unet": program.export_joint_forward}


def quantize_params_int8(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 quantization of the 4-D conv kernels (HWIO) of a
    nested param dict: each becomes ``{"q": int8, "scale": f32[C_out]}``
    with per-output-channel symmetric scales, rounded half to even
    (``np.round``) as the reference does; other leaves stay float32."""
    out: Dict[str, Any] = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            out[key] = quantize_params_int8(value)
            continue
        w = np.asarray(value)
        if w.ndim != 4:
            out[key] = w
            continue
        q, scale = program.quantize_int8(w)
        out[key] = {"q": q, "scale": scale}
    return out


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


def _get(tree: Mapping[str, Any], path: Sequence[str]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: Dict[str, Any], path: Sequence[str], leaf: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def save_artifact(model: torch.nn.Module, out_dir: str | Path, image_size: int,
                  batch_size: int, quantize: Optional[str] = None,
                  meta: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``model``'s serving artifact for (batch_size, image_size,
    image_size, 3) float32 inputs into ``out_dir``; returns it.

    ``quantize="int8"`` stores conv kernels as int8 + per-channel scales;
    None stores the float32 weights. The program is exported on the model's
    device. The manifest carries the model's name, depth and (SR and joint)
    scale, its parameter count, the program's file and platform, and
    ``meta``."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantization mode: {quantize}")
    name = _MODELS.get(type(model).__name__)
    if name is None:
        raise ValueError(f"{type(model).__name__} has no serving artifact")
    params, batch_stats = flax_trees_from_state_dict(model.state_dict())
    tree = quantize_params_int8(params) if quantize else params
    leaves = {f"w{i}": _get(tree, p)
              for i, p in enumerate(model_leaf_paths(model, quantized=bool(quantize)))}
    stats_paths = model_leaf_paths(model, collection="batch_stats")
    leaves.update({f"s{i}": _get(batch_stats, p) for i, p in enumerate(stats_paths)})

    exported = _EXPORTS[name](model, image_size, batch_size, quantize)

    out_dir = Path(out_dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / _STABLEHLO_FILE).unlink(missing_ok=True)  # no stale reference program
    np.savez(out_dir / WEIGHTS_FILE, **leaves)
    torch.export.save(exported, str(out_dir / program.PROGRAM_FILE))
    manifest: Dict[str, Any] = {
        "format": FORMAT,
        "loads_in": "adunet_torch only: no StableHLO program; load with "
                    "adunet_torch.export.load_artifact, or the program alone with "
                    "adunet_torch.export.program.Program",
        "model": name,
        "input_shape": [int(batch_size), int(image_size), int(image_size), 3],
        "input_dtype": "float32",
        "artifact_bytes": ((out_dir / WEIGHTS_FILE).stat().st_size
                           + (out_dir / program.PROGRAM_FILE).stat().st_size),
        "program_file": program.PROGRAM_FILE,
        "platforms": [next(model.parameters()).device.type],
        "weights_file": WEIGHTS_FILE,
        "weights_leaves": len(leaves) - len(stats_paths),
        "batch_stats_leaves": len(stats_paths),
        "depth": model.depth,
        "param_count": sum(p.numel() for p in model.parameters()),
    }
    if hasattr(model, "scale"):
        manifest["scale"] = model.scale
    if quantize:
        manifest["quantization"] = f"{quantize}-weight-only"
    manifest.update(meta or {})
    (out_dir / MANIFEST_FILE).write_text(json.dumps(manifest, indent=2))
    return out_dir


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
    name = manifest.get("model", "adaptive_sr_unet")
    if name not in _MODELS.values():
        raise ValueError(f"artifact model {name!r} is not one the port serves "
                         f"({', '.join(_MODELS.values())})")
    if name == "adaptive_seg_unet" and manifest.get("format") != FORMAT:
        raise ValueError(
            f"artifact at {path} is a reference segmentation export: its BatchNorm running "
            "statistics are baked into its StableHLO program and are not in its weights "
            "file, so the port cannot rebuild the model. Export the checkpoint with "
            "adunet_torch.cli.export_model, which writes them as weight leaves."
        )
    return base, manifest


def _scale(manifest: Dict[str, Any], path: Path) -> float:
    """An SR or joint artifact's encoder shrink: the manifest's, else its
    checkpoint's ``config.json`` (the reference's joint manifest names the
    checkpoint but not the scale, which its program bakes in)."""
    if "scale" in manifest:
        return float(manifest["scale"])
    cfg = Path(manifest.get("checkpoint", "")).expanduser() / "config.json"
    if manifest.get("checkpoint") and cfg.exists():
        return float(json.loads(cfg.read_text())["scale"])
    raise ValueError(f"artifact at {path} names no 'scale' and its checkpoint's config.json is "
                     "not found: the encoder's shrink cannot be read from the weights")


def _make_model(name: str, depth: int, scale: Optional[float], device,
                params: Optional[Dict[str, Any]] = None) -> torch.nn.Module:
    """The artifact's model; with ``params``, its widths read from them."""
    from adunet_torch.models import AdaptiveSegUNet, AdaptiveSRUNet, JointSRSegUNet

    def width(*block: str, default: int = 64) -> int:
        return default if params is None else int(_get(params, block + ("kernel",)).shape[-1])

    if name == "adaptive_sr_unet":
        return AdaptiveSRUNet(scale, depth, base_channels=width("enc0", "conv0"),
                              residual_head_channels=width("head", "conv0"), device=device)
    if name == "adaptive_seg_unet":
        return AdaptiveSegUNet(depth, base_channels=width("enc0", "conv0"), device=device)
    return JointSRSegUNet(scale, depth, base_channels=width("enc0", "conv0"),
                          residual_head_channels=width("sr_head", "conv0"),
                          num_classes=width("mask_logits", default=1), device=device)


def _read_leaves(base: Path, manifest: Dict[str, Any], name: str, scale: Optional[float]
                 ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """(dequantized param tree, batch_stats tree, depth) of an artifact."""
    quantized = manifest.get("format") != FORMAT or bool(manifest.get("quantization"))
    n, depth = int(manifest["weights_leaves"]), int(manifest["depth"])
    skeleton = _make_model(name, depth, scale, "meta")
    paths = model_leaf_paths(skeleton, quantized=quantized)
    if len(paths) != n:
        raise ValueError(f"{n} weight leaves do not form a {name} param tree of depth {depth}")
    stats_paths = model_leaf_paths(skeleton, collection="batch_stats")
    if int(manifest.get("batch_stats_leaves", 0)) != len(stats_paths):
        raise ValueError(f"{name} of depth {depth} has {len(stats_paths)} BatchNorm statistics; "
                         f"the manifest says {manifest.get('batch_stats_leaves', 0)}")
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    with np.load(base / manifest["weights_file"]) as z:
        for i, path_keys in enumerate(paths):
            leaf = z[f"w{i}"]
            if path_keys[-1] == "q" and (leaf.dtype != np.int8 or leaf.ndim != 4):
                raise ValueError(f"leaf w{i} ({'/'.join(path_keys)}) is {leaf.dtype} {leaf.shape}, "
                                 "expected an int8 HWIO kernel")
            _put(params, path_keys, leaf)
        for i, path_keys in enumerate(stats_paths):
            _put(batch_stats, path_keys, z[f"s{i}"])
    return _dequantize(params), batch_stats, depth


def _rebuild(base: Path, manifest: Dict[str, Any], name: str, scale: Optional[float],
             dev: torch.device) -> torch.nn.Module:
    """The artifact's model, built from its weights file on ``dev``, in eval mode."""
    params, batch_stats, depth = _read_leaves(base, manifest, name, scale)
    model = _make_model(name, depth, scale, dev, params).eval()
    model.load_state_dict(state_dict_from_flax(params, batch_stats), strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    if "param_count" in manifest and int(manifest["param_count"]) != n_params:
        raise ValueError(f"manifest param_count {manifest['param_count']} != model's {n_params}")
    return model


class _ProgramCall(program.Program):
    """An artifact's program; ``model`` is the model its weights file
    rebuilds, built at first use: running the program needs no model code."""

    def __init__(self, path: Path, device: torch.device, rebuild: Callable[[], torch.nn.Module]):
        super().__init__(path, device)
        self._rebuild = rebuild

    @functools.cached_property
    def model(self) -> torch.nn.Module:
        return self._rebuild()


def load_artifact(
    path: str | Path, device: str | torch.device = "cuda"
) -> Tuple[Callable[[np.ndarray], Any], Dict[str, Any]]:
    """Load the artifact onto ``device``: its program where it has one, else
    its model rebuilt from the weights file; return ``(call, manifest)``.

    ``call(tiles)`` takes float32 numpy (B, P, P, 3) and returns float32
    numpy (``adunet/export/aot.py:151-232``): the clipped restoration (SR),
    the eval-mode probability mask (seg), or ``{"sr": clipped, "mask":
    probabilities}`` (joint). It runs under ``torch.inference_mode()``,
    entered in the calling thread (the mode is thread-local). ``call.model``
    is the model (for a program, rebuilt from the weights file when first
    read), ``call.device`` the device; a program's call is a
    ``program.Program`` (``call.module`` runs on device tensors)."""
    dev = resolve_device(device)
    base, manifest = _read_manifest(path)
    name = manifest.get("model", "adaptive_sr_unet")
    scale = None if name == "adaptive_seg_unet" else _scale(manifest, base)
    if "depth" not in manifest:
        raise ValueError(f"artifact at {base} names no 'depth' in its {MANIFEST_FILE}")
    rebuild = functools.partial(_rebuild, base, manifest, name, scale, dev)
    if manifest.get("program_file"):
        return _ProgramCall(base / manifest["program_file"], dev, rebuild), manifest
    model = rebuild()
    patch = tuple(manifest["input_shape"][1:]) if "input_shape" in manifest else None

    def host(t: torch.Tensor, clip: bool = False) -> np.ndarray:
        t = t.to(torch.float32)
        return (torch.clamp(t, 0.0, 1.0) if clip else t).cpu().numpy()

    def call(tiles: np.ndarray):
        arr = np.asarray(tiles, dtype=np.float32)
        if arr.ndim != 4 or (patch is not None and arr.shape[1:] != patch):
            raise ValueError(f"expected (B, *{patch}) tiles, got {arr.shape}")
        with torch.inference_mode():
            out = model(torch.tensor(arr, device=dev))
            if name == "joint_sr_seg_unet":
                return {"sr": host(out[0], clip=True), "mask": host(out[1])}
            return host(out, clip=name == "adaptive_sr_unet")

    call.model = model
    call.device = dev
    return call, manifest
