"""Reference (flax) parameter trees ↔ the port's state_dict.

- ``state_dict_from_flax(params, batch_stats=None)``: nested dicts of numpy
  arrays, as ``jax.device_get(state.params)`` / ``state.batch_stats`` give
  them, to a torch state_dict. Names join with ``.``; a conv ``kernel``
  (HWIO) becomes ``weight`` (OIHW), a norm ``scale`` becomes ``weight``,
  ``bias`` stays ``bias``; a BatchNorm's ``mean`` / ``var`` become the
  buffers ``running_mean`` / ``running_var``. This covers every model of the
  port by its flax names: the adaptive and vanilla SR U-Nets (``enc{i}``,
  ``dec{i}``, ``dec{i}_smooth``, ``bottleneck``, ``head``, ``residual_rgb``
  or ``enhanced_rgb``), the segmentation U-Nets and the VGG19 tower
  (``block{i}_conv{j}``). The kernel of a ``dec{i}_up``
  ConvTranspose (HWIO) becomes torch's (in, out, kh, kw) flipped in both
  spatial axes: flax correlates the dilated input with the kernel
  unflipped, torch's transposed conv scatters it unflipped
  (``adunet_torch/nn/blocks.py::ConvTranspose``).
- ``flax_leaf_paths(depth, quantized)``: the flat leaf order of the SR
  model's param tree, i.e. recursively sorted dict keys, the order in which
  ``jax.tree_util`` flattens dicts and in which an exported artifact stores
  its ``weights.npz`` leaves (``w0``, ``w1``, ...). A quantized conv kernel
  is the two leaves ``{"q", "scale"}``, in that order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_leaf_paths"]


_STATS_NAMES = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] | None = None) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: Tuple[str, ...]) -> None:
        for key in sorted(node):
            value = node[key]
            if key == "kernel" and isinstance(value, Mapping):
                raise ValueError(f"{'/'.join(prefix)}/kernel is quantized; dequantize it first")
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{'/'.join(prefix)}/kernel: expected HWIO, got {arr.shape}")
                if prefix and prefix[-1].endswith("_up"):  # ConvTranspose: flipped, IOHW
                    arr, name = arr[::-1, ::-1].transpose(2, 3, 0, 1), "weight"
                else:
                    arr, name = arr.transpose(3, 2, 0, 1), "weight"
            elif key == "scale":
                name = "weight"
            elif key == "bias":
                name = "bias"
            else:
                raise ValueError(f"unexpected leaf {'/'.join(prefix + (key,))}")
            out[".".join(prefix + (name,))] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, ())

    def walk_stats(node: Mapping[str, Any], prefix: Tuple[str, ...]) -> None:
        for key in sorted(node):
            if isinstance(node[key], Mapping):
                walk_stats(node[key], prefix + (key,))
            elif key in _STATS_NAMES:
                arr = np.ascontiguousarray(np.asarray(node[key], dtype=np.float32))
                out[".".join(prefix + (_STATS_NAMES[key],))] = torch.tensor(arr)
            else:
                raise ValueError(f"unexpected batch_stats leaf {'/'.join(prefix + (key,))}")

    walk_stats(batch_stats or {}, ())
    return out


def _param_tree_skeleton(depth: int, quantized: bool = False) -> Dict[str, Any]:
    """Nested dict with the SR model's param-tree keys (leaves are ``None``)."""
    kernel = {"q": None, "scale": None} if quantized else None
    conv = {"bias": None, "kernel": kernel}
    norm = {"bias": None, "scale": None}

    def block() -> Dict[str, Any]:
        return {"conv0": dict(conv), "conv1": dict(conv), "norm0": dict(norm), "norm1": dict(norm)}

    tree: Dict[str, Any] = {"bottleneck": block(), "head": block(), "residual_rgb": dict(conv)}
    for level in range(depth):
        tree[f"enc{level}"] = block()
        tree[f"dec{level}"] = block()
        tree[f"dec{level}_smooth"] = dict(conv)
    return tree


def flax_leaf_paths(depth: int, quantized: bool = False) -> List[Tuple[str, ...]]:
    """Leaf paths of the SR model's param tree in flattening order."""
    paths: List[Tuple[str, ...]] = []

    def walk(node: Mapping[str, Any], prefix: Tuple[str, ...]) -> None:
        for key in sorted(node):
            if isinstance(node[key], Mapping):
                walk(node[key], prefix + (key,))
            else:
                paths.append(prefix + (key,))

    walk(_param_tree_skeleton(depth, quantized), ())
    return paths
