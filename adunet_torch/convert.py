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
- ``flax_trees_from_state_dict(state_dict)``: the inverse, to
  ``(params, batch_stats)`` nested numpy dicts (HWIO kernels); what an
  export quantizes and writes.
- ``model_leaf_paths(model, quantized)``: the flat leaf order of a model's
  param tree, read from its own parameter names: recursively sorted dict
  keys, the order in which ``jax.tree_util`` flattens dicts and in which an
  exported artifact stores its ``weights.npz`` leaves (``w0``, ``w1``, ...).
  A quantized conv kernel is the two leaves ``{"q", "scale"}``, in that
  order. ``flax_leaf_paths(depth, quantized)`` is that order for the
  adaptive SR U-Net at ``depth``. The joint model's names are ``enc{i}``,
  ``bottleneck``, ``{sr,seg}_dec{i}``, ``{sr,seg}_dec{i}_smooth``,
  ``sr_head``, ``residual_rgb`` and ``mask_logits``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_trees_from_state_dict", "model_leaf_paths",
           "flax_leaf_paths"]


_STATS_NAMES = {"mean": "running_mean", "var": "running_var"}
_STATS_TORCH = {v: k for k, v in _STATS_NAMES.items()}


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


def _flax_path(name: str, ndim: int) -> Tuple[str, Tuple[str, ...]]:
    """(collection, path) of a state_dict entry in the reference's trees:
    ``"params"`` (a 4-D ``weight`` is a conv ``kernel``, a 1-D one a norm
    ``scale``) or ``"batch_stats"`` (the BatchNorm buffers)."""
    *prefix, leaf = name.split(".")
    if leaf in _STATS_TORCH:
        return "batch_stats", (*prefix, _STATS_TORCH[leaf])
    if leaf == "weight":
        leaf = "kernel" if ndim == 4 else "scale"
    return "params", (*prefix, leaf)


def model_leaf_paths(model: torch.nn.Module, quantized: bool = False,
                     collection: str = "params") -> List[Tuple[str, ...]]:
    """Leaf paths of ``model``'s flax tree (``"params"`` or ``"batch_stats"``)
    in flattening order, read from its own parameter and buffer names.
    ``jax.tree_util`` flattens dicts by sorted keys at every level, which is
    the lexicographic order of the path tuples (``seg_dec0`` before
    ``seg_dec0_smooth``). With ``quantized`` a conv kernel is the two leaves
    ``(..., "kernel", "q")`` and ``(..., "kernel", "scale")``."""
    paths: List[Tuple[str, ...]] = []
    for name, tensor in model.state_dict(keep_vars=True).items():
        coll, path = _flax_path(name, tensor.dim())
        if coll != collection:
            continue
        if quantized and path[-1] == "kernel":
            paths += [path + ("q",), path + ("scale",)]
        else:
            paths.append(path)
    return sorted(paths)


def flax_leaf_paths(depth: int, quantized: bool = False) -> List[Tuple[str, ...]]:
    """Leaf paths of the adaptive SR U-Net's param tree at ``depth`` in
    flattening order (``model_leaf_paths`` of the model on the meta device)."""
    from adunet_torch.models.sr_adaptive import AdaptiveSRUNet

    return model_leaf_paths(AdaptiveSRUNet(scale=0.5, depth=depth, device="meta"), quantized)


def flax_trees_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``state_dict_from_flax``: ``(params, batch_stats)`` as
    nested dicts of float32 numpy arrays, conv kernels in HWIO."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, tensor in state_dict.items():
        arr = tensor.detach().to("cpu", torch.float32).numpy()
        coll, path = _flax_path(name, arr.ndim)
        if path[-1] == "kernel":
            if path[-2].endswith("_up"):
                raise ValueError(f"{name}: ConvTranspose kernels have no exported layout")
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        node = trees[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return trees["params"], trees["batch_stats"]
