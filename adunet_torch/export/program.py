"""Serving programs: the port's inference forwards as ``torch.export`` programs.

Counterpart of ``adunet/export/aot.py:103-231`` (``export_sr_forward``,
``export_seg_forward``, ``export_joint_forward`` and ``QuantizedExported``),
which lower the forward to one StableHLO program with the weights inside.
Here the program is an ``ExportedProgram`` of the eval-mode forward at a
static (batch, size, size, 3) float32 input, written by
``torch.export.save`` (``model.pt2``) and read by ``torch.export.load``:

- SR: the restoration, clipped to [0, 1] inside the program (:150-153);
- seg: the mask probabilities, the BatchNorm running statistics inside the
  program (:164-199);
- joint: ``{"sr": clipped, "mask": probabilities}``, one program (:208-231).

K1 and K2 stand in the graph as the ops ``adunet_torch::layer_norm_relu``
and ``adunet_torch::conv3x3_c64`` (``adunet_torch.kernels.ops``): the
program launches the kernels on the card and runs their plain versions on
the CPU, whichever device it was exported on. Every other layer is ATen ops,
and the resize matrices are constants of the program.

``quantize="int8"``, the counterpart of ``QuantizedExported``: each conv
kernel is held as an int8 buffer and a float32 scale per output channel (the
reference's ``quantize_params_int8``, :32), dequantized as ``q.float() *
scale`` inside the forward, and the model is called with
``torch.func.functional_call``; the program keeps the int8 buffers, so it is
about a quarter the size of the float32 one.

Loading a program needs no model code: this module imports torch, numpy and
``adunet_torch.kernels`` (which registers the two ops) only. ``Program``
loads a ``model.pt2`` onto a device and calls it on numpy tiles. Programs
serve only: the ops have no autograd formula, so a backward through one
raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.export.passes
from torch import nn

import adunet_torch.kernels  # noqa: F401  registers the adunet_torch:: ops a program names
from adunet_torch.utils import spans

__all__ = ["PROGRAM_FILE", "quantize_int8", "export_sr_forward", "export_seg_forward",
           "export_joint_forward", "Program", "node_counts"]

PROGRAM_FILE = "model.pt2"


def quantize_int8(w: np.ndarray, out_axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Weight-only int8 quantization of one conv kernel: ``(q, scale)``, a
    float32 scale per output channel (along ``out_axis``: the last of an HWIO
    kernel, the first of an OIHW one) = max |w| / 127, floored at 1e-12, and
    ``q = clip(round(w / scale), -127, 127)``, halves rounded to even, as
    ``adunet/export/aot.py:32`` computes them."""
    out_axis %= w.ndim
    axes = tuple(a for a in range(w.ndim) if a != out_axis)
    scale = np.maximum(np.abs(w).max(axis=axes) / 127.0, 1e-12).astype(np.float32)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


def _served(kind: str, out: Any) -> Any:
    """What a program returns of ``kind``'s model output, in float32."""
    if kind == "joint":
        return {"sr": torch.clamp(out[0].to(torch.float32), 0.0, 1.0),
                "mask": out[1].to(torch.float32)}
    out = out.to(torch.float32)
    return torch.clamp(out, 0.0, 1.0) if kind == "sr" else out


class _Forward(nn.Module):
    """The model's eval forward as a program serves it."""

    def __init__(self, model: nn.Module, kind: str):
        super().__init__()
        self.model = model
        self.kind = kind

    def forward(self, x: torch.Tensor) -> Any:
        return _served(self.kind, self.model(x))


class _Int8Forward(nn.Module):
    """The same forward from int8 conv kernels: every 4-D parameter of the
    model as an int8 buffer ``<name>__q`` and a float32 ``<name>__scale``,
    every other parameter and buffer as a buffer of its own; the model
    itself is held outside the module's state, so its float32 kernels stay
    out of the program."""

    def __init__(self, model: nn.Module, kind: str):
        super().__init__()
        self.kind = kind
        self._model = (model,)  # a tuple: not registered as a submodule
        self._quantized, self._kept = [], []
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            key = name.replace(".", "__")
            t = t.detach()
            if t.dim() == 4:
                q, scale = quantize_int8(t.to("cpu", torch.float32).numpy(), out_axis=0)
                self.register_buffer(key + "__q", torch.from_numpy(q).to(t.device))
                self.register_buffer(key + "__scale", torch.from_numpy(scale).to(t.device))
                self._quantized.append((name, key))
            else:
                self.register_buffer(key, t.clone())
                self._kept.append((name, key))

    def forward(self, x: torch.Tensor) -> Any:
        tensors = {name: getattr(self, key) for name, key in self._kept}
        for name, key in self._quantized:
            q, scale = getattr(self, key + "__q"), getattr(self, key + "__scale")
            tensors[name] = q.to(torch.float32) * scale.view(-1, 1, 1, 1)
        return _served(self.kind, torch.func.functional_call(self._model[0], tensors, (x,)))


def _export(model: nn.Module, kind: str, size: int, batch: int,
            quantize: Optional[str]) -> torch.export.ExportedProgram:
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantization mode: {quantize}")
    device = next(model.parameters()).device
    forward = _Int8Forward(model, kind) if quantize else _Forward(model, kind)
    x = torch.zeros(int(batch), int(size), int(size), 3, device=device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            exported = torch.export.export(forward, (x,), strict=False)
    finally:
        model.train(was_training)
    exported.example_inputs = None  # zeros; saved, they would outweigh the int8 weights
    return exported


def export_sr_forward(model: nn.Module, patch_size: int, batch_size: int,
                      quantize: Optional[str] = None) -> torch.export.ExportedProgram:
    """The adaptive SR U-Net's clipped restoration as a program of
    ``f32[batch, patch, patch, 3] -> f32[batch, patch, patch, 3]``, on the
    model's device."""
    return _export(model, "sr", patch_size, batch_size, quantize)


def export_seg_forward(model: nn.Module, image_size: int, batch_size: int,
                       quantize: Optional[str] = None) -> torch.export.ExportedProgram:
    """The segmentation U-Net's eval forward (BatchNorm on its running
    statistics) as a program of ``f32[b, s, s, 3] -> f32[b, s, s, C]``."""
    return _export(model, "seg", image_size, batch_size, quantize)


def export_joint_forward(model: nn.Module, image_size: int, batch_size: int,
                         quantize: Optional[str] = None) -> torch.export.ExportedProgram:
    """The joint SR + segmentation U-Net as one program of ``f32[b, s, s, 3]
    -> {"sr": f32[b, s, s, 3], "mask": f32[b, s, s, C]}``."""
    return _export(model, "joint", image_size, batch_size, quantize)


def _on(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Program:
    """A saved program (``model.pt2``) loaded onto ``device``; moved there
    (``torch.export.passes.move_to_device_pass``) when it was exported on
    another. ``program(tiles)`` takes float32 numpy (B, P, P, 3) and returns
    float32 numpy (joint: a dict of them), under ``torch.inference_mode()``;
    B may differ from the program's static batch, which the tiles are cut
    into and the last cut padded to with zeros. ``module`` is the program's
    callable module, ``input_shape`` its static input shape.

    With a profiler running, each cut records the spans ``program.copy_in``
    (to the device, and the padding), ``program.forward`` (the module's
    call: the host's launches) and ``program.copy_out`` (back to numpy,
    which waits for the forward's kernels)."""

    def __init__(self, path: str | Path, device: str | torch.device):
        ep = torch.export.load(str(path))
        self.device = _on(device)
        if self.device.type == "cuda":
            # full float32 in cuBLAS and cuDNN, as every entry point of the port
            # sets it (adunet_torch.utils.runtime.setup_runtime): the program
            # computes what the CPU computes
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        exported_on = next(iter(ep.state_dict.values())).device
        if exported_on != self.device:
            ep = torch.export.passes.move_to_device_pass(ep, self.device)
        user_inputs = set(ep.graph_signature.user_inputs)
        (spec,) = [n.meta["val"] for n in ep.graph.nodes
                   if n.op == "placeholder" and n.name in user_inputs]
        self.input_shape = tuple(int(d) for d in spec.shape)
        self.exported_program = ep
        self.module = ep.module()

    def __call__(self, tiles: np.ndarray) -> Any:
        arr = np.asarray(tiles, dtype=np.float32)
        batch = self.input_shape[0]
        if arr.ndim != 4 or arr.shape[1:] != self.input_shape[1:] or len(arr) == 0:
            raise ValueError(f"expected (B, *{self.input_shape[1:]}) tiles, got {arr.shape}")
        parts = []
        with torch.inference_mode():
            for start in range(0, len(arr), batch):
                cut = arr[start:start + batch]
                with spans.span("program.copy_in"):
                    x = torch.from_numpy(cut).to(self.device)
                    if len(cut) < batch:
                        x = torch.cat([x, x.new_zeros((batch - len(cut), *x.shape[1:]))])
                with spans.span("program.forward"):
                    out = self.module(x)
                with spans.span("program.copy_out"):
                    parts.append({k: v[:len(cut)].cpu().numpy() for k, v in out.items()}
                                 if isinstance(out, dict) else out[:len(cut)].cpu().numpy())
        if isinstance(parts[0], dict):
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        return np.concatenate(parts)


def node_counts(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """How many nodes of each op the program's graph calls, by op name
    (``adunet_torch.layer_norm_relu.default``, ``aten.rsqrt.default``, ...)."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        if node.op == "call_function":
            name = str(node.target)
            counts[name] = counts.get(name, 0) + 1
    return counts
