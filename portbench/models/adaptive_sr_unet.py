"""The adaptive-depth SR U-Net (``"model": "adaptive_sr_unet"``): the
program's ``build_super_resolution_unet``, trained by its compiled
device-cache step with the Charbonnier loss and served as its int8
artifact; held to the plain reference in ``reference/sr_unet.py`` (the
forward and the layer shapes) and ``reference/train.py`` (patch sampling,
degradation, loss, Adam)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import program
from portbench.lib import inputs
from portbench.reference import quant, sr_unet, train as ref_train

param_shapes = sr_unet.param_shapes
conv_layers = sr_unet.conv_layers
norm_layers = sr_unet.norm_layers
reference_forward = sr_unet.forward
reference_follow = ref_train.follow
# the training control: every conv's input and weight rounded to float8 e4m3
control_quant = sr_unet.fp8_e4m3


def build(cfg: dict, params: Dict[str, torch.Tensor], dtype: str, device, remat: bool = False):
    """The SR U-Net of ``cfg`` on ``device`` holding ``params`` (copied); the
    device is resolved as the program's entry points resolve it (on CUDA:
    TF32 off for float32 matmuls and convolutions)."""
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    net, _ = build_super_resolution_unet(
        float(cfg["scale"]), base_channels=int(cfg["base_channels"]),
        residual_head_channels=int(cfg["residual_head_channels"]),
        depth_override=int(cfg["depth"]), input_size=int(cfg["patch_size"]),
        dtype=program.DTYPES[dtype], remat=remat, device="meta")
    net = net.to_empty(device=dev)
    net.load_state_dict(params, strict=True)
    n = sum(p.numel() for p in net.parameters())
    if n != int(cfg["params"]):
        raise AssertionError(f"{cfg['name']} has {n} parameters, its configuration says {cfg['params']}")
    return net


def data(traffic: dict, seed: int, device) -> torch.Tensor:
    """The uint8 image corpus on the card that the train step samples."""
    corp = traffic["corpus"]
    return inputs.corpus(seed, int(corp["images"]), int(corp["height"]), int(corp["width"]),
                         device)


def train_step(cfg: dict, net, corpus_u8: torch.Tensor, graph=None):
    """(state, step) of the compiled device-cache train step: Charbonnier
    loss, Adam at the configuration's rate; ``step(state, None, generator)``.
    ``graph``: the step's (None: captured on CUDA; False: eager)."""
    import adunet_torch.losses as losses
    from adunet_torch.train import (create_train_state, make_optimizer,
                                    make_sr_device_cache_train_step)

    train = cfg["train"]
    state = create_train_state(net, make_optimizer(net.parameters(), float(train["learning_rate"])))
    step = make_sr_device_cache_train_step(
        net, losses.charbonnier_loss, corpus_u8, patch_size=int(cfg["patch_size"]),
        batch_size=int(train["batch_size"]), data_scale=float(train["lr_shrink"]), graph=graph)
    return state, step


def resize_layers(cfg: dict, batch: int, size: int) -> List[dict]:
    """Every resize of one training step: name, n, h, w, c, oh, ow, method,
    antialias, dtype and ``grad`` (whether the backward runs it again, on
    the cotangent). Per encoder level its block's output resized down to
    the next level's size, per decoder level the level below's resized up,
    in the training type; then the degradation of the batch, in float32
    with no gradient: an area shrink by ``lr_shrink`` and OpenCV's cubic
    enlargement back (``reference/train.py`` ``degrade``)."""
    depth, base, dtype = int(cfg["depth"]), int(cfg["base_channels"]), cfg["train"]["dtype"]
    hw = sr_unet.sizes(cfg, size)

    def resize(name, h, oh, c, method, antialias, dt, grad):
        return dict(name=name, n=batch, h=h, w=h, c=c, oh=oh, ow=oh, method=method,
                    antialias=antialias, dtype=dt, grad=grad)

    out = [resize(f"enc{lv}", hw[lv], hw[lv + 1], base << lv, "bilinear", True, dtype, True)
           for lv in range(depth)]
    out += [resize(f"dec{lv}", hw[lv + 1], hw[lv], base << (lv + 1), "bilinear", True, dtype, True)
            for lv in reversed(range(depth))]
    small = max(1, int(round(size * float(cfg["train"]["lr_shrink"]))))
    out += [resize("degrade_area", size, small, 3, "area", True, "float32", False),
            resize("degrade_cubic", small, size, 3, "bicubic_cv2", False, "float32", False)]
    return out


def save_artifact(net, out_dir: str, cfg: dict) -> None:
    """The program's serving artifact of ``net``: ``model.pt2`` at the
    configuration's static batch, int8 weights where it says so."""
    from adunet_torch.export import save_artifact as save

    serve = cfg["serve"]
    save(net, out_dir, image_size=int(cfg["patch_size"]), batch_size=int(serve["batch_size"]),
         quantize=serve.get("quantize"))


def reference_tiles(cfg: dict, seed: int, x_u8: np.ndarray, device, tf32: bool = False,
                    block: int = 8) -> np.ndarray:
    """The reference's restoration of (N, P, P, 3) uint8 tiles, float32, in
    blocks of ``block`` tiles, from the seed's weights quantized again by
    the reference's own int8 code; ``tf32`` runs it in TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        params = quant.dequantized(inputs.weights(cfg, seed, device))
        outs = []
        with torch.no_grad():
            for s in range(0, len(x_u8), block):
                x = torch.from_numpy(x_u8[s:s + block]).to(device).to(torch.float32) / 255.0
                outs.append(reference_forward(params, x, cfg, torch.float32).cpu().numpy())
        return np.concatenate(outs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
