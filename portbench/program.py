"""What the benchmark takes from the program (``adunet_torch``): the model
built from the benchmark's weights, the compiled device-cache train step,
the int8 serving artifact and its HTTP server, and the kernels' launch
counters. Nothing else of the program is imported anywhere in the
benchmark."""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model(cfg: dict, params: Dict[str, torch.Tensor], dtype: str, device, remat: bool = False):
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
        dtype=DTYPES[dtype], remat=remat, device="meta")
    net = net.to_empty(device=dev)
    net.load_state_dict(params, strict=True)
    n = sum(p.numel() for p in net.parameters())
    if n != int(cfg["params"]):
        raise AssertionError(f"{cfg['name']} has {n} parameters, its configuration says {cfg['params']}")
    return net


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


def launch_counts() -> tuple:
    """(K1, K1 backward, K2, K2 backward) launches so far."""
    from adunet_torch.kernels import launch_counts as counts

    k1, k1b, k2, _rows, k2b, _rows_b = counts()
    return k1, k1b, k2, k2b


def save_artifact(net, out_dir: str, cfg: dict) -> None:
    from adunet_torch.export import save_artifact as save

    serve = cfg["serve"]
    save(net, out_dir, image_size=int(cfg["patch_size"]), batch_size=int(serve["batch_size"]),
         quantize=serve.get("quantize"))


def server(artifact_dir: str, traffic: dict, device):
    from adunet_torch.cli.serve import make_server

    return make_server(artifact_dir, host="127.0.0.1", port=0,
                       batch_window_ms=float(traffic["batch_window_ms"]),
                       max_concurrent_requests=int(traffic["max_concurrent_requests"]),
                       device=str(device))
