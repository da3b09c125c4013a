"""Train the vanilla fixed-depth SR U-Net (the baseline).

Port of ``adunet/cli/train_sr_vanilla.py`` with the same flags and run
artifacts: in-memory HR and LR stacks from two paired directories
(``load_image_stack``, square area resize to ``--hr_size``), the seeded
train / val / test split, the BatchNorm U-Net with its sigmoid head, the
``combined`` loss by default (MSE + SSIM + the VGG19 perceptual term on
``--vgg_weights`` or seeded random weights), ``fit`` with per-sample
validation, early stopping and best checkpoints on ``val_loss``, then RGB
PSNR / SSIM / MS-SSIM mean ± std over the validation and test splits, and a
``config.json`` with the reference's keys. ``--device`` is ``cuda`` by
default (raises without a GPU) or ``cpu``. Several GPUs: one process per
GPU under ``torchrun``, as ``train_sr`` (``--batch_size`` per process,
``--n_devices`` equal to ``WORLD_SIZE`` or omitted, an equal-length shard of
the training images per process, BatchNorm on the global batch, DDP,
sharded validation, process 0 writing the artifacts).

    python -m adunet_torch.cli.train_sr_vanilla --high_res_dir HR --low_res_dir LR \\
        [--mixed_precision] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train the vanilla SR U-Net baseline (PyTorch).")
    parser.add_argument("--high_res_dir", type=Path, required=True)
    parser.add_argument("--low_res_dir", type=Path, required=True)
    parser.add_argument("--hr_size", type=int, default=256)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--val_split", type=float, default=0.1)
    parser.add_argument("--test_split", type=float, default=0.1)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--base_channels", type=int, default=64)
    parser.add_argument("--loss", type=str, default="combined",
                        choices=["combined", "charbonnier", "l1"])
    parser.add_argument("--vgg_weights", type=str, default=None,
                        help="Optional .npz with ImageNet VGG19 weights for the perceptual term.")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="Write the per-epoch checkpoints on a background thread.")
    parser.add_argument("--model_dir", type=Path, default=Path("runs/models"))
    parser.add_argument("--log_dir", type=Path, default=Path("runs/logs"))
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def make_rgb_eval_step():
    """``(state, (lr, hr)) -> {psnr, ssim, ms_ssim}`` per sample, on the
    prediction clipped to [0, 1], with the running BatchNorm statistics."""
    from adunet_torch.metrics import msssim_power_factors_for, psnr, ssim, ssim_multiscale
    from adunet_torch.train.sr import _pair_of

    @torch.no_grad()
    def step(state, batch) -> Dict[str, torch.Tensor]:
        lr_batch, hr_batch = _pair_of(batch, next(state.model.parameters()).device)
        state.model.eval()
        pred = torch.clamp(state.model(lr_batch).to(torch.float32), 0.0, 1.0)
        hr = hr_batch.to(torch.float32)
        pf = msssim_power_factors_for(min(hr.shape[-3], hr.shape[-2]))
        return {"psnr": psnr(hr, pred), "ssim": ssim(hr, pred),
                "ms_ssim": ssim_multiscale(hr, pred, power_factors=pf)}

    return step


def evaluate(state, dataset, eval_step) -> Dict[str, Tuple[float, float]]:
    """RGB PSNR / SSIM / MS-SSIM (mean, std) in float64 over ``dataset``."""
    acc: Dict[str, list] = {"psnr": [], "ssim": [], "ms_ssim": []}
    for batch in dataset:
        out = eval_step(state, batch)
        for k in acc:
            acc[k].append(out[k].cpu().numpy())
    if not acc["psnr"]:
        return {}

    def mean_std(chunks):
        arr = np.concatenate(chunks, axis=0).astype(np.float64)
        return float(np.mean(arr)), float(np.std(arr))

    return {k: mean_std(v) for k, v in acc.items()}


def train(args: argparse.Namespace, argv: Optional[List[str]] = None) -> dict:
    """Train and evaluate; returns ``config.json``'s payload plus the run
    directory, the checkpoint directory and the state. ``argv`` goes into
    the ``torchrun`` hint of a single-process ``--n_devices`` above 1."""
    from adunet_torch.data import ArrayDataset, load_image_stack, make_array_dataset
    from adunet_torch.losses import build_losses_and_metrics, make_perceptual_fn
    from adunet_torch.models import build_vanilla_sr_unet
    from adunet_torch.train import (
        CheckpointManager,
        create_train_state,
        fit,
        make_optimizer,
        make_vanilla_sr_train_step,
        make_vanilla_sr_val_step,
        repeat,
    )
    from adunet_torch.utils.misc import split_indices
    from adunet_torch.parallel import (
        broadcast_from_main,
        data_parallel,
        is_main_process,
        launch_mesh,
        process_shard,
    )
    from adunet_torch.utils.runtime import resolve_device

    mesh = launch_mesh(args.device, n_devices=args.n_devices,
                       command=("adunet_torch.cli.train_sr_vanilla", argv or []))
    dev = resolve_device(args.device)
    hr_images = load_image_stack(args.high_res_dir.expanduser(), args.hr_size, limit=args.limit)
    lr_images = load_image_stack(args.low_res_dir.expanduser(), args.hr_size, limit=args.limit)
    if hr_images.shape != lr_images.shape:
        raise ValueError("HR and LR stacks differ in length; need one LR per HR image.")

    train_split = 1.0 - (args.val_split + args.test_split)
    tr_idx, va_idx, te_idx = split_indices(hr_images.shape[0], train_split, args.val_split,
                                           args.test_split, args.seed)
    mine = np.asarray(process_shard(list(tr_idx), seed=args.seed))  # this process's equal share
    train_ds = ArrayDataset(lr_images[mine], hr_images[mine],
                            batch_size=args.batch_size, shuffle=True, seed=args.seed,
                            drop_remainder=True)
    val_ds = make_array_dataset(lr_images, hr_images, va_idx, args.batch_size, False, args.seed)
    test_ds = make_array_dataset(lr_images, hr_images, te_idx, args.batch_size, False, args.seed)

    dtype = torch.bfloat16 if args.mixed_precision else torch.float32
    model = build_vanilla_sr_unet(base_channels=args.base_channels, dtype=dtype, device=dev,
                                  seed=args.seed)
    perceptual_fn = None
    if args.loss == "combined":
        perceptual_fn = make_perceptual_fn(args.vgg_weights, input_size=args.hr_size, dtype=dtype,
                                           device=dev)
    loss_fn, _ = build_losses_and_metrics(args.loss, perceptual_fn=perceptual_fn)
    state = create_train_state(model, make_optimizer(model.parameters(), args.learning_rate))
    n_params = sum(p.numel() for p in model.parameters())
    if mesh is not None:
        state = data_parallel(state, mesh)

    timestamp = broadcast_from_main(datetime.now().strftime("%Y%m%d-%H%M%S"))
    run_name = args.run_name or f"vanilla_sr_{timestamp}"
    run_dir = Path(args.log_dir).expanduser() / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = Path(args.model_dir).expanduser() / f"{run_name}_best"
    ckpt = CheckpointManager(ckpt_dir, monitor="val_loss", mode="min",
                             async_save=args.async_checkpoint)
    print(f"Model: vanilla SR U-Net, {n_params:,} params, device={dev}")

    result = fit(
        state,
        repeat(train_ds),
        make_vanilla_sr_train_step(model, loss_fn),
        steps_per_epoch=train_ds.steps_per_epoch,
        epochs=args.epochs,
        val_data=val_ds,
        val_step=make_vanilla_sr_val_step(model, loss_fn, per_sample=True),
        monitor="val_loss",
        monitor_mode="min",
        patience=args.patience,
        ckpt=ckpt,
        log_dir=run_dir,
    )
    state = result.state

    eval_step = make_rgb_eval_step()
    results = {}
    for name, ds in (("validation", val_ds), ("test", test_ds)):
        if len(ds):
            results[name] = evaluate(state, ds, eval_step)
            print(f"{name}: " + ", ".join(f"{k}={m:.4f}±{s:.4f}"
                                          for k, (m, s) in results[name].items()))
    payload = {
        "run_name": run_name,
        "loss": args.loss,
        "epochs_ran": len(result.history),
        "best_epoch": result.best_epoch,
        "results": results,
        "created_at": timestamp,
    }
    if is_main_process():
        (run_dir / "config.json").write_text(json.dumps(payload, indent=2, default=str))
    ckpt.close()
    return {**payload, "run_dir": str(run_dir), "ckpt_dir": str(ckpt_dir), "n_params": n_params,
            "state": state}


def main(argv: Optional[List[str]] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    return train(parse_args(argv), argv)


if __name__ == "__main__":
    main()
