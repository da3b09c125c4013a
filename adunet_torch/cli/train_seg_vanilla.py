"""Train the vanilla (baseline) segmentation U-Net.

Port of ``adunet/cli/train_seg_vanilla.py`` with the same flags and run
artifacts: generic image / mask pairing (ISIC and Cityscapes-style
suffixes), flips-only ``--augment`` on the device, the LayerNorm U-Net with
its ConvTranspose decoder, BCE with accuracy and pooled precision, recall
and global Dice (``--num_classes`` > 1: class-weighted CE, pooled mIoU and
global Dice on one-hot labels), best checkpoints on the monitored metric,
early stopping (patience 10), ReduceLROnPlateau on ``val_loss`` (factor 0.5,
patience 5, min 1e-6), a ``<run_name>_final`` checkpoint and ``config.json``
with the reference's keys. ``--device`` is ``cuda`` by default, which raises
without a GPU; ``cpu`` runs the kernels' plain versions.
``--async_checkpoint`` writes the best checkpoints on a background thread.
Several GPUs: one process per GPU under ``torchrun``, as ``train_seg``
(``--batch_size`` per process, ``--n_devices`` equal to ``WORLD_SIZE`` or
omitted, an equal-length shard of the training pairs per process with the
last batch padded, DDP, sharded validation with the pooled metrics' sums
reduced, process 0 writing the artifacts).

    python -m adunet_torch.cli.train_seg_vanilla --train_image_dir DIR \\
        --train_mask_dir DIR --val_image_dir DIR --val_mask_dir DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from datetime import datetime
from pathlib import Path
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a baseline U-Net for binary segmentation (PyTorch).")
    parser.add_argument("--train_image_dir", type=Path, required=True)
    parser.add_argument("--train_mask_dir", type=Path, required=True)
    parser.add_argument("--val_image_dir", type=Path, required=True)
    parser.add_argument("--val_mask_dir", type=Path, required=True)
    parser.add_argument("--image_suffix", type=str, default=".jpg")
    parser.add_argument("--mask_suffix", type=str, default="_segmentation.png")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--base_channels", type=int, default=32)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--num_classes", type=int, default=1,
                        help=">1 switches to the softmax head, class-weighted CE loss and mIoU eval.")
    parser.add_argument("--class_weights", type=str, default=None,
                        help="Comma-separated per-class CE weights, e.g. '0.5,2.0,1.0'. "
                             "Defaults to uniform. Only used when --num_classes > 1.")
    parser.add_argument("--model_dir", type=Path, default=Path("runs/models"))
    parser.add_argument("--log_dir", type=Path, default=Path("runs/logs"))
    parser.add_argument("--run_name", type=str, default="unet_isic")
    parser.add_argument("--seed", type=int, default=13)
    parser.add_argument("--limit_train", type=int, default=None)
    parser.add_argument("--limit_val", type=int, default=None)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--async_checkpoint", action="store_true")
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def train(args: argparse.Namespace, argv: Optional[List[str]] = None) -> dict:
    """Train and write the run's artifacts; returns ``config.json``'s payload
    plus the run directory and the state. ``argv`` goes into the
    ``torchrun`` hint of a single-process ``--n_devices`` above 1."""
    from adunet_torch.data import SegPairDataset, discover_pairs
    from adunet_torch.losses import binary_crossentropy, make_weighted_ce_loss
    from adunet_torch.metrics import (
        binary_accuracy,
        pooled_global_dice,
        pooled_mean_iou,
        pooled_precision,
        pooled_recall,
    )
    from adunet_torch.models import build_unet
    from adunet_torch.train import (
        CheckpointManager,
        create_train_state,
        fit,
        make_optimizer,
        make_seg_eval_step,
        make_seg_train_step,
        metric_finalizers_of,
        repeat,
    )
    from adunet_torch.parallel import (
        broadcast_from_main,
        data_parallel,
        is_main_process,
        launch_mesh,
        process_seed,
        process_shard,
    )
    from adunet_torch.utils.runtime import resolve_device

    mesh = launch_mesh(args.device, n_devices=args.n_devices,
                       command=("adunet_torch.cli.train_seg_vanilla", argv or []))
    dev = resolve_device(args.device)
    train_pairs = discover_pairs(args.train_image_dir.expanduser(), args.train_mask_dir.expanduser(),
                                 args.image_suffix, args.mask_suffix, args.limit_train)
    val_pairs = discover_pairs(args.val_image_dir.expanduser(), args.val_mask_dir.expanduser(),
                               args.image_suffix, args.mask_suffix, args.limit_val)
    print(f"Discovered {len(train_pairs)} train / {len(val_pairs)} val image-mask pairs.")
    train_pairs = process_shard(train_pairs, seed=args.seed)  # this process's equal share

    # the vanilla reference resizes images bilinearly
    train_ds = SegPairDataset(train_pairs, batch_size=args.batch_size, image_size=args.image_size,
                              augment=args.augment, shuffle=True, seed=args.seed,
                              num_classes=args.num_classes, image_interp="linear",
                              pad_tail=mesh is not None)
    val_ds = SegPairDataset(val_pairs, batch_size=args.batch_size, image_size=args.image_size,
                            augment=False, shuffle=False, seed=args.seed,
                            num_classes=args.num_classes, image_interp="linear")
    steps_per_epoch = math.ceil(len(train_pairs) / args.batch_size)

    dtype = torch.bfloat16 if args.mixed_precision else torch.float32
    model = build_unet(args.image_size, num_classes=args.num_classes,
                       base_channels=args.base_channels, depth=args.depth, dtype=dtype,
                       device=dev, seed=args.seed)

    if args.num_classes > 1:
        if args.class_weights:
            weights = [float(tok) for tok in args.class_weights.split(",")]
            if len(weights) != args.num_classes:
                raise ValueError(f"--class_weights has {len(weights)} entries for "
                                 f"{args.num_classes} classes.")
        else:
            weights = [1.0] * args.num_classes
        loss_fn = make_weighted_ce_loss(weights)
        # pooled: the monitored metric stays a whole-set value under the
        # per-sample validation, not a mean of per-image values
        extra = {"mean_iou": pooled_mean_iou(args.num_classes),
                 "dice_coefficient": pooled_global_dice()}
        monitor = "val_mean_iou"
    else:
        loss_fn = binary_crossentropy
        extra = {
            "accuracy": binary_accuracy,  # equal pixel counts: the per-sample mean is exact
            "precision": pooled_precision(),
            "recall": pooled_recall(),
            "dice_coefficient": pooled_global_dice(),
        }
        monitor = "val_dice_coefficient"

    state = create_train_state(model, make_optimizer(model.parameters(), args.learning_rate,
                                                     inject_lr=True))
    n_params = sum(p.numel() for p in model.parameters())
    if mesh is not None:
        state = data_parallel(state, mesh)

    timestamp = broadcast_from_main(datetime.now().strftime("%Y%m%d-%H%M%S"))
    run_dir = Path(args.log_dir).expanduser() / f"{args.run_name}_{timestamp}"
    run_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = Path(args.model_dir).expanduser() / f"{args.run_name}_best"
    print(f"Checkpoints will be written to {ckpt_dir}")
    ckpt = CheckpointManager(ckpt_dir, monitor=monitor, mode="max",
                             async_save=args.async_checkpoint)

    train_step = make_seg_train_step(model, loss_fn, augment="flips" if args.augment else "none",
                                     extra_metrics=extra)
    eval_step = make_seg_eval_step(model, loss_fn, extra_metrics=extra, per_sample=True)
    result = fit(
        state,
        repeat(train_ds),
        train_step,
        steps_per_epoch=steps_per_epoch,
        epochs=args.epochs,
        rng=torch.Generator(device=dev).manual_seed(process_seed(args.seed)),
        val_data=val_ds,
        val_step=eval_step,
        monitor=monitor,
        monitor_mode="max",
        patience=10,
        restore_best_weights=True,
        reduce_lr_on_plateau={"monitor": "val_loss", "mode": "min",
                              "factor": 0.5, "patience": 5, "min_lr": 1e-6},
        ckpt=ckpt,
        log_dir=run_dir,
        metric_finalizers=metric_finalizers_of(extra),
    )
    state = result.state
    ckpt.close()

    final_dir = Path(args.model_dir).expanduser() / f"{args.run_name}_final"
    CheckpointManager(final_dir, monitor=monitor, mode="max").save(len(result.history), state)

    payload = {
        "run_name": args.run_name,
        "n_params": n_params,
        "num_classes": args.num_classes,
        "monitor": monitor,
        "epochs_ran": len(result.history),
        "best_epoch": result.best_epoch,
        "best_val_metric": result.best_metric,
        "best_val_dice": result.best_metric,
        "checkpoint": str(ckpt_dir),
        "final_checkpoint": str(final_dir),
        "created_at": timestamp,
    }
    if is_main_process():
        (run_dir / "config.json").write_text(json.dumps(payload, indent=2, default=str))
    return {**payload, "run_dir": str(run_dir), "state": state}


def main(argv: Optional[List[str]] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    return train(parse_args(argv), argv)


if __name__ == "__main__":
    main()
