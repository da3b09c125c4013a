"""Train the joint SR + segmentation shared-encoder U-Net (BASELINE config 5).

Port of ``adunet/cli/train_joint.py`` with the same flags and run artifacts:
``<log_dir>/<run_name>_<timestamp>/`` holds ``config.json`` (the reference's
keys: the flags, ``depth``, ``bottleneck_size``, ``n_params``,
``n_devices``, ``steps_per_epoch``, ``created_at``), ``epoch_metrics.csv``,
``result.json`` and, where ``tensorboardX`` imports, the TensorBoard events
of every epoch (``train/*``, ``val/*``, ``perf/*``); the checkpoints go to
``<model_dir>/<run_name>_best/`` (best by ``val_loss`` with validation
directories, else by ``loss``, and the latest). Each step degrades the
images on the device at ``--scale``, restores them through the SR decoder
and segments them through the seg decoder. ``--device`` is ``cuda`` by
default, which raises without a GPU; ``cpu`` runs the kernels' plain
versions. Several GPUs: one process per GPU under ``torchrun``, as
``train_sr`` (``--batch_size`` per process, ``--n_devices`` equal to
``WORLD_SIZE`` or omitted, an equal-length shard of the training pairs per
process, DDP, sharded validation, process 0 writing the artifacts).

    python -m adunet_torch.cli.train_joint --train_image_dir DIR --train_mask_dir DIR \\
        [--val_image_dir DIR --val_mask_dir DIR] --mixed_precision [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime
from pathlib import Path
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train the joint SR+segmentation shared-encoder U-Net (PyTorch).")
    parser.add_argument("--train_image_dir", type=Path, required=True)
    parser.add_argument("--train_mask_dir", type=Path, required=True)
    parser.add_argument("--val_image_dir", type=Path, default=None)
    parser.add_argument("--val_mask_dir", type=Path, default=None)
    parser.add_argument("--image_suffix", type=str, default=".jpg")
    parser.add_argument("--mask_suffix", type=str, default="_segmentation.png")
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--scale", type=float, default=0.5,
                        help="Encoder shrink ratio AND LR degradation factor.")
    parser.add_argument("--depth_override", type=int, default=None)
    parser.add_argument("--base_channels", type=int, default=64)
    parser.add_argument("--residual_head_channels", type=int, default=64)
    parser.add_argument("--num_classes", type=int, default=1)
    parser.add_argument("--sr_loss", type=str, default="charbonnier", choices=["charbonnier", "l1"])
    parser.add_argument("--sr_weight", type=float, default=1.0)
    parser.add_argument("--seg_weight", type=float, default=1.0)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--limit_train", type=int, default=None)
    parser.add_argument("--limit_val", type=int, default=None)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="Write the per-epoch checkpoints on a background thread.")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--model_dir", type=Path, default=Path("runs/models"))
    parser.add_argument("--log_dir", type=Path, default=Path("runs/logs"))
    parser.add_argument("--run_name", type=str, default="joint_sr_seg")
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def train(args: argparse.Namespace, argv: Optional[List[str]] = None) -> dict:
    """Train and write the run's artifacts; returns ``result.json``'s payload
    plus the run directory and the state. ``argv`` goes into the
    ``torchrun`` hint of a single-process ``--n_devices`` above 1."""
    from adunet_torch.data import SegPairDataset, discover_pairs
    from adunet_torch.losses import charbonnier_loss, l1_loss, make_bce_dice_loss, make_weighted_ce_loss
    from adunet_torch.models import build_joint_unet
    from adunet_torch.train import (
        CheckpointManager,
        create_train_state,
        fit,
        make_joint_eval_step,
        make_joint_train_step,
        make_optimizer,
        open_tb_writer,
        repeat,
    )
    from adunet_torch.parallel import (
        broadcast_from_main,
        data_parallel,
        is_main_process,
        launch_mesh,
        process_count,
        process_shard,
    )
    from adunet_torch.utils.runtime import resolve_device

    mesh = launch_mesh(args.device, n_devices=args.n_devices,
                       command=("adunet_torch.cli.train_joint", argv or []))
    dev = resolve_device(args.device)
    main = is_main_process()
    train_pairs = discover_pairs(args.train_image_dir.expanduser(), args.train_mask_dir.expanduser(),
                                 args.image_suffix, args.mask_suffix, args.limit_train)
    val_pairs = None
    if args.val_image_dir is not None and args.val_mask_dir is not None:
        val_pairs = discover_pairs(args.val_image_dir.expanduser(), args.val_mask_dir.expanduser(),
                                   args.image_suffix, args.mask_suffix, args.limit_val)
    print(f"Loaded {len(train_pairs)} train pairs"
          + (f", {len(val_pairs)} val pairs." if val_pairs else "."))
    train_pairs = process_shard(train_pairs, seed=args.seed)  # this process's equal share

    train_ds = SegPairDataset(train_pairs, batch_size=args.batch_size, image_size=args.image_size,
                              augment=False, shuffle=True, seed=args.seed,
                              num_classes=args.num_classes, drop_remainder=True)
    val_ds = None
    if val_pairs:
        val_ds = SegPairDataset(val_pairs, batch_size=args.batch_size, image_size=args.image_size,
                                augment=False, shuffle=False, seed=args.seed,
                                num_classes=args.num_classes)
    steps_per_epoch = train_ds.steps_per_epoch

    dtype = torch.bfloat16 if args.mixed_precision else torch.float32
    model, info = build_joint_unet(
        scale=args.scale,
        base_channels=args.base_channels,
        residual_head_channels=args.residual_head_channels,
        num_classes=args.num_classes,
        depth_override=args.depth_override,
        input_size=args.image_size,
        dtype=dtype,
        remat=args.remat,
        device=dev,
        seed=args.seed,
    )
    sr_loss_fn = charbonnier_loss if args.sr_loss == "charbonnier" else l1_loss
    if args.num_classes > 1:
        seg_loss_fn = make_weighted_ce_loss([1.0] * args.num_classes)
    else:
        seg_loss_fn = make_bce_dice_loss(0.5, 1.0)
    state = create_train_state(model, make_optimizer(model.parameters(), args.learning_rate))
    n_params = sum(p.numel() for p in model.parameters())
    if mesh is not None:
        state = data_parallel(state, mesh)

    timestamp = broadcast_from_main(datetime.now().strftime("%Y%m%d-%H%M%S"))
    run_dir = Path(args.log_dir).expanduser() / f"{args.run_name}_{timestamp}"
    run_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = Path(args.model_dir).expanduser() / f"{args.run_name}_best"
    monitor = "val_loss" if val_ds is not None else "loss"
    ckpt = CheckpointManager(ckpt_dir, monitor=monitor, mode="min",
                             async_save=args.async_checkpoint)

    # the reference's keys: its flags (not the port's --device), then the run's
    config_payload = {
        **{k: str(v) if isinstance(v, Path) else v for k, v in vars(args).items()
           if k != "device"},
        "depth": info["depth"],
        "bottleneck_size": info["bottleneck_size"],
        "n_params": n_params,
        "n_devices": process_count(),
        "steps_per_epoch": steps_per_epoch,
        "created_at": timestamp,
    }
    if main:
        (run_dir / "config.json").write_text(json.dumps(config_payload, indent=2, default=str))
    ckpt.write_config(config_payload)
    print(f"Joint model: depth={info['depth']} params={n_params:,} devices={process_count()} "
          f"device={dev}")

    step_kwargs = dict(sr_weight=args.sr_weight, seg_weight=args.seg_weight,
                       data_scale=args.scale)
    train_step = make_joint_train_step(model, sr_loss_fn, seg_loss_fn, **step_kwargs)
    eval_step = make_joint_eval_step(model, sr_loss_fn, seg_loss_fn, per_sample=True,
                                     **step_kwargs)
    tb_writer = open_tb_writer(run_dir) if main else None
    try:
        result = fit(
            state,
            repeat(train_ds),
            train_step,
            steps_per_epoch=steps_per_epoch,
            epochs=args.epochs,
            val_data=val_ds,
            val_step=eval_step if val_ds is not None else None,
            monitor=monitor,
            monitor_mode="min",
            patience=args.patience,
            restore_best_weights=True,
            ckpt=ckpt,
            log_dir=run_dir,
            tb_writer=tb_writer,
        )
    finally:
        if tb_writer is not None:
            tb_writer.close()

    payload = {
        "run_name": args.run_name,
        "n_params": n_params,
        "depth": info["depth"],
        "epochs_ran": len(result.history),
        "best_epoch": result.best_epoch,
        "best_val_loss": result.best_metric,
        "final_metrics": result.history[-1].row() if result.history else {},
        "checkpoint": str(ckpt_dir),
        "created_at": timestamp,
    }
    if main:
        (run_dir / "result.json").write_text(json.dumps(payload, indent=2, default=str))
    ckpt.close()
    return {**payload, "run_dir": str(run_dir), "state": result.state}


def main(argv: Optional[List[str]] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    return train(parse_args(argv), argv)


if __name__ == "__main__":
    main()
