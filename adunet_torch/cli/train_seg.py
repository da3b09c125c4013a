"""Train the adaptive-depth segmentation U-Net under a protocol (A or B).

Port of ``adunet/cli/train_seg.py`` with the same flags and run artifacts:
``config.json`` (in the run directory and the checkpoint directory, the
reference's keys), ``epoch_metrics.csv`` (the reference's columns),
``model_summary.txt`` (the port's module listing), best and latest
checkpoints monitored on ``val_dice``, and the final "Validation metrics"
lines. ``--device`` is ``cuda`` by default, which raises without a GPU;
``cpu`` runs the kernels' plain versions. ISIC pairs (images beside
``*_segmentation`` masks, ``.jpg`` / ``.png`` / ``.npy``) are decoded on the
host and augmented on the device inside the train step.
``--async_checkpoint`` writes the checkpoints on a background thread.
Several GPUs: one process per GPU under ``torchrun``, as ``train_sr``
(``adunet/cli/train_seg.py:99-117``): ``--batch_size`` per process,
``--n_devices`` equal to ``WORLD_SIZE`` or omitted, each process on its own
equal-length shard of the training pairs with the last batch padded
(``pad_tail``), BatchNorm on the global batch's statistics, DDP averaging
the gradients, validation sharded, and process 0 writing the artifacts.
Where ``tensorboardX`` imports, each epoch's ``train/*``, ``val/*`` and
``perf/*`` scalars go to TensorBoard events in the run directory.

    python -m adunet_torch.cli.train_seg --protocol A --train_images DIR \\
        --train_masks DIR --val_images DIR --val_masks DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from datetime import datetime
from pathlib import Path
from typing import List, Optional

import torch

from adunet_torch.configs import PROTOCOLS, SegTrainConfig


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train Adaptive-Depth U-Net on ISIC-2017 segmentation (PyTorch).")
    parser.add_argument("--protocol", type=str, choices=["A", "B"], default="A")
    parser.add_argument("--epochs", type=int, default=0, help="Override epochs (0 keeps protocol default).")
    parser.add_argument("--batch_size", type=int, default=0, help="Override batch size (0 keeps protocol default).")
    parser.add_argument("--base_channels", type=int, default=64)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--image_size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--patience", type=int, default=None)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--no_augment", action="store_true")
    parser.add_argument("--model_dir", type=str, default="runs/models")
    parser.add_argument("--log_dir", type=str, default="runs/logs")
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--train_images", type=str, required=True)
    parser.add_argument("--train_masks", type=str, required=True)
    parser.add_argument("--val_images", type=str, required=True)
    parser.add_argument("--val_masks", type=str, required=True)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--precise_bn", type=int, default=0,
                        help="Re-estimate BN population stats from N train batches "
                             "before each validation (0 = momentum EMA, Keras parity).")
    parser.add_argument("--async_checkpoint", action="store_true")
    parser.add_argument("--cache_decoded", action="store_true",
                        help="Decode+resize each (image, mask) pair once and keep it in "
                             "host RAM across epochs.")
    parser.add_argument("--no_val_device_cache", dest="val_device_cache", action="store_false",
                        help="Do not keep the validation batches on the device between epochs.")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> SegTrainConfig:
    fields = {f.name for f in dataclasses.fields(SegTrainConfig)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    kwargs["augment"] = not args.no_augment
    return SegTrainConfig(**kwargs).resolved()


def weighted_eval(eval_step, state, dataset) -> dict:
    """Per-sample eval metrics averaged over every sample of ``dataset``
    (sorted by name, as the reference's)."""
    sums: dict = {}
    total = 0
    for batch in dataset:
        out = eval_step(state, batch)
        n = batch[0].shape[0]
        for k, v in out.items():
            sums[k] = sums.get(k, 0.0) + float(v.mean()) * n
        total += n
    return {k: sums[k] / total for k in sorted(sums)}


def train(cfg: SegTrainConfig, argv: Optional[List[str]] = None) -> dict:
    """Train, validate and write the run's artifacts; returns the run and
    checkpoint directories, the final validation metrics and the state.
    ``argv`` goes into the ``torchrun`` hint of a single-process
    ``--n_devices`` above 1."""
    from adunet_torch.data import build_isic_dataset
    from adunet_torch.losses import make_bce_dice_loss, make_hybrid_ce_dice_loss
    from adunet_torch.models import build_adaptive_depth_unet
    from adunet_torch.train import (
        CheckpointManager,
        create_train_state,
        fit,
        make_optimizer,
        make_seg_eval_step,
        make_seg_train_step,
        open_tb_writer,
        repeat,
    )
    from adunet_torch.parallel import (
        broadcast_from_main,
        data_parallel,
        is_main_process,
        launch_mesh,
        process_count,
        process_seed,
    )
    from adunet_torch.utils.runtime import resolve_device

    mesh = launch_mesh(cfg.device, n_devices=cfg.n_devices,
                       command=("adunet_torch.cli.train_seg", argv or []))
    dev = resolve_device(cfg.device)
    main = is_main_process()
    protocol = PROTOCOLS[cfg.protocol]

    train_ds, train_count = build_isic_dataset(
        cfg.train_images, cfg.train_masks, batch_size=cfg.batch_size,
        image_size=cfg.image_size, augment=cfg.augment, shuffle=True, seed=cfg.seed,
        limit=cfg.limit, cache_decoded=cfg.cache_decoded, shard_across_processes=True,
        # across processes every train batch has the full local size
        pad_tail=mesh is not None,
    )
    val_ds, val_count = build_isic_dataset(
        cfg.val_images, cfg.val_masks, batch_size=cfg.batch_size,
        image_size=cfg.image_size, augment=False, shuffle=False, seed=cfg.seed,
        limit=cfg.limit, cache_decoded=cfg.cache_decoded,
    )
    steps_per_epoch = math.ceil(train_count / cfg.batch_size)

    dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
    model = build_adaptive_depth_unet(input_size=cfg.image_size, base_channels=cfg.base_channels,
                                      depth=cfg.depth, dtype=dtype, device=dev, seed=cfg.seed)
    if protocol.loss == "hybrid_ce_dice":
        loss_fn = make_hybrid_ce_dice_loss(protocol.loss_alpha, protocol.loss_beta)
    else:
        loss_fn = make_bce_dice_loss(protocol.loss_alpha, protocol.loss_beta)
    optimizer = make_optimizer(
        model.parameters(), protocol.initial_lr,
        cosine_decay_steps=(cfg.epochs * max(steps_per_epoch, 1)) if protocol.cosine_schedule else None,
    )
    state = create_train_state(model, optimizer)
    n_params = sum(p.numel() for p in model.parameters())
    if mesh is not None:
        state = data_parallel(state, mesh)

    timestamp = broadcast_from_main(datetime.now().strftime("%Y%m%d-%H%M%S"))
    run_name = cfg.run_name or f"protocol{protocol.key}_seed{cfg.seed}_{timestamp}"
    run_dir = Path(cfg.log_dir).expanduser() / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = Path(cfg.model_dir).expanduser() / run_name

    print(f"Model: depth={cfg.depth} params={n_params:,} devices={process_count()} "
          f"protocol={protocol.key} device={dev}")
    if main:
        (run_dir / "model_summary.txt").write_text(f"{model!r}\nTotal params: {n_params:,}\n")
    ckpt = CheckpointManager(ckpt_dir, monitor="val_dice", mode="max",
                             async_save=cfg.async_checkpoint)

    tb_writer = open_tb_writer(run_dir) if main else None
    train_step = make_seg_train_step(model, loss_fn, augment=cfg.augment)
    eval_step = make_seg_eval_step(model, loss_fn, per_sample=True)

    pre_val_hook = None
    if cfg.precise_bn > 0:
        from adunet_torch.train import make_bn_refresh_step, precise_batch_stats, snapshot_refresh_batches

        refresh = make_bn_refresh_step()
        # un-augmented training images, identical every epoch: decoded and
        # moved to the device once; the training shuffle is not advanced
        refresh_batches = snapshot_refresh_batches(
            train_ds, cfg.precise_bn, put=lambda x: torch.from_numpy(x).to(dev))

        def pre_val_hook(s_):
            return precise_batch_stats(s_, refresh_batches, refresh)

    result = fit(
        state,
        repeat(train_ds),
        train_step,
        steps_per_epoch=steps_per_epoch,
        epochs=cfg.epochs,
        rng=torch.Generator(device=dev).manual_seed(process_seed(cfg.seed)),
        val_data=val_ds,
        val_step=eval_step,
        monitor="val_dice",
        monitor_mode="max",
        patience=cfg.patience,
        restore_best_weights=True,
        ckpt=ckpt,
        log_dir=run_dir,
        pre_val_hook=pre_val_hook,
        cache_val_on_device=cfg.val_device_cache,
        tb_writer=tb_writer,
    )
    state = result.state
    eval_metrics = weighted_eval(eval_step, state, val_ds)

    config_payload = {
        "protocol": protocol.key,
        "description": protocol.description,
        "epochs_requested": cfg.epochs,
        "epochs_ran": len(result.history),
        "initial_lr": protocol.initial_lr,
        "batch_size": cfg.batch_size,
        "image_size": cfg.image_size,
        "depth": cfg.depth,
        "base_channels": cfg.base_channels,
        "n_params": n_params,
        "n_devices": process_count(),
        "train_samples": train_count,
        "val_samples": val_count,
        "train_steps_per_epoch": steps_per_epoch,
        "seed": cfg.seed,
        "mixed_precision": bool(cfg.mixed_precision),
        "threshold": cfg.threshold,
        "model_checkpoint": str(ckpt_dir),
        "train_images": str(cfg.train_images),
        "train_masks": str(cfg.train_masks),
        "val_images": str(cfg.val_images),
        "val_masks": str(cfg.val_masks),
        "metrics": eval_metrics,
        "created_at": timestamp,
    }
    if main:
        (run_dir / "config.json").write_text(json.dumps(config_payload, indent=2, default=str))
    ckpt.write_config(config_payload)
    if tb_writer is not None:
        tb_writer.close()
    ckpt.close()

    print("Validation metrics:")
    for key, value in eval_metrics.items():
        print(f"  {key}: {value:.4f}")
    return {"run_dir": str(run_dir), "ckpt_dir": str(ckpt_dir), "metrics": eval_metrics,
            "history_epochs": len(result.history), "best_epoch": result.best_epoch,
            "state": state}


def main(argv: Optional[List[str]] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    return train(config_from_args(parse_args(argv)), argv)


if __name__ == "__main__":
    main()
