"""Train the adaptive-depth SR U-Net.

Port of ``adunet/cli/train_sr.py`` with the same flags and the same run
artifacts (``config.json`` in the run and checkpoint directories,
``model_summary.txt``, ``epoch_metrics.csv``, best and latest checkpoints,
the post-training Validation / Test PSNR(Y) lines), plus ``--device``
(``cuda`` by default, which raises without a GPU; ``cpu`` runs the kernels'
plain versions).

Three data paths, as in the reference:

- the streamed patch pipeline (the default): random HR crops decoded and cut
  on the host (``--uint8_feed`` ships them as uint8, ``--cache_decoded``
  keeps the decoded corpus in host memory, ``--shuffle_buffer``), copied to
  the card one batch ahead from pinned memory (``device_feed``); the step
  degrades them on the card;
- ``--device_cache``: the whole corpus on the card as uint8, each step
  sampling its own patches there;
- ``--low_res_dir``: whole images of a paired directory, area-resized to
  ``--patch_size``, as an ``ArrayDataset`` of ``(lr, hr)`` batches.

``--loss combined`` adds the VGG19 perceptual term (``--vgg19_npz`` weights,
else seeded random ones), ``--remat`` / ``--remat_levels`` checkpoint the
ConvBlocks, ``--async_checkpoint`` writes checkpoints on a background thread.

Several GPUs: one process per GPU under ``torchrun`` (the reference's
multi-process mode, ``adunet/cli/train_sr.py:155-160, 250-330``).
``--batch_size`` is per process, so the global batch is ``batch_size x
world``; ``--n_devices`` is the mesh's global device count and must equal
``WORLD_SIZE`` or be omitted (in a plain process above 1 it raises with the
``torchrun`` line). Each process trains on its own equal-length shard of the
training images (``process_shard``) with its own random stream
(``process_seed``); DDP averages the gradients. ``--model_shards M`` shards
the wide levels' weights and Adam moments over M processes
(``adunet_torch.parallel.partition``; data extent ``world / M``).
Validation and the post-training evaluation are sharded over the
processes, and process 0 writes the run's artifacts. Where ``tensorboardX`` imports,
the run directory gets the reference's TensorBoard events
(``adunet/cli/train_sr.py:396-443, 561-564``): at step 0 the
hyperparameters and model summary as text, the dataset census scalars and
the preview HR / LR patches as images and histograms; each epoch's
``train/*``, ``val/*`` and ``perf/*`` scalars (``fit``); the ``eval/*``
scalars of the post-training evaluation.

    python -m adunet_torch.cli.train_sr --scale 0.5 --depth_override 3 \\
        --mixed_precision --uint8_feed --cache_decoded --batch_size 32 \\
        --patch_size 256 --high_res_dir DIR --image_suffix .npy [--device cpu]
    torchrun --nproc-per-node 4 -m adunet_torch.cli.train_sr ... [--model_shards 2]
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

import numpy as np
import torch

from adunet_torch.configs import SRTrainConfig


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train adaptive-depth U-Net for super-resolution (PyTorch).")
    parser.add_argument("--scale", type=float, required=True, help="Downscale factor (0 < scale < 1).")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--loss", type=str, default="charbonnier", choices=["charbonnier", "l1", "combined"])
    parser.add_argument("--vgg19_npz", type=str, default=None)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--val_split", type=float, default=0.1)
    parser.add_argument("--test_split", type=float, default=0.1)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--patch_size", type=int, default=256)
    parser.add_argument("--patches_per_image", type=int, default=4)
    parser.add_argument("--eval_stride", type=int, default=None)
    parser.add_argument("--shuffle_buffer", type=int, default=1024)
    parser.add_argument("--eval_shave", type=int, default=None)
    parser.add_argument("--depth_override", type=int, default=None)
    parser.add_argument("--max_depth", type=int, default=7)
    parser.add_argument("--base_channels", type=int, default=64)
    parser.add_argument("--residual_head_channels", type=int, default=64)
    parser.add_argument("--mixed_precision", action="store_true", help="bf16 compute / f32 params.")
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--remat_levels", type=int, default=None)
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Split each batch into N micro-batches and apply one update on "
                             "the mean gradient (exact full-batch math at 1/N activation memory).")
    parser.add_argument("--consistent_degradation", action="store_true",
                        help="Train-time LR degradation at --scale instead of the reference's constant 0.5.")
    parser.add_argument("--model_dir", type=str, default="runs/models")
    parser.add_argument("--log_dir", type=str, default="runs/logs")
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--high_res_dir", type=str, required=False, default=None)
    parser.add_argument("--image_suffix", type=str, default=".png")
    parser.add_argument("--low_res_dir", type=str, default=None)
    parser.add_argument("--resume_from", type=str, default=None,
                        help="Checkpoint directory to resume from.")
    parser.add_argument("--initial_epoch", type=int, default=0)
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--model_shards", type=int, default=1)
    parser.add_argument("--preview_patches", type=int, default=3)
    parser.add_argument("--uint8_feed", action="store_true")
    parser.add_argument("--cache_decoded", action="store_true")
    parser.add_argument("--device_cache", action="store_true",
                        help="Hold the (uniform-size) training corpus on the device as uint8 and "
                             "sample patches inside the step.")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler trace of the first epoch into <run_dir>/profile.")
    parser.add_argument("--async_checkpoint", action="store_true")
    parser.add_argument("--ckpt_every", type=int, default=1,
                        help="Checkpoint cadence in epochs; the final/early-stop epoch always saves.")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> SRTrainConfig:
    fields = {f.name for f in dataclasses.fields(SRTrainConfig)}
    cfg = SRTrainConfig(**{k: v for k, v in vars(args).items() if k in fields})
    cfg.validate()
    return cfg


def train(cfg: SRTrainConfig, argv: Optional[List[str]] = None) -> dict:
    """Run the training and the post-training evaluation; returns the run's
    directories, eval summaries, epoch count, best epoch and final state.
    ``argv`` (the command's arguments) goes into the ``torchrun`` hint of a
    single-process ``--n_devices`` above 1."""
    from adunet_torch.data import (
        ArrayDataset,
        device_feed,
        find_images,
        grid_patch_count,
        load_device_cache,
        load_rgb_image,
        load_rgb_image_full,
        make_eval_patch_dataset,
        make_training_patch_dataset,
        pair_lr_files,
        random_patches,
        read_image_size,
    )
    from adunet_torch.evaluate import evaluate_sr, infer_eval_shave
    from adunet_torch.losses import build_losses_and_metrics, make_perceptual_fn
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.ops import degrade
    from adunet_torch.train import (
        CheckpointManager,
        create_train_state,
        fit,
        make_optimizer,
        make_sr_device_cache_train_step,
        make_sr_train_step,
        make_sr_val_step,
        open_tb_writer,
        repeat,
    )
    from adunet_torch.parallel import (
        barrier,
        broadcast_from_main,
        data_extent,
        data_index,
        data_parallel,
        is_main_process,
        launch_mesh,
        process_count,
        process_seed,
        process_shard,
    )
    from adunet_torch.utils.misc import split_indices
    from adunet_torch.utils.runtime import resolve_device

    mesh = launch_mesh(cfg.device, n_devices=cfg.n_devices, model_shards=cfg.model_shards,
                       batch_size=cfg.batch_size, grad_accum=cfg.grad_accum,
                       command=("adunet_torch.cli.train_sr", argv or []))
    if cfg.high_res_dir is None:
        raise ValueError("--high_res_dir is required (no cluster default paths in this build).")
    dev = resolve_device(cfg.device)
    main = is_main_process()

    hr_paths = find_images(cfg.high_res_dir, cfg.image_suffix, cfg.limit)
    train_split = 1.0 - (cfg.val_split + cfg.test_split)
    train_idx, val_idx, test_idx = split_indices(
        len(hr_paths), train_split, cfg.val_split, cfg.test_split, cfg.seed
    )
    train_paths = [hr_paths[i] for i in train_idx]
    val_paths = [hr_paths[i] for i in val_idx]
    test_paths = [hr_paths[i] for i in test_idx]
    # each data shard streams its own equal-length slice of the training
    # images, with its own random stream (a model-shard group shares one)
    shard = {"index": data_index(mesh), "count": data_extent(mesh)}
    train_paths = process_shard(train_paths, seed=cfg.seed, **shard)
    data_seed = process_seed(cfg.seed, index=shard["index"])
    degrade_scale = cfg.train_degrade_scale()
    paired = bool(cfg.low_res_dir)

    if paired:
        # whole images area-resized to patch_size, paired by file name
        lr_paths_all = pair_lr_files(hr_paths, cfg.low_res_dir)

        def paired_dataset(idx, shuffle: bool, drop_remainder: bool):
            if not len(idx):
                return None
            hr_stack = np.stack([load_rgb_image(hr_paths[i], cfg.patch_size) for i in idx])
            lr_stack = np.stack([load_rgb_image(lr_paths_all[i], cfg.patch_size) for i in idx])
            return ArrayDataset(lr_stack, hr_stack, batch_size=cfg.batch_size, shuffle=shuffle,
                                seed=cfg.seed, drop_remainder=drop_remainder)

        train_ds = paired_dataset(process_shard(list(train_idx), seed=cfg.seed, **shard),
                                  shuffle=True, drop_remainder=True)
        if train_ds is None:
            raise ValueError("Paired mode requires at least one training image.")
        train_patch_count = len(train_idx)
        steps_per_epoch = train_ds.steps_per_epoch
        val_ds = paired_dataset(val_idx, shuffle=False, drop_remainder=False)
        val_patch_count, test_patch_count = len(val_idx), len(test_idx)
    else:
        # the epoch length of the patch stream: patches_per_image random
        # crops per training image
        train_patch_count = len(train_paths) * cfg.patches_per_image
        steps_per_epoch = math.ceil(train_patch_count / cfg.batch_size)
        val_ds, val_patch_count = None, 0
        if val_paths:
            val_ds, val_patch_count, _ = make_eval_patch_dataset(
                val_paths, patch_size=cfg.patch_size, scale=degrade_scale,
                batch_size=cfg.batch_size, stride=cfg.eval_stride)
        # census only: counted from the image headers, nothing decoded
        test_patch_count = sum(grid_patch_count(*read_image_size(p), cfg.patch_size,
                                                stride=cfg.eval_stride or cfg.patch_size)
                               for p in test_paths)
    dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
    model, info = build_super_resolution_unet(
        scale=cfg.scale,
        base_channels=cfg.base_channels,
        residual_head_channels=cfg.residual_head_channels,
        depth_override=cfg.depth_override,
        input_size=cfg.patch_size,
        max_depth=cfg.max_depth,
        dtype=dtype,
        remat=cfg.remat,
        remat_levels=cfg.remat_levels,
        device=dev,
        seed=cfg.seed,
    )
    perceptual_fn = None
    if cfg.loss == "combined":
        perceptual_fn = make_perceptual_fn(cfg.vgg19_npz, input_size=cfg.patch_size, dtype=dtype,
                                           device=dev)
    loss_fn, _metrics = build_losses_and_metrics(cfg.loss, perceptual_fn=perceptual_fn)
    state = create_train_state(model, make_optimizer(model.parameters(), cfg.learning_rate))
    n_params = sum(p.numel() for p in model.parameters())
    if mesh is not None:
        state = data_parallel(state, mesh)

    timestamp = broadcast_from_main(datetime.now().strftime("%Y%m%d-%H%M%S"))
    inferred = f"scale{cfg.scale:.2f}_bs{cfg.batch_size}_lr{cfg.learning_rate:.0e}_{timestamp}"
    run_name = cfg.run_name or inferred
    run_dir = Path(cfg.log_dir).expanduser() / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    model_dir = Path(cfg.model_dir).expanduser()
    model_dir.mkdir(parents=True, exist_ok=True)
    ckpt_dir = model_dir / f"unet_adaptive_scale{cfg.scale:.2f}_depth{info['depth']}"

    config_payload = {
        **dataclasses.asdict(cfg),
        "depth": info["depth"],
        "bottleneck_size": info["bottleneck_size"],
        "n_params": n_params,
        "n_devices": process_count(),
        "train_images": len(train_paths),
        "val_images": len(val_paths),
        "test_images": len(test_paths),
        "train_patches_per_epoch": int(train_patch_count),
        "steps_per_epoch": int(steps_per_epoch),
        "low_res_mode": "paired_directory" if paired else "synthetic_patches",
        "created_at": timestamp,
    }
    model_table = (f"{model!r}\nTotal params: {n_params:,}\ndepth: {info['depth']}\n"
                   f"bottleneck: {info['bottleneck_size']}px\n")
    if main:  # host-side artifacts: process 0 only
        (run_dir / "config.json").write_text(json.dumps(config_payload, indent=2, default=str))
        (run_dir / "model_summary.txt").write_text(model_table)
    print(f"Model: depth={info['depth']} params={n_params:,} device={dev} "
          f"processes={process_count()}")

    ckpt = CheckpointManager(ckpt_dir, monitor="val_loss", mode="min",
                             async_save=cfg.async_checkpoint)
    stored_cfg = {}
    if (ckpt_dir / "config.json").exists():
        stored_cfg = json.loads((ckpt_dir / "config.json").read_text())
    barrier()  # every process has read the stored config before process 0 rewrites it
    ckpt.write_config(config_payload)

    initial_epoch = cfg.initial_epoch
    if cfg.resume_from:
        resume_mngr = CheckpointManager(Path(cfg.resume_from).expanduser(), monitor="val_loss", mode="min")
        if resume_mngr.restore_latest(state) is None:
            raise FileNotFoundError(f"--resume_from {cfg.resume_from} contains no checkpoints.")
        if initial_epoch == 0:
            initial_epoch = int(resume_mngr.latest_step() or 0)
            print(f"[info] resuming from epoch {initial_epoch} (checkpoint step).")
    elif ckpt.latest_step() is not None:
        # a restarted run with the same directories resumes (the reference's
        # BackupAndRestore), warning when the stored flags differ
        drift = {
            key: (stored_cfg.get(key), config_payload.get(key))
            for key in ("scale", "depth_override", "max_depth", "base_channels",
                        "patch_size", "patches_per_image", "batch_size", "seed",
                        "loss", "data_lr_shrink", "consistent_degradation",
                        "high_res_dir", "low_res_dir")
            if key in stored_cfg and stored_cfg.get(key) != config_payload.get(key)
        }
        if drift:
            print("[warn] auto-resume checkpoints were trained under DIFFERENT "
                  "flags; continuing mixes training regimes: "
                  + ", ".join(f"{k}: {old!r} -> {new!r}" for k, (old, new) in sorted(drift.items())))
        ckpt.restore_latest(state)
        initial_epoch = int(ckpt.latest_step())
        print(f"[info] auto-resume from existing checkpoints at epoch {initial_epoch}.")
    elif initial_epoch > 0:
        print("[warn] --initial_epoch was set without --resume_from; training will skip "
              "the initial epochs but start from random weights.")

    tb_writer = open_tb_writer(run_dir) if main else None
    if tb_writer is not None:
        tb_writer.add_text("config/hyperparameters",
                           "```json\n" + json.dumps(config_payload, indent=2, default=str)
                           + "\n```", 0)
        tb_writer.add_text("model/summary", "```\n" + model_table + "\n```", 0)
        census = {"images/train": len(train_paths), "images/val": len(val_paths),
                  "images/test": len(test_paths), "patches_per_epoch/train": train_patch_count,
                  "patches/val": val_patch_count, "patches/test": test_patch_count}
        for tag, value in census.items():
            tb_writer.add_scalar(f"dataset/{tag}", int(value), 0)
        preview_count = min(cfg.preview_patches, len(train_paths))
        if preview_count > 0:
            if paired:
                lr_preview, hr_preview = next(iter(paired_dataset(
                    train_idx[:preview_count], shuffle=False, drop_remainder=False)))
            else:
                hr_preview = random_patches(load_rgb_image_full(train_paths[0]), cfg.patch_size,
                                            count=preview_count,
                                            rng=np.random.default_rng(cfg.seed))
                lr_preview = degrade(torch.from_numpy(hr_preview), degrade_scale,
                                     cfg.patch_size).numpy()
            for name, arr in (("hr", hr_preview), ("lr", lr_preview)):
                arr01 = np.clip(arr, 0.0, 1.0)
                tb_writer.add_images(f"samples/{name}_train", arr01, 0, dataformats="NHWC")
                tb_writer.add_histogram(f"hist/{name}_train", arr01.reshape(-1), 0)

    samples_per_step = None
    if cfg.device_cache and not paired:
        cache = load_device_cache(train_paths, dev)
        print(f"[device_cache] {cache.shape[0]} images "
              f"({cache.numel() / 1e6:.0f} MB uint8) resident on {dev}.")
        train_step = make_sr_device_cache_train_step(
            model, loss_fn, cache, patch_size=cfg.patch_size, batch_size=cfg.batch_size,
            data_scale=degrade_scale, grad_accum=cfg.grad_accum,
        )
        samples_per_step = cfg.batch_size

        def device_cache_feed():
            while True:
                yield None  # the generator is the data source

        train_iter = device_cache_feed()
    else:
        if not paired:
            train_ds, _ = make_training_patch_dataset(
                train_paths, patch_size=cfg.patch_size, patches_per_image=cfg.patches_per_image,
                scale=degrade_scale, batch_size=cfg.batch_size, seed=data_seed,
                shuffle_buffer=cfg.shuffle_buffer,
                output_dtype="uint8" if cfg.uint8_feed else "float32",
                cache_decoded=cfg.cache_decoded,
            )
        train_step = make_sr_train_step(model, loss_fn, data_scale=degrade_scale,
                                        grad_accum=cfg.grad_accum)
        train_iter = device_feed(repeat(train_ds) if paired else train_ds, dev)

    val_step = make_sr_val_step(model, loss_fn, data_scale=degrade_scale, per_sample=True)
    try:
        result = fit(
            state,
            train_iter,
            train_step,
            steps_per_epoch=steps_per_epoch,
            epochs=cfg.epochs,
            initial_epoch=initial_epoch,
            rng=torch.Generator(device=dev).manual_seed(data_seed),
            val_data=val_ds,
            val_step=val_step,
            monitor="val_loss",
            monitor_mode="min",
            patience=cfg.patience,
            restore_best_weights=True,
            ckpt=ckpt,
            ckpt_every=cfg.ckpt_every,
            log_dir=run_dir,
            samples_per_step=samples_per_step,
            profile_dir=(run_dir / "profile") if cfg.profile else None,
            tb_writer=tb_writer,
        )
    finally:
        train_iter.close()  # stops the patch producer thread
    state = result.state
    print("Training complete.")
    print(f"Model info: {info}")
    print(f"Checkpoints at: {ckpt_dir}")

    eval_shave = infer_eval_shave(cfg.scale, cfg.eval_shave)
    if eval_shave * 2 >= cfg.patch_size and cfg.patch_size > 0:
        adjusted = max(0, (cfg.patch_size // 2) - 1)
        print(f"[warn] eval_shave={eval_shave} removes the full frame; reducing to {adjusted}.")
        eval_shave = adjusted

    final_metrics = {}
    for name, paths, idx in (("Validation", val_paths, val_idx), ("Test", test_paths, test_idx)):
        if not paths:
            continue
        if paired:
            ds = paired_dataset(idx, shuffle=False, drop_remainder=False)
        else:
            ds, _, _labels = make_eval_patch_dataset(paths, patch_size=cfg.patch_size,
                                                     scale=degrade_scale,
                                                     batch_size=cfg.batch_size,
                                                     stride=cfg.eval_stride)
        summary, _rows = evaluate_sr(state, ds, eval_scale=degrade_scale, eval_shave=eval_shave,
                                     mesh=mesh)
        print(f"{name} patches evaluated: {summary.samples}")
        print(f"  MSE(Y)     : {summary.mse_mean:.6f} +/- {summary.mse_std:.6f}")
        print(f"  PSNR(Y)    : {summary.psnr_mean:.4f} +/- {summary.psnr_std:.4f} dB")
        print(f"  SSIM(Y)    : {summary.ssim_mean:.4f} +/- {summary.ssim_std:.4f}")
        print(f"  MS-SSIM(Y) : {summary.msssim_mean:.4f} +/- {summary.msssim_std:.4f}")
        final_metrics[name.lower()] = dataclasses.asdict(summary)
        if tb_writer is not None:
            step = len(result.history)
            for metric in ("mse", "psnr", "ssim", "msssim"):
                tb_writer.add_scalar(f"eval/{name.lower()}_{metric}_y",
                                     getattr(summary, f"{metric}_mean"), step)

    if tb_writer is not None:
        tb_writer.close()
    ckpt.close()
    return {"run_dir": str(run_dir), "ckpt_dir": str(ckpt_dir), "eval": final_metrics,
            "history_epochs": len(result.history), "best_epoch": result.best_epoch,
            "state": state}


def main(argv: Optional[List[str]] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = config_from_args(parse_args(argv))
    return train(cfg, argv)


if __name__ == "__main__":
    main()
