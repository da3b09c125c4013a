"""Offline evaluation of a trained SR checkpoint.

Port of ``adunet/cli/evaluate.py``: the architecture is rebuilt from the
checkpoint directory's ``config.json`` (``train_sr`` writes it), the best
checkpoint by validation loss is loaded (the latest with ``--latest``), the
HR images are grid-tiled, degraded at ``--scale`` and restored, and the
Y-channel PSNR / SSIM / MS-SSIM / MSE with the border shave are written as
the reference's reports (``config.json``, ``metrics.json``,
``per_image_metrics.csv``) under ``<output-dir>/<run-name>``. ``--device``
is ``cuda`` by default (raises without a GPU) or ``cpu``. Under ``torchrun``
the tiles are sharded over the processes (``evaluate_sr``'s mesh: each scores
its share, the per-patch numbers gathered back), every process gets the
numbers one process computes, and process 0 writes the reports
(``adunet/cli/evaluate.py:122-133``):

    torchrun --nproc-per-node N -m adunet_torch.cli.evaluate --model-path ... --scale 0.5 ...

    python -m adunet_torch.cli.evaluate --model-path runs/models/unet_adaptive_scale0.50_depth3 \\
        --scale 0.5 --hr-dir DIR --image-suffix .npy [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime
from pathlib import Path
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Offline grid-tile evaluation of a trained SR "
                                                 "checkpoint (PyTorch).")
    parser.add_argument("--model-path", type=Path, required=True,
                        help="Checkpoint directory written by train_sr.")
    parser.add_argument("--scale", type=float, required=True)
    parser.add_argument("--hr-dir", type=Path, required=True)
    parser.add_argument("--image-suffix", type=str, default=".png")
    parser.add_argument("--patch-size", type=int, default=256)
    parser.add_argument("--eval-stride", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--eval-shave", type=int, default=None)
    parser.add_argument("--depth-override", type=int, default=None)
    parser.add_argument("--latest", action="store_true",
                        help="Load the most recent checkpoint instead of the best-val one.")
    parser.add_argument("--best", action="store_true", help=argparse.SUPPRESS)  # legacy no-op
    parser.add_argument("--output-dir", type=Path, default=Path("runs/evaluation"))
    parser.add_argument("--run-name", type=str, default=None)
    parser.add_argument("--skip-per-image", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def load_checkpoint_state(model_path: Path, scale: float, patch_size: int,
                          depth_override: Optional[int], best: bool = False,
                          device: str = "cuda"):
    """(state, model, info): the float32 model rebuilt from ``config.json``
    with the best (or latest) checkpoint's weights. Without a config.json a
    ``depth_override`` is required, as in the reference."""
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

    model_path = Path(model_path).expanduser()
    cfg_file = model_path / "config.json"
    overrides = {}
    if cfg_file.exists():
        saved = json.loads(cfg_file.read_text())
        overrides = {
            "base_channels": saved.get("base_channels", 64),
            "residual_head_channels": saved.get("residual_head_channels", 64),
            "max_depth": saved.get("max_depth", 7),
        }
        if depth_override is None:
            depth_override = saved.get("depth")
    elif depth_override is None:
        raise FileNotFoundError(f"{cfg_file} not found (interrupted run?) and no --depth-override "
                                "given; cannot rebuild the architecture safely.")
    model, info = build_super_resolution_unet(scale=scale, depth_override=depth_override,
                                              input_size=patch_size, device=device, **overrides)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    mngr = CheckpointManager(model_path, monitor="val_loss", mode="min")
    restored = mngr.restore_best(state) if best else mngr.restore_latest(state)
    if restored is None:
        raise FileNotFoundError(f"No checkpoints found under {model_path}")
    model.eval()
    return restored, model, info


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)

    from adunet_torch.data import find_images, make_eval_patch_dataset
    from adunet_torch.evaluate import attach_filenames, evaluate_sr, infer_eval_shave, write_outputs
    from adunet_torch.parallel import is_main_process, make_mesh, maybe_initialize_distributed

    mesh = make_mesh() if maybe_initialize_distributed(args.device) else None

    hr_files = find_images(args.hr_dir, args.image_suffix, args.limit)
    eval_ds, _total, patch_labels = make_eval_patch_dataset(
        hr_files, patch_size=args.patch_size, scale=args.scale, batch_size=args.batch_size,
        stride=args.eval_stride)
    state, _model, info = load_checkpoint_state(args.model_path, args.scale, args.patch_size,
                                                args.depth_override, best=not args.latest,
                                                device=args.device)
    eval_shave = infer_eval_shave(args.scale, args.eval_shave)
    summary, per_patch = evaluate_sr(state, eval_ds, eval_scale=args.scale, eval_shave=eval_shave,
                                     mesh=mesh)
    attach_filenames(per_patch, patch_labels)

    print(f"Scored {summary.samples} patches across {len(hr_files)} images.")
    print(f"  PSNR(Y):     {summary.psnr_mean:.4f} +/- {summary.psnr_std:.4f} dB")
    print(f"  SSIM(Y):     {summary.ssim_mean:.4f} +/- {summary.ssim_std:.4f}")
    print(f"  MS-SSIM(Y):  {summary.msssim_mean:.4f} +/- {summary.msssim_std:.4f}")
    print(f"  MSE(Y):      {summary.mse_mean:.6f} +/- {summary.mse_std:.6f}")

    timestamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    run_name = args.run_name or f"scale{args.scale:.2f}_{timestamp}"
    run_dir = Path(args.output_dir).expanduser() / run_name
    config_payload = {
        "model_path": str(Path(args.model_path).expanduser()),
        "scale": args.scale,
        "hr_dir": str(args.hr_dir),
        "patch_size": args.patch_size,
        "eval_stride": args.eval_stride or args.patch_size,
        "batch_size": args.batch_size,
        "limit": args.limit,
        "eval_shave": eval_shave,
        "depth_override": args.depth_override,
        "depth": info["depth"],
        "samples": summary.samples,
        "images": len(hr_files),
        "created_at": timestamp,
    }
    if is_main_process():
        write_outputs(run_dir, summary, per_patch, config_payload, not args.skip_per_image)
        print(f"[done] Evaluation report at {run_dir}")
    return {"run_dir": str(run_dir), "summary": summary, "per_patch": per_patch}


if __name__ == "__main__":
    main()
