"""Export a trained checkpoint of the port to a serving artifact.

Port of ``adunet/cli/export_model.py`` with the same flags, plus
``--device`` (``cuda`` by default, which raises without a GPU; ``cpu``).
``--workload sr|seg|joint`` rebuilds the adaptive SR U-Net, the protocol
segmentation U-Net or the joint SR + segmentation U-Net from the checkpoint
directory's ``config.json`` (``train_sr``, ``train_seg`` and
``train_joint`` write it there) and loads its best checkpoint (the latest
with ``--latest``). The artifact (``adunet_torch.export.save_artifact``)
is the port's serving program ``model.pt2``, a ``torch.export`` program
exported on ``--device`` (the manifest's ``platforms``; it runs on either
device), beside its weights file; it has no StableHLO program, so
``--platforms`` changes nothing: when given, it is recorded as
``platforms_requested`` in the manifest, and the artifact loads only in the
port (``adunet_torch.export.load_artifact``, ``adunet_torch.cli.serve``,
``adunet_torch.cli.restore --from-export``).

    python -m adunet_torch.cli.export_model --workload joint \\
        --model-path runs/models/joint_sr_seg_best --output-dir export --quantize int8
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Export a trained model to a serving artifact "
                                                 "of the PyTorch port.")
    parser.add_argument("--workload", choices=["sr", "seg", "joint"], default="sr")
    parser.add_argument("--model-path", type=Path, required=True,
                        help="Checkpoint directory written by train_sr / train_seg / train_joint.")
    parser.add_argument("--scale", type=float, default=None,
                        help="SR encoder shrink ratio (required for --workload sr).")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--patch-size", type=int, default=None,
                        help="Spatial size the artifact serves. SR default: 256. seg/joint "
                             "default: the checkpoint's training image_size.")
    parser.add_argument("--batch-size", type=int, default=8,
                        help="Tile-batch size the artifact serves.")
    parser.add_argument("--platforms", type=str, default=None,
                        help="Accepted for the reference's flags and recorded in the manifest "
                             "as platforms_requested; ignored: the program is exported on "
                             "--device and runs on either device.")
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="Weight-only quantization: conv kernels as int8 + per-channel "
                             "scales (~4x smaller artifact).")
    parser.add_argument("--depth-override", type=int, default=None)
    parser.add_argument("--latest", action="store_true",
                        help="Export the most recent checkpoint instead of the best-val one.")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def _saved_config(model_path: Path, what: str) -> Dict[str, Any]:
    cfg_file = model_path / "config.json"
    if not cfg_file.exists():
        # guessing the architecture would let a wrong-sized model restore:
        # conv weights do not depend on the image size
        raise FileNotFoundError(f"{cfg_file} not found: cannot rebuild the {what} "
                                "architecture (interrupted run?).")
    return json.loads(cfg_file.read_text())


def _restore(model: torch.nn.Module, model_path: Path, monitor: str, mode: str,
             best: bool) -> torch.nn.Module:
    from adunet_torch.train import CheckpointManager

    if CheckpointManager(model_path, monitor=monitor, mode=mode).restore_weights(model, best) is None:
        raise FileNotFoundError(f"No checkpoints found under {model_path}")
    return model.eval()


def load_seg_checkpoint(model_path: Path, depth_override: Optional[int] = None,
                        best: bool = True, device: str = "cuda"
                        ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """The protocol segmentation U-Net rebuilt from ``config.json`` with its
    checkpoint's weights and BatchNorm statistics."""
    from adunet_torch.models import build_adaptive_depth_unet

    model_path = Path(model_path).expanduser()
    saved = _saved_config(model_path, "segmentation")
    image_size = int(saved.get("image_size", 256))
    depth = int(depth_override or saved.get("depth", 4))
    model = build_adaptive_depth_unet(image_size, int(saved.get("base_channels", 64)), depth,
                                      device=device)
    return (_restore(model, model_path, "val_dice", "max", best),
            {"image_size": image_size, "depth": depth})


def load_joint_checkpoint(model_path: Path, best: bool = True, device: str = "cuda"
                          ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """The joint SR + segmentation U-Net rebuilt from ``config.json`` with its
    checkpoint's weights. ``train_joint`` monitors ``val_loss`` only when it
    was given validation directories, else ``loss``."""
    from adunet_torch.models import build_joint_unet

    model_path = Path(model_path).expanduser()
    saved = _saved_config(model_path, "joint")
    image_size = int(saved.get("image_size", 256))
    model, info = build_joint_unet(
        scale=float(saved.get("scale", 0.5)),
        base_channels=int(saved.get("base_channels", 64)),
        residual_head_channels=int(saved.get("residual_head_channels", 64)),
        num_classes=int(saved.get("num_classes", 1)),
        depth_override=int(saved["depth"]) if "depth" in saved else None,
        input_size=image_size,
        device=device,
    )
    monitor = "val_loss" if saved.get("val_image_dir") else "loss"
    return _restore(model, model_path, monitor, "min", best), {**info, "image_size": image_size}


def main(argv: Optional[List[str]] = None) -> Path:
    args = parse_args(argv)
    from adunet_torch.export import save_artifact

    best = not args.latest
    if args.workload == "sr":
        if args.scale is None:
            raise SystemExit("--scale is required for --workload sr")
        from adunet_torch.cli.evaluate import load_checkpoint_state

        size = args.patch_size or 256
        _state, model, info = load_checkpoint_state(args.model_path, args.scale, size,
                                                    args.depth_override, best=best,
                                                    device=args.device)
        meta: Dict[str, Any] = {}
    else:
        if args.workload == "seg":
            model, info = load_seg_checkpoint(args.model_path, args.depth_override, best=best,
                                              device=args.device)
        else:
            model, info = load_joint_checkpoint(args.model_path, best=best, device=args.device)
        size = args.patch_size or info["image_size"]
        meta = {"image_size": size}
    meta["checkpoint"] = str(Path(args.model_path).expanduser())
    if args.platforms is not None:
        meta["platforms_requested"] = [p.strip() for p in args.platforms.split(",") if p.strip()]
    out = save_artifact(model, args.output_dir, image_size=size, batch_size=args.batch_size,
                        quantize=args.quantize, meta=meta)
    manifest = json.loads((out / "manifest.json").read_text())
    size_mb = sum(f.stat().st_size for f in out.iterdir() if f.is_file()) / 1e6
    print(f"[export] {manifest['model']} depth-{info['depth']} -> {out} "
          f"({size_mb:.2f} MB" + (f", {args.quantize} weight-only" if args.quantize else "")
          + ")")
    return out


if __name__ == "__main__":
    main()
