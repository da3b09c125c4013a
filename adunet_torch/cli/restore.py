"""Restore a directory of images with a trained SR model.

Port of ``adunet/cli/restore.py``: images of any size are tiled with
``--overlap`` px between neighbouring tiles (the last tile of a row or
column right-aligned; an image smaller than a tile reflect-padded), restored
``--batch-size`` tiles at a time, and stitched back with weights that ramp
linearly inside the overlap. Inputs are degraded at ``--scale`` first unless
``--assume-lr`` says they already are low resolution. The weights come from
a ``train_sr`` checkpoint directory (``--model-path``; the best checkpoint,
or the latest with ``--latest``) or from a serving artifact
(``--from-export``, read by ``adunet_torch.export.load_artifact``: the
port's program, or a reference int8 weight file; an artifact with its
weights baked into StableHLO is refused with the server's error). Outputs are ``<stem>_restored.png`` where cv2 is
importable, else ``.npy``. ``--device`` is ``cuda`` by default (raises
without a GPU) or ``cpu``.

    python -m adunet_torch.cli.restore --model-path DIR --scale 0.5 \\
        --input-dir IN --output-dir OUT --image-suffix .npy [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Restore a directory of images with a trained SR "
                                                 "model (PyTorch).")
    parser.add_argument("--model-path", type=Path, default=None,
                        help="Checkpoint directory written by train_sr.")
    parser.add_argument("--from-export", type=Path, default=None,
                        help="Restore with an int8 weight-file serving artifact instead of a "
                             "checkpoint.")
    parser.add_argument("--scale", type=float, default=None,
                        help="Degradation scale; required unless --assume-lr skips the synthetic "
                             "degrade (checkpoint loads also need it to rebuild the "
                             "architecture).")
    parser.add_argument("--input-dir", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--image-suffix", type=str, default=".png")
    parser.add_argument("--patch-size", type=int, default=256)
    parser.add_argument("--overlap", type=int, default=32,
                        help="Tile overlap in px; overlapping predictions blend linearly.")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--depth-override", type=int, default=None)
    parser.add_argument("--latest", action="store_true",
                        help="Load the most recent checkpoint instead of the best-val one.")
    parser.add_argument("--assume-lr", action="store_true",
                        help="Treat inputs as already-degraded LR images.")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    args = parser.parse_args(argv)

    if args.from_export is not None and args.model_path is not None:
        parser.error("--model-path and --from-export are mutually exclusive; "
                     "pick one weight source.")
    if args.from_export is not None and args.depth_override is not None:
        parser.error("--depth-override has no effect on an exported artifact "
                     "(the depth is baked into the StableHLO program).")
    if args.from_export is not None and args.latest:
        parser.error("--latest has no effect on an exported artifact; "
                     "re-export from the desired checkpoint instead.")
    needs_scale = not args.assume_lr or args.from_export is None
    if needs_scale and args.scale is None:
        parser.error("--scale is required (it drives the synthetic degrade "
                     "and/or the checkpoint architecture rebuild).")
    return args


def _tile_starts(extent: int, patch: int, overlap: int) -> List[int]:
    """Start offsets covering [0, extent) with ``overlap`` px shared between
    neighbours; the last tile is right-aligned."""
    if extent <= patch:
        return [0]
    stride = max(patch - overlap, 1)
    starts = list(range(0, extent - patch, stride))
    starts.append(extent - patch)
    return starts


def _blend_weights(patch: int, overlap: int) -> np.ndarray:
    """(patch, patch) weights ramping linearly inside the overlap margins,
    the taper clamped to half the patch so the two ramps never meet."""
    ramp = np.ones(patch, np.float32)
    taper = min(max(overlap, 1), patch // 2)
    edge = np.linspace(1.0 / (taper + 1), 1.0, taper, dtype=np.float32)
    ramp[:taper] = edge
    ramp[-taper:] = edge[::-1]
    return ramp[:, None] * ramp[None, :]


def restore_image(image: np.ndarray, forward: Callable[[np.ndarray], np.ndarray], patch: int,
                  overlap: int, batch_size: int) -> np.ndarray:
    """Tile → ``forward`` (float32 (B, P, P, 3) numpy in and out) → stitch
    with linear overlap blending; the result is clipped to [0, 1] and has the
    input's (H, W)."""
    h, w = image.shape[:2]
    pad_h, pad_w = max(0, patch - h), max(0, patch - w)
    if pad_h or pad_w:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
    ph, pw = image.shape[:2]
    coords = [(y, x) for y in _tile_starts(ph, patch, overlap)
              for x in _tile_starts(pw, patch, overlap)]
    weights = _blend_weights(patch, overlap)
    out = np.zeros((ph, pw, 3), np.float32)
    norm = np.zeros((ph, pw, 1), np.float32)
    for i in range(0, len(coords), batch_size):
        chunk = coords[i : i + batch_size]
        tiles = np.stack([image[y : y + patch, x : x + patch] for y, x in chunk])
        preds = np.asarray(forward(tiles.astype(np.float32)))
        for (y, x), pred in zip(chunk, preds):
            out[y : y + patch, x : x + patch] += pred * weights[..., None]
            norm[y : y + patch, x : x + patch] += weights[..., None]
    out = out / np.maximum(norm, 1e-8)
    return np.clip(out[:h, :w], 0.0, 1.0)


def _checkpoint_forward(args: argparse.Namespace):
    import torch

    from adunet_torch.cli.evaluate import load_checkpoint_state
    from adunet_torch.ops import degrade

    _state, model, info = load_checkpoint_state(args.model_path, args.scale, args.patch_size,
                                                args.depth_override, best=not args.latest,
                                                device=args.device)
    dev = next(model.parameters()).device

    def forward(tiles: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(tiles).to(dev)
            if not args.assume_lr:
                x = degrade(x, args.scale, args.patch_size)
            return torch.clamp(model(x).to(torch.float32), 0.0, 1.0).cpu().numpy()

    return forward, f"depth-{info['depth']} model (scale {args.scale})"


def _export_forward(args: argparse.Namespace):
    import torch

    from adunet_torch.export import load_artifact
    from adunet_torch.ops import degrade

    call, manifest = load_artifact(args.from_export, device=args.device)
    in_shape = manifest.get("input_shape")
    if in_shape:  # the artifact's tile size and batch win over the flags
        args.batch_size, args.patch_size = int(in_shape[0]), int(in_shape[1])
    dev = call.device

    def forward(tiles: np.ndarray) -> np.ndarray:
        if not args.assume_lr:
            with torch.inference_mode():
                tiles = degrade(torch.from_numpy(tiles).to(dev), args.scale,
                                args.patch_size).cpu().numpy()
        return call(tiles)

    return forward, f"exported artifact {args.from_export} (depth {manifest.get('depth', '?')})"


def main(argv: Optional[List[str]] = None) -> List[Path]:
    args = parse_args(argv)
    from adunet_torch.data import find_images, load_rgb_image_full
    from adunet_torch.data.io import cv2  # None without OpenCV, decided at its import

    files = find_images(args.input_dir, args.image_suffix, args.limit)
    if args.from_export is not None:
        forward, what = _export_forward(args)
    elif args.model_path is not None:
        forward, what = _checkpoint_forward(args)
    else:
        raise SystemExit("one of --model-path / --from-export is required")
    print(f"Restoring {len(files)} images with the {what}, tiles {args.patch_size}px, "
          f"overlap {args.overlap}px.")

    out_dir = args.output_dir.expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for path in files:
        restored = restore_image(load_rgb_image_full(path), forward, args.patch_size, args.overlap,
                                 args.batch_size)
        target = out_dir / (Path(path).stem + "_restored.png")
        if cv2 is not None:
            cv2.imwrite(str(target), np.round(restored * 255.0).astype(np.uint8)[..., ::-1])
        else:
            target = target.with_suffix(".npy")
            np.save(target, restored)
        written.append(target)
        print(f"  {Path(path).name} -> {target.name}")
    print(f"[done] {len(files)} restored images in {out_dir}")
    return written


if __name__ == "__main__":
    main()
