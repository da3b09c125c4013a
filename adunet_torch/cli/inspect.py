"""Visual inspection grids for trained SR checkpoints.

Port of ``adunet/cli/inspect.py`` (a rebuild of the reference notebook
model_eval_0_6.py): for each selected image, a 2x5 grid — top row full-frame
HR / degraded LR / prediction / |error| heatmap / Sobel-edge difference;
bottom row the same panels auto-zoomed around the maximum-error pixel — with
the per-image PSNR/SSIM in the title.

The computation (``inspect_example``: the panels, their crops around the
peak error, PSNR and SSIM, all numpy arrays) is apart from the rendering
(``render_grid``, matplotlib). The forward runs on ``--device`` (``cuda`` by
default, raising without a GPU, or ``cpu``) through the checkpoint's model at
its full width, so on the card K1 and K2 launch. The grids need matplotlib:
without it ``main`` raises ``ImportError`` before it loads anything.

    python -m adunet_torch.cli.inspect --model-path runs/models/unet_adaptive_scale0.50_depth3 \\
        --scale 0.5 --hr-dir DIR --image-suffix .npy [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

_PANELS = (("HR", None), ("LR (degraded)", None), ("Prediction", None), ("|error|", "magma"),
           ("edge diff", "viridis"))


def _sobel_mag(gray: np.ndarray) -> np.ndarray:
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)
    ky = kx.T
    pad = np.pad(gray, 1, mode="edge")
    h, w = gray.shape
    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    for dy in range(3):
        for dx in range(3):
            window = pad[dy : dy + h, dx : dx + w]
            gx += kx[dy, dx] * window
            gy += ky[dy, dx] * window
    return np.sqrt(gx**2 + gy**2)


def crop_around(arr: np.ndarray, cy: int, cx: int, half: int) -> np.ndarray:
    h, w = arr.shape[:2]
    y0 = int(np.clip(cy - half, 0, max(h - 2 * half, 0)))
    x0 = int(np.clip(cx - half, 0, max(w - 2 * half, 0)))
    return arr[y0 : y0 + 2 * half, x0 : x0 + 2 * half]


def inspect_example(model: torch.nn.Module, hr: np.ndarray, scale: float, patch_size: int,
                    zoom_half: int = 32) -> Dict[str, object]:
    """One HR patch (P, P, 3) in [0, 1] through degradation and ``model`` (on
    its own device): ``panels`` [(name, image, colormap)], ``crops`` (each
    panel zoomed around the peak error), ``peak`` (y, x), and the prediction's
    ``psnr`` / ``ssim`` against the HR patch."""
    from adunet_torch.metrics import psnr, ssim
    from adunet_torch.ops import degrade

    device = next(model.parameters()).device
    hr_t = torch.from_numpy(np.ascontiguousarray(hr, dtype=np.float32)).to(device)[None]
    with torch.no_grad():
        lr_t = degrade(hr_t, scale, patch_size)
        pred_t = torch.clamp(model(lr_t).to(torch.float32), 0.0, 1.0)
        p = float(psnr(hr_t, pred_t)[0])
        s = float(ssim(hr_t, pred_t)[0])
    lr, pred = lr_t[0].cpu().numpy(), pred_t[0].cpu().numpy()
    err = np.abs(hr - pred).mean(axis=-1)
    edge_diff = np.abs(_sobel_mag(hr.mean(axis=-1)) - _sobel_mag(pred.mean(axis=-1)))
    cy, cx = np.unravel_index(np.argmax(err), err.shape)
    images = (hr, lr, pred, err, edge_diff)
    panels = [(name, img, cmap) for (name, cmap), img in zip(_PANELS, images)]
    return {"panels": panels, "crops": [crop_around(img, cy, cx, zoom_half) for img in images],
            "peak": (int(cy), int(cx)), "psnr": p, "ssim": s}


def _pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError naming it when absent."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("adunet_torch.cli.inspect renders its grids with matplotlib, which is "
                          "not installed here; inspect_example computes them without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_grid(example: Dict[str, object], out_path: Path, title: str = "") -> None:
    """The 2x5 grid of ``inspect_example``'s panels (top) and crops (bottom)."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 5, figsize=(18, 7.5))
    for col, ((name, img, cmap), zoom) in enumerate(zip(example["panels"], example["crops"])):
        axes[0, col].imshow(np.clip(img, 0, 1) if cmap is None else img, cmap=cmap)
        axes[0, col].set_title(name)
        axes[1, col].imshow(np.clip(zoom, 0, 1) if cmap is None else zoom, cmap=cmap)
        axes[1, col].set_title(f"{name} (zoom @max-err)")
    for ax in axes.ravel():
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Render SR inspection grids (PyTorch).")
    parser.add_argument("--model-path", type=Path, required=True,
                        help="Checkpoint directory (from train_sr).")
    parser.add_argument("--scale", type=float, required=True)
    parser.add_argument("--hr-dir", type=Path, required=True)
    parser.add_argument("--image-suffix", type=str, default=".png")
    parser.add_argument("--patch-size", type=int, default=256)
    parser.add_argument("--n-examples", type=int, default=4)
    parser.add_argument("--depth-override", type=int, default=None)
    parser.add_argument("--latest", action="store_true",
                        help="Inspect the most recent checkpoint instead of the "
                             "best-val one the evaluation pipeline reports on.")
    parser.add_argument("--output-dir", type=Path, default=Path("runs/inspection"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Path]:
    args = parse_args(argv)
    _pyplot()  # before any loading: the grids are what this CLI is for

    from adunet_torch.cli.evaluate import load_checkpoint_state
    from adunet_torch.data import find_images, load_rgb_image_full, random_patches
    from adunet_torch.utils import setup_runtime

    setup_runtime()
    files = find_images(args.hr_dir, args.image_suffix)
    rng = np.random.default_rng(args.seed)
    chosen = rng.choice(len(files), size=min(args.n_examples, len(files)), replace=False)
    _state, model, _info = load_checkpoint_state(
        args.model_path, args.scale, args.patch_size, args.depth_override,
        best=not args.latest,  # render the model the eval pipeline reports on
        device=args.device,
    )
    written = []
    for idx in chosen:
        image = load_rgb_image_full(files[idx])
        if min(image.shape[:2]) < args.patch_size:
            continue
        hr = random_patches(image, args.patch_size, count=1, rng=rng)[0]
        example = inspect_example(model, hr, args.scale, args.patch_size)
        name = Path(files[idx]).stem
        out = args.output_dir / f"{name}_scale{args.scale:.2f}.png"
        render_grid(example, out,
                    title=f"{name} — PSNR {example['psnr']:.2f} dB, SSIM {example['ssim']:.4f}")
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
