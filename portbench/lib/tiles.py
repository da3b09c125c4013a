"""The serving traffic's tiles: (256, 256, 3) uint8 images made from a seed
with numpy alone (the load generator's process imports no torch), as smooth
random patterns (a few plane waves a channel) with grain, so the model sees
image-like inputs. The same seed gives the same pool in every process."""

from __future__ import annotations

import numpy as np


def pool(seed: int, count: int, size: int) -> np.ndarray:
    """(count, size, size, 3) uint8 tiles."""
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.empty((count, size, size, 3), np.uint8)
    for i in range(count):
        img = np.zeros((size, size, 3), np.float32)
        for c in range(3):
            base = rng.uniform(0.2, 0.8)
            acc = np.full((size, size), base, np.float32)
            for _ in range(4):
                f = rng.uniform(1.0, 24.0)
                th = rng.uniform(0.0, np.pi)
                ph = rng.uniform(0.0, 2 * np.pi)
                acc += rng.uniform(0.03, 0.15) * np.sin(
                    2 * np.pi * f * (xx * np.cos(th) + yy * np.sin(th)) + ph)
            img[..., c] = acc
        img += rng.normal(0.0, 0.02, img.shape).astype(np.float32)
        out[i] = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return out
