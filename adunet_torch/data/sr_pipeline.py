"""SR patch streams: the random-patch training stream, the grid-tile eval
stream, and the copy of host batches to the card.

Port of ``adunet/data/sr_pipeline.py``:

- ``TrainingPatchDataset`` / ``make_training_patch_dataset`` (:41-183,
  :238-261): an infinite stream of (B, P, P, 3) HR patch batches. The file
  list is reshuffled on every pass, each image gives ``patches_per_image``
  random crops (``random_patches``), a shuffle buffer of ``shuffle_buffer``
  patches is sampled without replacement by swap-pop, and batches are
  float32 in [0, 1] or, with ``output_dtype="uint8"``, uint8 (a quarter of
  the bytes to copy; the step scales them on the device). ``cache_decoded``
  keeps each decoded image in host memory across passes. A window of 4
  decodes runs ahead on a thread pool, and a background thread produces the
  batches into a queue: its errors reach the consumer, and it exits when the
  consumer stops iterating. One seed gives the reference's bytes.
- ``GridPatchDataset`` / ``make_eval_patch_dataset`` (:186-274): a finite
  stream of grid tiles per image at a stride, with ``"<file>#patch0007"``
  labels counted from image headers before any pixel is decoded.
- ``device_feed`` (the port's own): the host-to-device copy. Each host batch
  is copied into its own pinned buffer and from there to the card with
  ``non_blocking=True`` on a side stream, one batch ahead, so the copy of
  batch n + 1 overlaps step n; the consuming stream waits on the copy's
  event before it reads the batch. The LR side is made on the device by the
  train / eval step, and uint8 batches are scaled there too.
"""

from __future__ import annotations

import math
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from adunet_torch.data.io import load_rgb_image_full, load_rgb_image_full_u8, read_image_size
from adunet_torch.data.patches import grid_patch_count, grid_patches, random_patches

__all__ = [
    "TrainingPatchDataset",
    "GridPatchDataset",
    "make_training_patch_dataset",
    "make_eval_patch_dataset",
    "device_feed",
]

_DECODE_WINDOW = 4


class TrainingPatchDataset:
    """Infinite iterator of (B, P, P, 3) HR patch batches. ``scale`` is kept
    as metadata: the train step degrades on the device."""

    def __init__(self, hr_files: Sequence[str], patch_size: int, patches_per_image: int,
                 scale: float, batch_size: int, seed: int, shuffle_buffer: int = 1024,
                 prefetch_batches: int = 4, output_dtype: str = "float32",
                 cache_decoded: bool = False):
        hr_files = list(hr_files)
        if not hr_files:
            raise ValueError("empty hr_files list: need at least one training image.")
        if patches_per_image <= 0:
            raise ValueError("patches_per_image: expected a value >= 1.")
        if patch_size <= 0:
            raise ValueError("patch_size: expected a value >= 1.")
        if output_dtype not in ("float32", "uint8"):
            raise ValueError("output_dtype must be 'float32' or 'uint8'.")
        self.hr_files = hr_files
        self.patch_size = patch_size
        self.patches_per_image = patches_per_image
        self.scale = float(scale)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.prefetch_batches = prefetch_batches
        self.output_dtype = output_dtype
        self.cache_decoded = cache_decoded
        self._decoded_cache: dict = {}
        self.total_patches = len(hr_files) * patches_per_image
        self.steps_per_epoch = math.ceil(self.total_patches / batch_size)

    def _patch_stream(self, rng: np.random.Generator) -> Iterator[np.ndarray]:
        """Patches of every image, pass after pass, decoded by a small thread
        pool a window ahead of the consumer."""
        files = list(self.hr_files)
        decode = load_rgb_image_full_u8 if self.output_dtype == "uint8" else load_rgb_image_full
        if self.cache_decoded:
            cache = self._decoded_cache

            def loader(path: str) -> np.ndarray:
                hit = cache.get(path)
                if hit is None:
                    # two threads may decode one file once each on the first
                    # pass; both store the same pixels
                    hit = cache[path] = decode(path)
                return hit
        else:
            loader = decode

        with ThreadPoolExecutor(max_workers=_DECODE_WINDOW) as pool:
            while True:
                rng.shuffle(files)
                pending = deque()
                idx = 0
                while idx < len(files) or pending:
                    while idx < len(files) and len(pending) < _DECODE_WINDOW:
                        pending.append(pool.submit(loader, files[idx]))
                        idx += 1
                    image = pending.popleft().result()
                    yield from random_patches(image, self.patch_size,
                                              count=self.patches_per_image, rng=rng)

    def _batch_stream(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed)
        stream = self._patch_stream(rng)
        buffer: List[np.ndarray] = []
        while True:
            while len(buffer) < max(self.shuffle_buffer, self.batch_size):
                buffer.append(next(stream))
            batch = []
            for _ in range(self.batch_size):
                idx = int(rng.integers(0, len(buffer)))
                batch.append(buffer[idx])
                buffer[idx] = buffer[-1]
                buffer.pop()
            yield np.stack(batch, axis=0)

    def __iter__(self) -> Iterator[np.ndarray]:
        """Batches from a background producer thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a bounded put, so that the thread sees ``stop`` when the
            # consumer has left with the queue full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for batch in self._batch_stream():
                    if not put_or_stop(batch):
                        return
            except Exception as exc:  # handed to the consumer, which raises it
                put_or_stop(exc)

        thread = threading.Thread(target=producer, daemon=True, name="patch-producer")
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def make_training_patch_dataset(hr_files: Sequence[str], patch_size: int, patches_per_image: int,
                                scale: float, batch_size: int, seed: int,
                                shuffle_buffer: int = 1024, output_dtype: str = "float32",
                                cache_decoded: bool = False) -> Tuple[TrainingPatchDataset, int]:
    """(dataset, patches per epoch) — the reference's signature."""
    ds = TrainingPatchDataset(hr_files, patch_size=patch_size, patches_per_image=patches_per_image,
                              scale=scale, batch_size=batch_size, seed=seed,
                              shuffle_buffer=shuffle_buffer, output_dtype=output_dtype,
                              cache_decoded=cache_decoded)
    return ds, ds.total_patches


class GridPatchDataset:
    """Finite, re-iterable stream of (B, P, P, 3) HR patch batches."""

    def __init__(self, hr_files: Sequence[str], patch_size: int, scale: float,
                 batch_size: int, stride: Optional[int] = None):
        hr_files = list(hr_files)
        if not hr_files:
            raise ValueError("empty hr_files list: need at least one training image.")
        stride = stride or patch_size
        if stride <= 0:
            raise ValueError("stride: expected a value >= 1.")
        self.hr_files = hr_files
        self.patch_size = patch_size
        self.scale = float(scale)
        self.batch_size = batch_size
        self.stride = stride
        self.patch_labels: List[str] = []
        for path in hr_files:
            h, w = read_image_size(path)
            n = grid_patch_count(h, w, patch_size, stride=stride)
            stem = Path(path).name
            self.patch_labels.extend(f"{stem}#patch{i:04d}" for i in range(n))
        self.total_patches = len(self.patch_labels)

    def __iter__(self) -> Iterator[np.ndarray]:
        pending: List[np.ndarray] = []
        for path in self.hr_files:
            image = load_rgb_image_full(path)
            for patch in grid_patches(image, self.patch_size, stride=self.stride):
                pending.append(patch)
                if len(pending) == self.batch_size:
                    yield np.stack(pending, axis=0)
                    pending = []
        if pending:
            yield np.stack(pending, axis=0)


def make_eval_patch_dataset(hr_files: Sequence[str], patch_size: int, scale: float,
                            batch_size: int, *, stride: Optional[int] = None
                            ) -> Tuple[GridPatchDataset, int, List[str]]:
    """(dataset, patch count, patch labels) — the reference's signature."""
    ds = GridPatchDataset(hr_files, patch_size, scale, batch_size, stride)
    return ds, ds.total_patches, ds.patch_labels


def _host_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def device_feed(batches: Iterable, device: str | torch.device) -> Iterator:
    """The batches of ``batches`` (arrays, tensors or tuples of them) on
    ``device``, in order.

    On a CUDA device each batch is copied into a pinned buffer of its own
    and from there to the card with ``non_blocking=True`` on a side stream;
    the copy of the next batch is started before the current one is handed
    out, so it runs while the consumer's step does. The consumer's stream
    waits for a batch's copy event before it uses the batch, and the pinned
    buffer is held until the next batch is handed out, after that wait was
    enqueued. On the CPU the batches pass through unchanged (the steps take
    numpy). Closing the feed closes the iterator behind it, which stops a
    ``TrainingPatchDataset``'s producer thread."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from batches
        return

    copy_stream = torch.cuda.Stream(device)

    def start_copy(batch):
        leaves = batch if isinstance(batch, (tuple, list)) else (batch,)
        pinned = [_host_tensor(b).pin_memory() for b in leaves]
        with torch.cuda.stream(copy_stream):
            moved = [p.to(device, non_blocking=True) for p in pinned]
            done = torch.cuda.Event()
            done.record(copy_stream)
        out = tuple(moved) if isinstance(batch, (tuple, list)) else moved[0]
        return out, moved, pinned, done

    it = iter(batches)
    try:
        ahead = next(it, None)
        ahead = None if ahead is None else start_copy(ahead)
        while ahead is not None:
            out, moved, pinned, done = ahead
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in moved:  # not reused by the allocator before the consumer's work is done
                t.record_stream(consumer)
            following = next(it, None)
            ahead = None if following is None else start_copy(following)
            yield out
            del pinned  # the copy from it was waited for above
    finally:
        close = getattr(it, "close", None)
        if close is not None:  # stops a producer thread behind ``batches``
            close()
