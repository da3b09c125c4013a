"""ISIC segmentation pipeline: host decode and resize, augmentation on the device.

Port of ``adunet/data/seg_pipeline.py`` (``SegPairDataset`` :27-187,
``build_isic_dataset`` :190-230), with the reference's batch contract kept
byte for byte: the per-pass shuffle ``np.random.default_rng(seed + epoch)``,
``drop_remainder``, ``pad_tail`` (wrap-fill of a ragged last batch),
``cache_decoded``, the sliding decode window of 4 threads, the prefetch
thread with its stop event, and ``global_pairs`` for precise-BN. Images are
area- (or linear-) resized float32 in [0, 1], masks binarised (or one-hot)
float32, as numpy arrays; the train step moves them to the device.
"""

from __future__ import annotations

import math
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from adunet_torch.data.discovery import collect_isic_pairs
from adunet_torch.data.io import load_label_mask, load_mask, load_rgb_image

__all__ = ["SegPairDataset", "build_isic_dataset"]


class SegPairDataset:
    """Iterator of (images, masks) float32 batches: (B,S,S,3), (B,S,S,C).

    ``num_classes == 1`` loads binarised masks (B,S,S,1); > 1 loads integer
    label maps one-hot encoded to (B,S,S,C) for the softmax head.
    One pass per ``__iter__`` (finite); shuffled per pass when requested.
    ``augment`` is metadata for the train loop (augmentation runs on the
    device inside the train step, ``adunet_torch.data.augment``).
    """

    def __init__(
        self,
        pairs: Sequence[Tuple[str, str]],
        batch_size: int,
        image_size: int,
        augment: bool,
        shuffle: bool,
        seed: int,
        prefetch_batches: int = 4,
        num_classes: int = 1,
        drop_remainder: bool = False,
        pad_tail: bool = False,
        image_interp: str = "area",
        cache_decoded: bool = False,
    ):
        pairs = list(pairs)
        if not pairs:
            raise ValueError("pairs must be non-empty.")
        self.pairs = pairs
        self.batch_size = batch_size
        self.image_size = image_size
        self.augment = augment
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.num_classes = num_classes
        # "area" = adaptive/protocol trainer parity (cv2 INTER_AREA);
        # "linear" = vanilla trainer parity (tf BILINEAR, unet_vinillia.py:166)
        self.image_interp = image_interp
        # drop_remainder: every batch full (a ragged tail cannot be split
        # evenly over several devices)
        if drop_remainder and len(pairs) < batch_size:
            raise ValueError(
                f"drop_remainder=True but only {len(pairs)} pairs for "
                f"batch_size={batch_size} — not enough samples for one full batch."
            )
        self.drop_remainder = drop_remainder
        # pad_tail: wrap-fill a ragged final batch from the start of the
        # epoch order so every batch is full; a single-device run keeps the
        # ragged tail by default
        self.pad_tail = pad_tail and not drop_remainder
        # cache_decoded: each (image, mask) pair is decoded and resized once,
        # then served from host RAM in every later pass (ISIC train at 256
        # px is ~2 GB decoded); np.stack copies at batching, so the cached
        # arrays are never written
        self.cache_decoded = cache_decoded
        self._decoded_cache: dict = {}
        self._epoch = 0
        if self.drop_remainder:
            self.steps_per_epoch = len(pairs) // batch_size
        else:
            self.steps_per_epoch = math.ceil(len(pairs) / batch_size)

    def __len__(self) -> int:
        return len(self.pairs)

    def _load_pair(self, image_path: str, mask_path: str) -> Tuple[np.ndarray, np.ndarray]:
        if self.cache_decoded:
            hit = self._decoded_cache.get((image_path, mask_path))
            if hit is not None:
                return hit
        image = load_rgb_image(image_path, self.image_size, interp=self.image_interp)
        if self.num_classes > 1:
            pair = image, load_label_mask(mask_path, self.image_size, self.num_classes)
        else:
            pair = image, load_mask(mask_path, self.image_size)
        if self.cache_decoded:
            # racing decode threads may fill the same key once each on the
            # first pass; identical pixels, so no lock needed (GIL-atomic)
            self._decoded_cache[(image_path, mask_path)] = pair
        return pair

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.pairs))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        # decode order for the whole pass, including the wrap-fill tail:
        # a ragged final batch cannot shard over a >1-device data axis
        indices = list(order)
        remainder = len(indices) % self.batch_size
        if remainder:
            if self.drop_remainder:
                indices = indices[: len(indices) - remainder]
            elif self.pad_tail:
                need = self.batch_size - remainder
                indices += [order[k % len(order)] for k in range(need)]

        # sliding-window decode pool (cv2 releases the GIL) — serial decode
        # stalled the device whenever step time was below decode time
        window = 4
        with ThreadPoolExecutor(max_workers=window) as pool:
            pending = deque()
            idx = 0
            images: List[np.ndarray] = []
            masks: List[np.ndarray] = []
            while idx < len(indices) or pending:
                while idx < len(indices) and len(pending) < window:
                    pending.append(pool.submit(self._load_pair, *self.pairs[indices[idx]]))
                    idx += 1
                img, msk = pending.popleft().result()
                images.append(img)
                masks.append(msk)
                if len(images) == self.batch_size:
                    yield np.stack(images), np.stack(masks)
                    images, masks = [], []
            if images:  # ragged tail (single-device reference semantics)
                yield np.stack(images), np.stack(masks)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        done = object()
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # timeout-put: a bare q.put() blocks forever when the consumer
            # abandons a pass with the queue full, leaking the thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for batch in self._batches():
                    if not put_or_stop(batch):
                        return
                put_or_stop(done)
            except Exception as exc:
                put_or_stop(exc)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def build_isic_dataset(
    image_dir,
    mask_dir,
    batch_size: int,
    image_size: int,
    augment: bool,
    shuffle: bool,
    seed: int,
    limit: Optional[int] = None,
    shard_across_processes: bool = False,
    pad_tail: bool = False,
    cache_decoded: bool = False,
) -> Tuple[SegPairDataset, int]:
    """The reference's constructor: ISIC pairs (``collect_isic_pairs``), the
    first ``limit`` of them, as a ``SegPairDataset``; returns it and the pair
    count. ``shard_across_processes=True`` gives each process of a
    multi-process run its equal-length stride-slice of the pairs
    (``adunet_torch.parallel.process_shard``: local batches must differ, and
    equal lengths give equal step counts); the count is then the shard's.
    """
    pairs = collect_isic_pairs(image_dir, mask_dir)
    if limit is not None and limit > 0:
        pairs = pairs[:limit]
    global_pairs = pairs  # the same on every process (sorted discovery)
    if shard_across_processes:
        from adunet_torch.parallel.distributed import process_shard

        pairs = process_shard(pairs, seed=seed)
    ds = SegPairDataset(
        pairs,
        batch_size=batch_size,
        image_size=image_size,
        augment=augment,
        shuffle=shuffle,
        seed=seed,
        pad_tail=pad_tail,
        cache_decoded=cache_decoded,
    )
    # precise-BN's refresh batches select from the whole pair list, the same
    # batches on every process
    ds.global_pairs = global_pairs
    return ds, len(pairs)
