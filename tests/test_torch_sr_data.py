"""The port's SR host data against the reference on the CPU.

Random crops, the streamed patch stream (float32 and uint8 wire, with and
without ``cache_decoded``), ``pair_lr_files``, ``ArrayDataset`` and
``load_image_stack`` must give the reference's bytes for the same seed and
files (exact equality). ``device_feed`` passes CPU batches through; the
patch producer thread stops when the consumer (or the feed) does and hands
its errors to the consumer.
"""

import threading
import time

import numpy as np
import pytest

from adunet.data import ArrayDataset as JaxArrayDataset
from adunet.data import TrainingPatchDataset as JaxTrainingPatchDataset
from adunet.data import load_image_stack as jax_load_image_stack
from adunet.data import make_array_dataset as jax_make_array_dataset
from adunet.data import pair_lr_files as jax_pair_lr_files
from adunet.data import random_patch as jax_random_patch
from adunet.data import random_patches as jax_random_patches
from adunet_torch.data import (
    ArrayDataset,
    TrainingPatchDataset,
    device_feed,
    find_images,
    load_image_stack,
    make_array_dataset,
    make_training_patch_dataset,
    pair_lr_files,
    random_patch,
    random_patches,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven images of mixed sizes: uint8 and float32 ``.npy``."""
    root = tmp_path_factory.mktemp("sr_corpus")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 56), (48, 48), (33, 70), (64, 40), (36, 36), (50, 61),
                                (32, 32)]):
        img = rng.random((h, w, 3), dtype=np.float32)
        np.save(root / f"img{i}.npy", (img * 255).astype(np.uint8) if i % 2 else img)
    return root


@pytest.mark.parametrize("h, w, p", [(41, 57, 16), (16, 57, 16), (41, 16, 16), (16, 16, 16),
                                     (41, 57, 1)])
def test_random_crops_follow_the_pinned_rng_contract(h, w, p):
    img = np.random.default_rng(3).random((h, w, 3)).astype(np.float32)
    a, b = np.random.default_rng(99), np.random.default_rng(99)
    for _ in range(10):
        np.testing.assert_array_equal(random_patch(img, p, rng=a), jax_random_patch(img, p, rng=b))
    np.testing.assert_array_equal(random_patches(img, p, 7, rng=a),
                                  jax_random_patches(img, p, 7, rng=b))
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)  # the streams stay in step
    with pytest.raises(ValueError):
        random_patches(img, max(h, w) + 1, 1)


@pytest.mark.parametrize("output_dtype, cache_decoded", [("float32", False), ("uint8", False),
                                                         ("uint8", True)])
def test_training_patch_stream_is_the_references_bytes(corpus, output_dtype, cache_decoded):
    files = find_images(corpus, ".npy")
    kwargs = dict(patch_size=32, patches_per_image=2, scale=0.5, batch_size=4, seed=5,
                  shuffle_buffer=6, output_dtype=output_dtype, cache_decoded=cache_decoded)
    ds, total = make_training_patch_dataset(files, **kwargs)
    ref = JaxTrainingPatchDataset(files, **kwargs)
    assert (total, ds.steps_per_epoch) == (ref.total_patches, ref.steps_per_epoch) == (14, 4)
    got_it, want_it = iter(ds), iter(ref)
    for _ in range(9):  # several passes over the 7 files
        got, want = next(got_it), next(want_it)
        assert got.dtype == np.dtype(output_dtype) and got.shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(got, want)
    got_it.close()
    want_it.close()
    if cache_decoded:
        assert len(ds._decoded_cache) == len(files)


def _producers():
    return [t for t in threading.enumerate() if t.name == "patch-producer"]


def _new_producer(before: set) -> threading.Thread:
    """The one producer thread started since ``before`` was taken. Producers
    of earlier tests' iterators may still be winding down, so threads are
    told apart by identity, not counted."""
    (started,) = [t for t in _producers() if t not in before]
    return started


def test_producer_stops_with_the_consumer_and_reports_errors(corpus, tmp_path):
    files = find_images(corpus, ".npy")
    before = set(_producers())
    ds = TrainingPatchDataset(files, patch_size=32, patches_per_image=1, scale=0.5, batch_size=2,
                              seed=0, shuffle_buffer=2, prefetch_batches=1)
    it = iter(ds)
    next(it)
    producer = _new_producer(before)
    time.sleep(0.3)  # the producer fills the queue and blocks on it
    it.close()
    producer.join(timeout=10)
    assert not producer.is_alive()

    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not an array")
    broken = TrainingPatchDataset([str(bad)], patch_size=8, patches_per_image=1, scale=0.5,
                                  batch_size=1, seed=0)
    with pytest.raises(ValueError):
        next(iter(broken))


def test_device_feed_on_the_cpu_passes_batches_through_and_stops_the_producer(corpus):
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 255, (2, 4, 4, 3), dtype=np.uint8) for _ in range(3)]
    pairs = [(b, b.astype(np.float32)) for b in batches]
    assert all(g is b for g, b in zip(device_feed(batches, "cpu"), batches))
    assert all(g is p for g, p in zip(device_feed(pairs, "cpu"), pairs))
    before = set(_producers())
    ds = TrainingPatchDataset(find_images(corpus, ".npy"), patch_size=32, patches_per_image=1,
                              scale=0.5, batch_size=2, seed=0, shuffle_buffer=2)
    feed = device_feed(ds, "cpu")
    assert next(feed).shape == (2, 32, 32, 3)
    producer = _new_producer(before)
    feed.close()
    producer.join(timeout=10)
    assert not producer.is_alive()


def test_pair_lr_files_matches_the_reference(tmp_path):
    hr, lr = tmp_path / "hr", tmp_path / "lr"
    hr.mkdir()
    lr.mkdir()
    for name in ("a.npy", "b.npy", "c10.npy", "c2.npy"):
        np.save(hr / name, np.zeros((4, 4, 3), np.float32))
        np.save(lr / name, np.zeros((4, 4, 3), np.float32))
    hr_paths = find_images(hr, ".npy")
    assert pair_lr_files(hr_paths, lr) == jax_pair_lr_files(hr_paths, lr)
    (lr / "b.npy").unlink()
    with pytest.raises(ValueError, match="Missing 1 LR counterparts"):
        pair_lr_files(hr_paths, lr)
    with pytest.raises(FileNotFoundError):
        pair_lr_files(hr_paths, tmp_path / "nowhere")


@pytest.mark.parametrize("n, batch, shuffle, drop", [(10, 4, True, True), (10, 4, True, False),
                                                     (9, 3, False, False), (5, 2, True, True)])
def test_array_dataset_order_and_remainder_match_the_reference(n, batch, shuffle, drop):
    rng = np.random.default_rng(n)
    a, b = rng.random((n, 3)), rng.random((n, 2, 2))
    ds = ArrayDataset(a, b, batch_size=batch, shuffle=shuffle, seed=7, drop_remainder=drop)
    ref = JaxArrayDataset(a, b, batch_size=batch, shuffle=shuffle, seed=7, drop_remainder=drop)
    assert (len(ds), ds.steps_per_epoch) == (len(ref), ref.steps_per_epoch)
    for _ in range(3):  # each pass reshuffles
        got, want = list(ds), list(ref)
        assert len(got) == len(want) == ds.steps_per_epoch
        for g, w in zip(got, want):
            for ga, wa in zip(g, w):
                np.testing.assert_array_equal(ga, wa)
    with pytest.raises(ValueError, match="not enough for one full batch"):
        ArrayDataset(a[:1], batch_size=2, drop_remainder=True)
    idx = [4, 1, 3]
    got = list(make_array_dataset(a, a * 2, idx, 2, False, 0))
    want = list(jax_make_array_dataset(a, a * 2, idx, 2, False, 0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1], w[1])


def test_load_image_stack_matches_the_reference(corpus):
    got = load_image_stack(corpus, 24, limit=5)
    want = jax_load_image_stack(corpus, 24, limit=5)
    assert got.shape == (5, 24, 24, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
