"""The port's segmentation data path against the JAX reference.

Host side (decode, resize, pairing, the batch stream): the same files go
through ``adunet`` and ``adunet_torch`` and must give byte-identical arrays
and the same pairs, orders and errors. Device side (augmentation):
jax.random's stream cannot be reproduced in torch, so the port's apply is
fed the draws the reference makes from a key (the reference's own key
splits, replayed here) and must equal ``augment_pair_batch`` /
``flip_pair_batch``; the image within 1e-6 (float32 bilinear weights; the
sample coordinates are the same float32 expressions), the mask exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.data import augment as jaug
from adunet.data import discovery as jdisc
from adunet.data import io as jio
from adunet.data import seg_pipeline as jpipe
from adunet_torch.data import augment as taug
from adunet_torch.data import discovery as tdisc
from adunet_torch.data import io as tio
from adunet_torch.data import seg_pipeline as tpipe

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """ISIC-style pairs in three formats, masks beside images, plus the
    files a real ISIC folder also holds (superpixel sidecars, stray text)."""
    root = tmp_path_factory.mktemp("isic")
    img_dir, mask_dir = root / "img", root / "mask"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.default_rng(5)
    for i in range(11):
        h, w = 30 + 3 * i, 41 - i
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4 : 3 * h // 4, w // 3 :] = 255
        labels = rng.integers(0, 5, (h, w)).astype(np.uint8)
        name = f"ISIC_{i:07d}"
        if i % 3 == 0:
            cv2.imwrite(str(img_dir / f"{name}.png"), img[..., ::-1])
        elif i % 3 == 1:
            cv2.imwrite(str(img_dir / f"{name}.jpg"), img[..., ::-1])
        else:
            np.save(img_dir / f"{name}.npy", img.astype(np.float32) / 255.0)
        if i % 2:
            cv2.imwrite(str(mask_dir / f"{name}_segmentation.png"), mask)
        else:
            np.save(mask_dir / f"{name}_segmentation.npy", (labels if i == 4 else mask))
        cv2.imwrite(str(img_dir / f"{name}_superpixels.png"), img)
    (img_dir / "notes.txt").write_text("not an image")
    return img_dir, mask_dir


@pytest.mark.parametrize("interp", ["area", "linear"])
def test_load_rgb_image_is_byte_identical(corpus, interp):
    paths = sorted(p for p in corpus[0].iterdir() if p.suffix != ".txt")
    for path in paths:
        want = jio.load_rgb_image(path, 24, interp=interp)
        got = tio.load_rgb_image(path, 24, interp=interp)
        assert got.dtype == want.dtype == np.float32 and got.shape == (24, 24, 3)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown interp"):
        tio.load_rgb_image(paths[0], 24, interp="cubic")


def test_masks_are_byte_identical(corpus):
    for path in sorted(corpus[1].iterdir()):
        for size in (16, 37):
            np.testing.assert_array_equal(tio.load_mask(path, size), jio.load_mask(path, size))
            np.testing.assert_array_equal(tio.load_label_mask(path, size, 3),
                                          jio.load_label_mask(path, size, 3))
    labels = np.random.default_rng(1).integers(0, 7, (9, 13)).astype(np.int64)
    np.testing.assert_array_equal(tio._nearest_resize(labels, 11), jio._nearest_resize(labels, 11))


def test_collect_isic_pairs_matches_reference(corpus, tmp_path):
    img_dir, mask_dir = corpus
    assert tdisc.collect_isic_pairs(img_dir, mask_dir) == jdisc.collect_isic_pairs(img_dir, mask_dir)
    assert len(tdisc.collect_isic_pairs(img_dir, mask_dir)) == 11
    assert tdisc.normalise_isic_key(mask_dir / "ISIC_01_Segmentation.png") == "isic_01"
    # an image without its mask aborts, naming it
    lonely = tmp_path / "img"
    lonely.mkdir()
    np.save(lonely / "ISIC_9999999.npy", np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="ISIC_9999999"):
        tdisc.collect_isic_pairs(lonely, mask_dir)
    with pytest.raises(FileNotFoundError):
        tdisc.collect_isic_pairs(tmp_path / "absent", mask_dir)


def test_discover_pairs_matches_reference(corpus, tmp_path):
    # Cityscapes-style names, nested, in an order natural sort must fix
    (tmp_path / "i" / "x").mkdir(parents=True)
    (tmp_path / "m").mkdir()
    for i in (10, 2, 1):
        np.save(tmp_path / "i" / "x" / f"c{i}_leftImg8bit.npy", np.zeros((2, 2, 3)))
        np.save(tmp_path / "m" / f"c{i}_gtFine_labelIds.npy", np.zeros((2, 2)))
    args = (tmp_path / "i", tmp_path / "m", ".npy", "_labelIds.npy")
    got = tdisc.discover_pairs(*args)
    assert got == jdisc.discover_pairs(*args) and len(got) == 3 and "c1_" in got[0][0]
    assert tdisc.discover_pairs(*args, limit=2) == jdisc.discover_pairs(*args, limit=2)
    img_dir, mask_dir = corpus  # superpixel sidecars and unmatched images raise
    for suffixes in ((".npy", "_segmentation.npy"), (".png", "_segmentation.png")):
        try:
            want = jdisc.discover_pairs(img_dir, mask_dir, *suffixes, limit=3)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc).split(" (")[0]):
                tdisc.discover_pairs(img_dir, mask_dir, *suffixes, limit=3)
            continue
        assert tdisc.discover_pairs(img_dir, mask_dir, *suffixes, limit=3) == want
    for name in ("a_leftImg8bit.png", "a_gtFine_labelIds.png", "b_mask.jpg"):
        assert tdisc.canonical_key(img_dir / name) == jdisc.canonical_key(img_dir / name)


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True),
    dict(shuffle=True, pad_tail=True, cache_decoded=True),
    dict(shuffle=False, drop_remainder=True, image_interp="linear"),
    dict(shuffle=True, num_classes=3),
])
def test_pipeline_batches_are_byte_identical(corpus, kwargs):
    pairs = jdisc.collect_isic_pairs(*corpus)
    args = dict(batch_size=4, image_size=20, augment=False, seed=7, **kwargs)
    jds, tds = jpipe.SegPairDataset(pairs, **args), tpipe.SegPairDataset(pairs, **args)
    assert tds.steps_per_epoch == jds.steps_per_epoch
    for _ in range(2):  # two passes: the shuffle reseeds per epoch
        want, got = list(jds), list(tds)
        assert len(got) == len(want)
        for (ti, tm), (wi, wm) in zip(got, want):
            np.testing.assert_array_equal(ti, wi)
            np.testing.assert_array_equal(tm, wm)


def test_build_isic_dataset_matches_reference(corpus):
    jds, jn = jpipe.build_isic_dataset(*corpus, batch_size=3, image_size=16, augment=True,
                                       shuffle=True, seed=2, limit=8)
    tds, tn = tpipe.build_isic_dataset(*corpus, batch_size=3, image_size=16, augment=True,
                                       shuffle=True, seed=2, limit=8)
    assert tn == jn == 8 and tds.global_pairs == jds.global_pairs
    for (ti, tm), (wi, wm) in zip(tds, jds):
        np.testing.assert_array_equal(ti, wi)
        np.testing.assert_array_equal(tm, wm)
    # in one process, a process shard is the whole pair list, as the reference's
    jds, jn = jpipe.build_isic_dataset(*corpus, batch_size=3, image_size=16, augment=False,
                                       shuffle=False, seed=2, shard_across_processes=True)
    tds, tn = tpipe.build_isic_dataset(*corpus, batch_size=3, image_size=16, augment=False,
                                       shuffle=False, seed=2, shard_across_processes=True)
    assert tn == jn and tds.pairs == jds.pairs and tds.global_pairs == jds.global_pairs


def _jax_draws(key, n, size, min_scale=1.0, max_scale=1.15):
    """The draws ``adunet.data.augment.augment_pair_batch`` makes from ``key``,
    by the reference's own splits (:88-99, :59-64, :116)."""
    out = {k: [] for k in ("k", "flip_lr", "flip_ud", "scaled", "oy", "ox")}
    for sample_key in jax.random.split(key, n):
        k_rot, k_lr, k_ud, k_crop = jax.random.split(sample_key, 4)
        out["k"].append(int(jax.random.randint(k_rot, (), 0, 4)))
        out["flip_lr"].append(bool(jax.random.uniform(k_lr, ()) > 0.5))
        out["flip_ud"].append(bool(jax.random.uniform(k_ud, ()) > 0.5))
        k_scale, k_oy, k_ox = jax.random.split(k_crop, 3)
        u = jax.random.uniform(k_scale, (), minval=min_scale, maxval=max_scale)
        scaled = int(jnp.round(u * size).astype(jnp.int32))
        out["scaled"].append(scaled)
        out["oy"].append(int(jax.random.randint(k_oy, (), 0, scaled - size + 1)))
        out["ox"].append(int(jax.random.randint(k_ox, (), 0, scaled - size + 1)))
    return {k: torch.tensor(v) for k, v in out.items()}


def _pair_batch(n, size, seed):
    rng = np.random.default_rng(seed)
    images = rng.random((n, size, size, 3), dtype=np.float32)
    masks = np.zeros((n, size, size, 1), np.float32)
    for i in range(n):  # an asymmetric blob, so every rotation and flip shows
        masks[i, 2 + i % 3 : size // 2 + i, 1 : size - 5 - i % 4] = 1.0
    return images, masks


def test_augment_apply_matches_jax_given_its_draws():
    n, size = 12, 32
    images, masks = _pair_batch(n, size, seed=3)
    seen = {"k": set(), "crop": 0}
    for seed in range(3):
        key = jax.random.key(100 + seed)
        want_i, want_m = jaug.augment_pair_batch(jnp.asarray(images), jnp.asarray(masks), key)
        draws = _jax_draws(key, n, size)
        got_i, got_m = taug.apply_augment(torch.from_numpy(images), torch.from_numpy(masks), **draws)
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-6)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        seen["k"] |= set(draws["k"].tolist())
        seen["crop"] += int((draws["scaled"] > size).sum())
    assert seen["k"] == {0, 1, 2, 3} and seen["crop"] > 10


def test_flip_apply_matches_jax_given_its_draws():
    n, size = 8, 16
    images, masks = _pair_batch(n, size, seed=4)
    key = jax.random.key(9)
    want_i, want_m = jaug.flip_pair_batch(jnp.asarray(images), jnp.asarray(masks), key)
    lr, ud = [], []
    for sample_key in jax.random.split(key, n):
        k_lr, k_ud = jax.random.split(sample_key)
        lr.append(bool(jax.random.uniform(k_lr, ()) > 0.5))
        ud.append(bool(jax.random.uniform(k_ud, ()) > 0.5))
    got_i, got_m = taug.apply_flips(torch.from_numpy(images), torch.from_numpy(masks),
                                    torch.tensor(lr), torch.tensor(ud))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert 0 < sum(lr) < n and 0 < sum(ud) < n


def test_draws_are_in_range_and_seeded():
    size = 256
    a = taug.draw_augment(4096, size, torch.Generator().manual_seed(0))
    b = taug.draw_augment(4096, size, torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a["k"].tolist()) == {0, 1, 2, 3}
    assert int(a["scaled"].min()) == size and int(a["scaled"].max()) <= round(1.15 * size)
    assert bool((a["oy"] >= 0).all()) and bool((a["oy"] <= a["scaled"] - size).all())
    assert bool((a["ox"] <= a["scaled"] - size).all()) and int(a["ox"].max()) > 0
    assert 0.45 < float(a["flip_lr"].float().mean()) < 0.55
    images, masks = _pair_batch(4, 32, seed=1)
    img, msk = taug.augment_pair_batch(torch.from_numpy(images), torch.from_numpy(masks),
                                       torch.Generator().manual_seed(3))
    assert img.shape == (4, 32, 32, 3) and set(torch.unique(msk).tolist()) <= {0.0, 1.0}
