"""The port's segmentation losses and metrics against the JAX reference.

Each loss and metric runs on the same numpy inputs through ``adunet`` and
``adunet_torch``: random probabilities, empty masks, and perfect
predictions (where the clip and the smooth terms decide the value).
Tolerance rtol 1e-5 / atol 1e-6: float32 sums over up to 2 x 32 x 32 x 3
elements in another order. The pooled metrics' component sums over several
batches, finalized, must equal the metric computed on the whole set at once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adunet import losses as jl
from adunet import metrics as jm
from adunet_torch import losses as tl
from adunet_torch import metrics as tm


def _cases(c=1):
    rng = np.random.default_rng(0)
    shape = (2, 32, 32, c)
    if c == 1:
        masks = (rng.random(shape) > 0.6).astype(np.float32)
        probs = rng.random(shape, dtype=np.float32)
    else:
        masks = np.eye(c, dtype=np.float32)[rng.integers(0, c, shape[:-1])]
        logits = rng.normal(size=shape).astype(np.float32)
        probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    empty = np.zeros(shape, np.float32)
    return {
        "random": (masks, probs),
        "empty_mask": (empty, probs),
        "perfect": (masks, masks.copy()),
        "empty_both": (empty, empty.copy()),
    }


_BINARY = {
    "binary_crossentropy": (jl.binary_crossentropy, tl.binary_crossentropy),
    "dice_loss": (jl.dice_loss, tl.dice_loss),
    "hybrid_a": (jl.make_hybrid_ce_dice_loss(0.4, 0.6), tl.make_hybrid_ce_dice_loss(0.4, 0.6)),
    "bce_dice_b": (jl.make_bce_dice_loss(0.5, 1.0), tl.make_bce_dice_loss(0.5, 1.0)),
    "dice_coefficient": (jm.dice_coefficient, tm.dice_coefficient),
    "iou_score": (jm.iou_score, tm.iou_score),
    "global_dice_coefficient": (jm.global_dice_coefficient, tm.global_dice_coefficient),
    "binary_accuracy": (jm.binary_accuracy, tm.binary_accuracy),
    "precision": (jm.precision, tm.precision),
    "recall": (jm.recall, tm.recall),
}
_MULTICLASS = {
    "categorical_crossentropy": (jl.categorical_crossentropy, tl.categorical_crossentropy),
    "weighted_ce": (jl.make_weighted_ce_loss([0.5, 2.0, 1.0]),
                    tl.make_weighted_ce_loss([0.5, 2.0, 1.0])),
    "mean_iou": (lambda t, p: jm.mean_iou(t, p, num_classes=3),
                 lambda t, p: tm.mean_iou(t, p, num_classes=3)),
}


@pytest.mark.parametrize("case", ["random", "empty_mask", "perfect", "empty_both"])
@pytest.mark.parametrize("name", sorted(_BINARY))
def test_binary_losses_and_metrics_match_jax(name, case):
    jfn, tfn = _BINARY[name]
    t, p = _cases()[case]
    want = float(jfn(jnp.asarray(t), jnp.asarray(p)))
    got = tfn(torch.from_numpy(t), torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["random", "empty_mask", "perfect"])
@pytest.mark.parametrize("name", sorted(_MULTICLASS))
def test_multiclass_losses_and_metrics_match_jax(name, case):
    jfn, tfn = _MULTICLASS[name]
    t, p = _cases(3)[case]
    want = float(jfn(jnp.asarray(t), jnp.asarray(p)))
    np.testing.assert_allclose(float(tfn(torch.from_numpy(t), torch.from_numpy(p))), want,
                               rtol=1e-5, atol=1e-6)


def test_perfect_prediction_values():
    t, p = _cases()["perfect"]
    t, p = torch.from_numpy(t), torch.from_numpy(p)
    assert float(tm.binary_accuracy(t, p)) == 1.0
    assert float(tm.precision(t, p)) == 1.0 and float(tm.recall(t, p)) == 1.0
    assert float(tl.dice_loss(t, p)) == pytest.approx(0.0, abs=1e-5)


_POOLED = {
    "global_dice": (jm.pooled_global_dice, tm.pooled_global_dice, ()),
    "precision": (jm.pooled_precision, tm.pooled_precision, ()),
    "recall": (jm.pooled_recall, tm.pooled_recall, ()),
    "mean_iou": (jm.pooled_mean_iou, tm.pooled_mean_iou, (3,)),
}


@pytest.mark.parametrize("name", sorted(_POOLED))
def test_pooled_metrics_match_jax_and_pool_over_the_set(name):
    jmake, tmake, args = _POOLED[name]
    jpm, tpm = jmake(*args), tmake(*args)
    c = args[0] if args else 1
    t, p = _cases(c)["random"]
    t = np.concatenate([t, _cases(c)["perfect"][0]])
    p = np.concatenate([p, _cases(c)["perfect"][1]])
    # batch value and component sums equal the reference's
    for b in range(2):
        tb, pb = t[2 * b : 2 * b + 2], p[2 * b : 2 * b + 2]
        np.testing.assert_allclose(float(tpm.batch_fn(torch.from_numpy(tb), torch.from_numpy(pb))),
                                   float(jpm.batch_fn(jnp.asarray(tb), jnp.asarray(pb))),
                                   rtol=1e-5, atol=1e-6)
        want = jpm.stats(jnp.asarray(tb), jnp.asarray(pb))
        got = tpm.stats(torch.from_numpy(tb), torch.from_numpy(pb))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    # per-sample sums pooled and finalized == the metric over the whole set
    per = [tpm.stats(torch.from_numpy(t[i : i + 1]), torch.from_numpy(p[i : i + 1]))
           for i in range(len(t))]
    pooled = {k: np.sum([q[k].numpy() for q in per], axis=0) for k in per[0]}
    whole = float(tpm.batch_fn(torch.from_numpy(t), torch.from_numpy(p)))
    assert tpm.finalize(pooled) == pytest.approx(whole, rel=1e-5)
    assert tpm.finalize(pooled) == pytest.approx(jpm.finalize(
        {k: np.asarray(v) for k, v in pooled.items()}), rel=1e-12)
