"""The compiled train step (``adunet_torch.train.compiled``) on the card.

For each step builder, 6 steps captured in a CUDA graph (``graph=True``: 2
eager, the capture and its replay, 3 replays) equal 6 eager steps
(``graph=False``) from the same state and batches, bit for bit, in the
parameters, Adam's moments and update counts, the BatchNorm buffers and
the metrics, with the kernels' launches a step unchanged; both sides under
``deterministic_cudnn()``, so cuDNN picks one algorithm for a shape. Also:
``grad_accum=2``, a plateau rescale of the rate mid-run, a checkpoint
restore mid-run (the step captures anew), a ragged last batch (a graph of
its own), a checkpoint written by a non-capturable Adam (float rate, update
counts on the host), the generators' states after the device-cache and
augmented steps, and the memory a dropped step leaves reserved. Small
models at 128 px, where K2's gate fires at level 0; the vanilla SR step
with the combined loss (the seeded VGG19 tower) and a 3-class joint step
with the weighted CE (constants placed on the card before the capture).

Every test needs a CUDA GPU and skips without one:

    python -m pytest tests_gpu -q
"""

import json

import numpy as np
import pytest
import torch

from adunet_torch.kernels import launch_counts
from adunet_torch.losses import (binary_crossentropy, build_losses_and_metrics, charbonnier_loss,
                                 make_bce_dice_loss, make_hybrid_ce_dice_loss,
                                 make_perceptual_fn, make_weighted_ce_loss)
from adunet_torch.metrics import binary_accuracy, pooled_global_dice, pooled_precision
from adunet_torch.models import (build_adaptive_depth_unet, build_joint_unet,
                                 build_super_resolution_unet, build_unet, build_vanilla_sr_unet)
from adunet_torch.train import (CheckpointManager, create_train_state, make_joint_train_step,
                                make_optimizer, make_seg_train_step,
                                make_sr_device_cache_train_step, make_sr_train_step,
                                make_vanilla_sr_train_step)
from adunet_torch.train.loop import _scale_lr
from adunet_torch.utils import deterministic_cudnn

pytestmark = pytest.mark.gpu

SIZE, BATCH, STEPS = 128, 2, 6
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with deterministic_cudnn():
        yield


def _perturbed(model):
    with torch.no_grad():  # break the SR heads' identity start
        gen = torch.Generator("cuda").manual_seed(4)
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    return model


def _images(n, seed, u8=False, size=SIZE):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, size // 8, size // 8, 3), dtype=np.float32)
    x = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    return (x * 255).round().astype(np.uint8) if u8 else x


def _pairs(n, seed, classes=1):
    images = _images(n, seed)
    if classes == 1:
        masks = (images.mean(-1, keepdims=True) > 0.5).astype(np.float32)
    else:  # one-hot
        masks = np.eye(classes, dtype=np.float32)[(images.mean(-1) * classes * 0.999).astype(int)]
    return torch.from_numpy(images).cuda(), torch.from_numpy(masks).cuda()


def _combined_loss():
    """The vanilla SR trainer's loss: MSE, SSIM and VGG19 features (seeded)."""
    perceptual = make_perceptual_fn(None, SIZE, dtype=BF16, device="cuda")
    return build_losses_and_metrics("combined", perceptual_fn=perceptual)[0]


def _sr_model():
    return _perturbed(build_super_resolution_unet(0.5, depth_override=1, dtype=BF16,
                                                  device="cuda", seed=0)[0])


_CORPUS = {}


def _corpus():
    if "u8" not in _CORPUS:
        _CORPUS["u8"] = torch.from_numpy(_images(3, 7, u8=True, size=SIZE + 32)).cuda()
    return _CORPUS["u8"]


# name -> (model, builder(model, graph), batch(i))
CASES = {
    "sr": (_sr_model, lambda m, g: make_sr_train_step(m, charbonnier_loss, graph=g),
           lambda i: _images(BATCH, i % 2, u8=True)),  # host uint8 batches
    "sr_device_cache": (
        _sr_model,
        lambda m, g: make_sr_device_cache_train_step(m, charbonnier_loss, _corpus(), SIZE, BATCH,
                                                     graph=g),
        lambda i: None),
    "vanilla_sr": (
        lambda: build_vanilla_sr_unet(64, 2, dtype=BF16, device="cuda", seed=0),
        lambda m, g: make_vanilla_sr_train_step(m, _combined_loss(), graph=g),
        lambda i: (_pairs(BATCH, i % 2)[0] * 0.5, _pairs(BATCH, i % 2)[0])),
    "seg_protocol": (
        lambda: build_adaptive_depth_unet(SIZE, 64, 2, dtype=BF16, device="cuda", seed=0),
        lambda m, g: make_seg_train_step(m, make_hybrid_ce_dice_loss(0.4, 0.6), augment="full",
                                         graph=g),
        lambda i: _pairs(BATCH, i % 2)),
    "seg_vanilla": (
        lambda: build_unet(SIZE, base_channels=16, depth=2, dtype=BF16, device="cuda", seed=0),
        lambda m, g: make_seg_train_step(
            m, binary_crossentropy, augment="flips", graph=g,
            extra_metrics={"accuracy": binary_accuracy, "precision": pooled_precision(),
                           "dice_coefficient": pooled_global_dice()}),
        lambda i: _pairs(BATCH, i % 2)),
    "joint": (
        lambda: _perturbed(build_joint_unet(0.5, depth_override=2, input_size=SIZE, dtype=BF16,
                                            device="cuda", seed=0)[0]),
        lambda m, g: make_joint_train_step(m, charbonnier_loss, make_bce_dice_loss(0.5, 1.0),
                                           graph=g),
        lambda i: _pairs(BATCH, i % 2)),
    "joint_multiclass": (
        lambda: _perturbed(build_joint_unet(0.5, num_classes=3, depth_override=2,
                                            input_size=SIZE, dtype=BF16, device="cuda",
                                            seed=0)[0]),
        lambda m, g: make_joint_train_step(m, charbonnier_loss,
                                           make_weighted_ce_loss([1.0, 2.0, 0.5]), graph=g),
        lambda i: _pairs(BATCH, i % 2, classes=3)),
}


def _run(case, graph, steps=STEPS, batch=None, between=None, lr_kwargs=None, grad_accum=None):
    """``steps`` steps of ``case`` from its seeded model; returns the state,
    the step, the metrics of every step, the launches counted and the
    generator."""
    build_model, build_step, batch_of = CASES[case]
    model = build_model()
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-3,
                                                     **(lr_kwargs or {})))
    if grad_accum is None:
        step = build_step(model, graph)
    else:
        step = make_sr_train_step(model, charbonnier_loss, grad_accum=grad_accum, graph=graph)
    gen = torch.Generator("cuda").manual_seed(0)
    before = launch_counts()
    metrics = []
    for i in range(steps):
        state, m = step(state, (batch or batch_of)(i), gen)
        metrics.append(m)
        if between is not None:
            between(i, state)
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(launch_counts(), before))
    return state, step, metrics, launches, gen


def _tensors(state):
    out = {f"param {n}": p for n, p in state.model.named_parameters()}
    out.update({f"buffer {n}": b for n, b in state.model.named_buffers()})
    names = {p: n for n, p in state.model.named_parameters()}
    for p, slots in state.optimizer.state.items():
        out.update({f"{k} {names[p]}": v for k, v in slots.items()})
    return out


def _assert_equal(eager, compiled):
    e_state, _, e_metrics, e_launches, _ = eager
    c_state, _, c_metrics, c_launches, _ = compiled
    assert c_state.step == e_state.step
    assert c_launches == e_launches  # launches a step unchanged
    for i, (em, cm) in enumerate(zip(e_metrics, c_metrics)):
        assert set(em) == set(cm)
        differ = [k for k in em if not torch.equal(em[k], cm[k])]
        assert not differ, f"step {i} metrics {differ}"
    want, got = _tensors(e_state), _tensors(c_state)
    assert set(want) == set(got)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    assert not differ, differ


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_steps_equal_eager_steps(cuda, case):
    compiled = _run(case, True)
    assert compiled[1].captures_made == 1
    eager = _run(case, False)
    _assert_equal(eager, compiled)
    # the metrics outlived the replays: no two steps' tensors share storage
    ptrs = [v.data_ptr() for m in compiled[2] for v in m.values()]
    assert len(set(ptrs)) == len(ptrs)
    if case in ("sr_device_cache", "seg_protocol", "seg_vanilla"):  # the draws were eager's
        assert torch.equal(torch.rand(4, generator=eager[4], device="cuda"),
                           torch.rand(4, generator=compiled[4], device="cuda"))


def test_grad_accum(cuda):
    _assert_equal(_run("sr", False, grad_accum=2), _run("sr", True, grad_accum=2))


def test_plateau_rescale_mid_run(cuda):
    def rescale(i, state):
        if i == 3:
            state.optimizer.inject_lr = True
            _scale_lr(state, 0.5, 1e-6)

    compiled = _run("joint", True, between=rescale)
    assert compiled[1].captures_made == 1  # the rate is written in place
    _assert_equal(_run("joint", False, between=rescale), compiled)


def test_cosine_schedule(cuda):
    kw = dict(lr_kwargs=dict(cosine_decay_steps=4, cosine_alpha=0.1))
    _assert_equal(_run("seg_protocol", False, **kw), _run("seg_protocol", True, **kw))


def test_restore_mid_run_captures_anew(cuda, tmp_path):
    def save_and_restore(side):
        def between(i, state):
            if i == 3:
                ckpt = CheckpointManager(tmp_path / side)
                ckpt.save(state.step, state)
                ckpt.restore_latest(state)  # replaces Adam's state tensors
        return between

    compiled = _run("joint", True, steps=8, between=save_and_restore("c"))
    # captured at the 3rd call; after the restore 2 eager calls, captured at the 7th
    assert compiled[1].captures_made == 2
    _assert_equal(_run("joint", False, steps=8, between=save_and_restore("e")), compiled)


def test_ragged_last_batch_gets_its_own_graph(cuda):
    sizes = [BATCH, BATCH, BATCH, 1] * 3

    def batch(i):
        return _pairs(sizes[i], i % 2)

    compiled = _run("joint", True, steps=len(sizes), batch=batch)
    assert compiled[1].captures_made == 2  # full batches at call 3, the ragged one at its 3rd
    _assert_equal(_run("joint", False, steps=len(sizes), batch=batch), compiled)


def test_checkpoint_of_a_non_capturable_adam_loads(cuda, tmp_path):
    """A checkpoint as the parent wrote it: a float rate, ``capturable``
    False and the update counts on the host."""
    model = CASES["joint"][0]()
    old = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-7)
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    old.step()
    optimizer = old.state_dict()
    assert not optimizer["param_groups"][0]["capturable"]
    assert optimizer["state"][0]["step"].device.type == "cpu"
    (tmp_path / "1").mkdir()
    torch.save({"step": 1, "model": model.state_dict(), "optimizer": optimizer},
               tmp_path / "1" / "state.pt")
    (tmp_path / "1" / "metrics.json").write_text(json.dumps({}))

    def restore(i, state):
        if i == 0:
            rate = state.optimizer.param_groups[0]["lr"]
            CheckpointManager(tmp_path).restore_latest(state)
            group = state.optimizer.param_groups[0]
            assert group["capturable"] and group["lr"] is rate
            assert float(rate) == float(np.float32(1e-3))
            assert all(s["step"].is_cuda for s in state.optimizer.state.values())

    compiled = _run("joint", True, between=restore)
    _assert_equal(_run("joint", False, between=restore), compiled)
    assert compiled[0].step == STEPS  # the checkpoint's count (1) came back at step 0


def test_a_dropped_step_leaves_no_memory_reserved(cuda):
    """Nothing a capture allocates outlives its graph: once the step, its
    state and its model are dropped, no new segment of a graph's pool is
    left, and every block still live on the warm-up and capture stream (its
    cuBLAS workspaces, held for the process's life) fills a segment of its
    own: carved from a step's freed activations, it would keep the whole
    segment reserved."""
    import gc

    from adunet_torch.train.compiled import _side_stream

    def graph_segments():
        return {s["address"] for s in torch.cuda.memory_snapshot()
                if tuple(s["segment_pool_id"]) != (0, 0)}

    gc.collect()
    torch.cuda.empty_cache()
    before = graph_segments()
    result = _run("joint", True)
    assert result[1].captures_made == 1
    del result
    gc.collect()
    torch.cuda.empty_cache()
    assert graph_segments() <= before
    side = _side_stream(torch.device("cuda", torch.cuda.current_device())).cuda_stream
    for s in torch.cuda.memory_snapshot():
        if s["stream"] == side and s["allocated_size"]:
            assert s["total_size"] - s["allocated_size"] < 2 * 2**20, s["total_size"]
