"""Training across processes against one process on the same global batch.

Two ranks join a gloo group on the CPU (``file://`` rendezvous in
``tmp_path``) and run, in one launch: 3 SR Adam steps under DDP, the same
with ``grad_accum=2`` (DDP's reductions counted by a comm hook), 2 steps of
the protocol seg U-Net with BatchNorm on the global batch and with per-rank
statistics, ``fit`` with a ragged validation set, the sharded evaluator,
and 3 SR steps with the wide leaves sharded over 2 model shards
(``--model_shards 2``: data extent 1) with a checkpoint round trip. The
test process runs the same code in one process (``_TASKS`` is executed in
both) on the whole global batch of 8 and compares.

Tolerances (float32, two ranks' gradients averaged against one batch's):

- losses, PSNRs, validation and evaluation numbers: rtol 1e-5; BatchNorm
  running statistics: relative L2 1e-5 per buffer, except the running means
  after the second step, within 1e-5 absolute: the first step's update of a
  conv bias feeding a BatchNorm is noise of up to 2 x lr (see below), which
  shifts the second batch's mean, and the running mean takes 1 % of it;
- gradients after the first step: relative L2 over all of them 1e-4 (the
  output head's gradients sum 8 x 64 x 64 terms with heavy cancellation,
  and two half-batch sums round otherwise: seen 1.4e-5); parameters after
  the Adam steps: relative L2 over all of them 1e-5, and every element
  within 2 x lr x steps. Adam divides by sqrt(v) + eps, so an element whose
  gradient cancels to near 0 turns float32 summation-order noise into an
  update of up to lr; the per-tensor norm of a small tensor can then exceed
  1e-5 (seen: 2.6e-5 on a 32-element bias after 3 steps at lr 1e-4, the
  trainers' default rate, used here) while the whole model holds;
- the seg model's gradients: relative L2 2e-2 per tensor, the BatchNorm
  model's float32 gradient precision (``scripts/torch_seg_grad_precision.py``);
  the biases of convs feeding a BatchNorm (true gradient 0) in absolute
  terms.

One JAX single-device comparison (``adunet.train.make_sr_train_step``, 3
steps on the same init and batches) holds the two ranks to the reference at
the port's multi-step tolerance, rtol 5e-3 / atol 5e-4.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adunet.losses import build_losses_and_metrics as jax_losses
from adunet.models import build_super_resolution_unet as build_jax
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet.train import make_sr_train_step as jax_train_step
from adunet_torch.convert import flax_trees_from_state_dict

REPO = Path(__file__).resolve().parents[1]

_TASKS = r'''
import numpy as np
import torch
from torch.distributed.tensor import DTensor

from adunet_torch.evaluate import evaluate_sr
from adunet_torch.losses import charbonnier_loss, make_bce_dice_loss
from adunet_torch.models import build_adaptive_depth_unet, build_super_resolution_unet
from adunet_torch.nn.blocks import BatchNorm
from adunet_torch.parallel import data_parallel, shard_batch
from adunet_torch.train import (CheckpointManager, create_train_state, fit, make_optimizer,
                                make_seg_train_step, make_sr_train_step, make_sr_val_step)

LR, STEPS, BATCH, SIZE = 1e-4, 3, 8, 64


def hr_batches(k, n, size, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.random((k, n, size // 4, size // 4, 3), dtype=np.float32)
    smooth = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3)
    return np.clip(smooth + 0.05 * rng.normal(size=smooth.shape), 0, 1).astype(np.float32)


def full(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().clone()


def sr_model(init):
    model, _ = build_super_resolution_unet(0.5, base_channels=16, residual_head_channels=16,
                                           depth_override=2, input_size=SIZE, device="cpu")
    model.load_state_dict(init)
    return model


def sr_steps(init, mesh=None, grad_accum=1, min_channels=256, count_reduces=False):
    model = sr_model(init)
    state = create_train_state(model, make_optimizer(model.parameters(), LR))
    if mesh is not None:
        state = data_parallel(state, mesh, min_channels)
    reduces = []
    if count_reduces:
        from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import allreduce_hook

        def hook(pg, bucket):
            reduces.append(1)
            return allreduce_hook(pg, bucket)

        state.parallel.module.register_comm_hook(None, hook)
    step = make_sr_train_step(model, charbonnier_loss, grad_accum=grad_accum)
    out = {"loss": [], "psnr": [], "reduces": []}
    for i, hr in enumerate(hr_batches(STEPS, BATCH, SIZE)):
        state, m = step(state, shard_batch(hr, mesh) if mesh is not None else hr)
        out["loss"].append(float(m["loss"]))
        out["psnr"].append(float(m["psnr"]))
        out["reduces"].append(len(reduces))
        if i == 0:
            out["grads"] = {n: full(p.grad) for n, p in model.named_parameters()}
    out["params"] = {n: full(p) for n, p in model.named_parameters()}
    out["sharded"] = {n: tuple(p.to_local().shape) for n, p in model.named_parameters()
                      if isinstance(p, DTensor)}
    return out, state


def seg_batches(n_steps, n, size, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.random((n_steps, n, size, size, 3), dtype=np.float32)
    yy, xx = np.mgrid[:size, :size]
    masks = np.zeros((n_steps, n, size, size, 1), np.float32)
    for s in range(n_steps):
        for b in range(n):
            cy, cx, r = rng.integers(8, size - 8, 2).tolist() + [int(rng.integers(4, 9))]
            masks[s, b, ..., 0] = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
            images[s, b] += 0.3 * masks[s, b]
    return np.clip(images, 0, 1), masks


def seg_steps(init, mesh=None, global_bn=True):
    model = build_adaptive_depth_unet(input_size=32, base_channels=8, depth=2, device="cpu")
    model.load_state_dict(init)
    state = create_train_state(model, make_optimizer(model.parameters(), LR))
    if mesh is not None:
        state = data_parallel(state, mesh)
        if not global_bn:  # the fault the global statistics prevent
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.sync_group = None
    step = make_seg_train_step(model, make_bce_dice_loss(1.0, 1.0), augment="none")
    out = {"loss": [], "dice": []}
    images, masks = seg_batches(2, BATCH, 32)
    for i in range(2):
        batch = (images[i], masks[i])
        state, m = step(state, shard_batch(batch, mesh) if mesh is not None else batch)
        out["loss"].append(float(m["loss"]))
        out["dice"].append(float(m["dice"]))
        if i == 0:
            out["grads"] = {n: full(p.grad) for n, p in model.named_parameters()}
            out["buffers1"] = {n: full(b) for n, b in model.named_buffers()}
    out["params"] = {n: full(p) for n, p in model.named_parameters()}
    out["buffers"] = {n: full(b) for n, b in model.named_buffers()}
    return out


def fit_run(init, mesh=None):
    """2 epochs of 2 steps on the global batches (each rank its rows), then
    validation over 5 samples in ragged batches of 3 and 2."""
    model = sr_model(init)
    state = create_train_state(model, make_optimizer(model.parameters(), LR))
    if mesh is not None:
        state = data_parallel(state, mesh)
    train = hr_batches(4, BATCH, SIZE, seed=1)
    feed = iter([shard_batch(b, mesh) if mesh is not None else b for b in train])
    val = hr_batches(1, 5, SIZE, seed=2)[0]
    result = fit(state, feed, make_sr_train_step(model, charbonnier_loss), steps_per_epoch=2,
                 epochs=2, val_data=[val[:3], val[3:]],
                 val_step=make_sr_val_step(model, charbonnier_loss, per_sample=True),
                 verbose=0, cache_val_on_device=True)
    return {"train": [h.metrics for h in result.history],
            "val": [h.val_metrics for h in result.history],
            "best_epoch": result.best_epoch,
            "params": {n: full(p) for n, p in model.named_parameters()}}


def eval_run(init, mesh=None):
    """7 patches in batches of 4 and 3: the last batch ragged on 2 ranks."""
    model = sr_model(init)
    state = create_train_state(model, make_optimizer(model.parameters(), LR))
    hr = hr_batches(1, 7, SIZE, seed=4)[0]
    summary, rows = evaluate_sr(state, [hr[:4], hr[4:]], eval_scale=0.5, eval_shave=4, mesh=mesh)
    return {"summary": summary.__dict__, "rows": rows}


def replicated(seed, mesh=None):
    """A model initialised from another seed on each rank, then replicated."""
    from adunet_torch.parallel import replicate

    model = build_adaptive_depth_unet(input_size=32, base_channels=8, depth=2, device="cpu",
                                      seed=seed)
    replicate(model, mesh)
    return {n: full(t) for n, t in model.state_dict().items()}


def shards_run(init, mesh, ckpt_dir):
    """3 steps with the wide leaves sharded, a checkpoint of them, and a
    restore into a fresh sharded state (every rank its own shard)."""
    out, state = sr_steps(init, mesh, min_channels=32)
    ckpt = CheckpointManager(ckpt_dir)
    ckpt.save(STEPS, state, metrics={"val_loss": out["loss"][-1]})
    ckpt.close()
    fresh_model = sr_model({k: torch.zeros_like(v) for k, v in init.items()})
    fresh = create_train_state(fresh_model, make_optimizer(fresh_model.parameters(), LR))
    fresh = data_parallel(fresh, mesh, min_channels=32)
    CheckpointManager(ckpt_dir).restore_latest(fresh)
    out["restored_equal"] = all(torch.equal(full(p), out["params"][n])
                                for n, p in fresh_model.named_parameters())
    moments = [(full(a), full(b)) for p, q in zip(state.model.parameters(), fresh_model.parameters())
               for a, b in zip(state.optimizer.state[p].values(), fresh.optimizer.state[q].values())]
    out["restored_moments_equal"] = all(torch.equal(a, b) for a, b in moments)
    out["restored_step"] = fresh.step
    return out
'''

_WORKER = r'''
import sys
import torch
import torch.distributed as dist

rank, world, rdv, inp, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
ns = {}
exec(open(sys.argv[6]).read(), ns)
from adunet_torch.parallel import make_dp_model_mesh, make_mesh

init = torch.load(inp)
mesh = make_mesh()
res = {}
res["sr"], _ = ns["sr_steps"](init["sr"], mesh)
res["sr_accum2"], _ = ns["sr_steps"](init["sr"], mesh, grad_accum=2, count_reduces=True)
res["sr_accum1"], _ = ns["sr_steps"](init["sr"], mesh, grad_accum=1, count_reduces=True)
res["seg"] = ns["seg_steps"](init["seg"], mesh)
res["seg_local_bn"] = ns["seg_steps"](init["seg"], mesh, global_bn=False)
res["fit"] = ns["fit_run"](init["sr"], mesh)
res["eval"] = ns["eval_run"](init["sr"], mesh)
res["shards"] = ns["shards_run"](init["sr"], make_dp_model_mesh(2), out_dir + "/ckpt")
res["replicated"] = ns["replicated"](seed=rank, mesh=mesh)
torch.save(res, f"{out_dir}/rank{rank}.pt")
dist.destroy_process_group()
'''


def _tasks():
    ns = {}
    exec(_TASKS, ns)
    return ns


def _init_states():
    """The SR model's seeded init perturbed off the identity start (its zero
    head would zero every upstream gradient) and the seg model's init."""
    from adunet_torch.models import build_adaptive_depth_unet, build_super_resolution_unet

    sr, _ = build_super_resolution_unet(0.5, base_channels=16, residual_head_channels=16,
                                        depth_override=2, input_size=64, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in sr.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    seg = build_adaptive_depth_unet(input_size=32, base_channels=8, depth=2, device="cpu",
                                    seed=5)
    return {"sr": sr.state_dict(), "seg": seg.state_dict()}


def run_ranks(tmp_path: Path, worker: str, world: int, args, timeout: float = 300) -> None:
    """Start ``world`` ranks of ``worker`` (rank, world, file:// rendezvous,
    then ``args``); kill them all if one fails or the time runs out."""
    script = tmp_path / "worker.py"
    script.write_text(worker)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="-1",
               OMP_NUM_THREADS="2")
    rdv = tmp_path / "rendezvous"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(rdv),
                               *map(str, args)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results and the one-process references."""
    tmp = tmp_path_factory.mktemp("parallel_steps")
    init = _init_states()
    torch.save(init, tmp / "init.pt")
    (tmp / "tasks.py").write_text(_TASKS)
    run_ranks(tmp, _WORKER, 2, [tmp / "init.pt", tmp, tmp / "tasks.py"])
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ns = _tasks()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: the CPU kernels' summation order
    try:
        one = {
            "sr": ns["sr_steps"](init["sr"])[0],
            "sr_accum2": ns["sr_steps"](init["sr"], grad_accum=2)[0],
            "seg": ns["seg_steps"](init["seg"]),
            "fit": ns["fit_run"](init["sr"]),
            "eval": ns["eval_run"](init["sr"]),
        }
    finally:
        torch.set_num_threads(threads)
    return {"ranks": ranks, "one": one, "init": init, "tmp": tmp}


def _rel_l2(got, want) -> float:
    num = sum(float((got[n] - w).double().square().sum()) for n, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (num / max(den, 1e-300)) ** 0.5


def _max_abs(got, want) -> float:
    return max(float((got[n] - w).abs().max()) for n, w in want.items())


def _assert_steps_match(got, want, steps):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
    assert _rel_l2(got["grads"], want["grads"]) <= 1e-4
    assert _rel_l2(got["params"], want["params"]) <= 1e-5
    assert _max_abs(got["params"], want["params"]) <= 2 * 1e-4 * steps


def test_sr_steps_two_ranks_match_one_process(runs):
    r0, r1 = runs["ranks"]
    assert r0["sr"]["loss"] == r1["sr"]["loss"]  # both ranks see the global batch's loss
    for n, p in r0["sr"]["params"].items():  # DDP keeps the replicas equal
        assert torch.equal(p, r1["sr"]["params"][n]), n
    _assert_steps_match(r0["sr"], runs["one"]["sr"], 3)


def test_sr_steps_two_ranks_match_jax(runs):
    """The two ranks against the reference's single-device Adam steps."""
    ns = _tasks()
    jmodel, _ = build_jax(0.5, base_channels=16, residual_head_channels=16, depth_override=2,
                          input_size=64)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jax_optimizer(1e-4))
    params, _ = flax_trees_from_state_dict(runs["init"]["sr"])
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jloss, _ = jax_losses("charbonnier")
    step = jax_train_step(jmodel, jloss, donate=False)
    losses = []
    for hr in ns["hr_batches"](3, 8, 64):
        jstate, m = step(jstate, jnp.asarray(hr), None)
        losses.append(float(m["loss"]))
    got = runs["ranks"][0]["sr"]
    np.testing.assert_allclose(got["loss"], losses, rtol=5e-3, atol=5e-4)
    want, _ = flax_trees_from_state_dict(got["params"])
    jax.tree_util.tree_map(lambda w, j: np.testing.assert_allclose(w, np.asarray(j), rtol=5e-3,
                                                                   atol=5e-4),
                           want, jax.device_get(jstate.params))


def test_grad_accum_under_no_sync(runs):
    """grad_accum 2 on 2 ranks equals one process's grad_accum 2, and DDP
    reduces once a step (every micro-batch but the last under no_sync)."""
    r0 = runs["ranks"][0]
    _assert_steps_match(r0["sr_accum2"], runs["one"]["sr_accum2"], 3)
    assert r0["sr_accum2"]["reduces"] == r0["sr_accum1"]["reduces"]
    assert r0["sr_accum1"]["reduces"][0] > 0


@pytest.mark.parametrize("rank", [0, 1])
def test_seg_global_batchnorm_matches_one_process(runs, rank):
    got, want = runs["ranks"][rank]["seg"], runs["one"]["seg"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dice"], want["dice"], rtol=1e-5)
    for n, b in want["buffers1"].items():  # running statistics of the global batch
        assert float((got["buffers1"][n] - b).norm() / b.norm()) <= 1e-5, n
    for n, b in want["buffers"].items():
        if "running_var" in n:
            assert float((got["buffers"][n] - b).norm() / b.norm()) <= 1e-5, n
        else:  # step 2's batch mean moved by the pre-BN biases' update noise (below)
            assert float((got["buffers"][n] - b).abs().max()) <= 1e-5, n
    # conv biases feeding a BatchNorm: true gradient 0, so Adam's update is
    # noise of up to lr a step; held in absolute terms
    pre_bn = {n for n in want["params"] if n.endswith(".bias") and ".conv" in n}
    for n, g in want["grads"].items():
        if n in pre_bn:
            assert float((got["grads"][n] - g).abs().max()) <= 1e-5, n
        else:
            assert float((got["grads"][n] - g).norm() / g.norm()) <= 2e-2, n
    rest = {n: p for n, p in want["params"].items() if n not in pre_bn}
    assert _rel_l2(got["params"], rest) <= 1e-5
    assert _max_abs(got["params"], want["params"]) <= 2 * 1e-4 * 2


def test_seg_per_rank_statistics_fail_the_check(runs):
    """BatchNorm on each rank's 4 samples gives other running statistics:
    the check above would catch a BatchNorm that skipped the reduction."""
    got, want = runs["ranks"][0]["seg_local_bn"], runs["one"]["seg"]
    worst = max(float((got["buffers1"][n] - b).norm() / b.norm())
                for n, b in want["buffers1"].items())
    assert worst > 1e-3


def test_fit_sharded_ragged_validation_matches_one_process(runs):
    """Validation batches of 3 and 2 padded to 4 and 2 rows, sharded, the
    padding masked and the sums all-reduced: one process's numbers."""
    got, want = runs["ranks"][0]["fit"], runs["one"]["fit"]
    assert got["best_epoch"] == want["best_epoch"]
    for g, w in zip(got["val"] + got["train"], want["val"] + want["train"]):
        assert g.keys() == w.keys()
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=1e-5)
    assert runs["ranks"][1]["fit"]["val"] == got["val"]


def test_sharded_evaluator_matches_one_process(runs):
    got, want = runs["ranks"][0]["eval"], runs["one"]["eval"]
    assert got["summary"]["samples"] == want["summary"]["samples"] == 7
    assert [r["index"] for r in got["rows"]] == list(range(7))
    for k, v in want["summary"].items():
        np.testing.assert_allclose(got["summary"][k], v, rtol=1e-5, err_msg=k)
    for g, w in zip(got["rows"], want["rows"]):
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=1e-5)
    assert runs["ranks"][1]["eval"]["summary"] == got["summary"]


def test_replicate_broadcasts_rank_zero(runs):
    """Each rank built its model from its own seed; replicate() leaves every
    parameter and buffer rank 0's."""
    want = _tasks()["replicated"](seed=0)
    for r in runs["ranks"]:
        assert r["replicated"].keys() == want.keys()
        for n, v in want.items():
            assert torch.equal(r["replicated"][n], v), n


def test_model_shards_match_data_parallelism(runs):
    """--model_shards 2 (data extent 1): the wide leaves (C >= 32 here) are
    sharded in half, and the steps are one process's on the same batch."""
    got = runs["ranks"][0]["shards"]
    assert got["sharded"]["bottleneck.conv1.weight"] == (32, 64, 3, 3)
    assert got["sharded"]["enc1.norm0.weight"] == (16,)
    assert "enc0.conv0.weight" not in got["sharded"]  # 16 channels: replicated
    assert "residual_rgb.weight" not in got["sharded"]
    _assert_steps_match(got, runs["one"]["sr"], 3)


def test_model_shards_checkpoint_round_trip(runs):
    """The sharded state's checkpoint holds the whole state: every rank
    restores its shard, and one process loads it in today's format."""
    got = runs["ranks"][0]["shards"]
    for r in runs["ranks"]:
        assert r["shards"]["restored_equal"] and r["shards"]["restored_moments_equal"]
        assert r["shards"]["restored_step"] == 3
    from adunet_torch.models import build_super_resolution_unet
    from adunet_torch.train import CheckpointManager, create_train_state, make_optimizer

    model, _ = build_super_resolution_unet(0.5, base_channels=16, residual_head_channels=16,
                                           depth_override=2, input_size=64, device="cpu", seed=9)
    state = create_train_state(model, make_optimizer(model.parameters(), 1e-4))
    CheckpointManager(runs["tmp"] / "ckpt").restore_latest(state)
    assert state.step == 3
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), got["params"][n]), n
    assert all(len(s) == 3 for s in state.optimizer.state.values())  # step, m, v
