"""The data x space mesh: row-sharded SR training against the reference.

The reference shards each image's height over a mesh's ``"space"`` axis and
lets GSPMD insert the halo exchanges (``adunet/parallel/mesh.py:91-97``,
``:156-181``); its test holds the sharded step to the one-device step
(``tests/test_train.py:238-261``). The port writes the exchanges out
(``adunet_torch/parallel/spatial.py``). Here:

- the split rule and the band of every resize matrix on the paths (the test
  config, the flagship, the deep config; 2 and 4 shards);
- the halo conv, the row-sharded resize, K2's plain halo-row mode and the
  whole model, over shards simulated in one process (one thread a shard,
  ``ThreadSpace`` exchanging through a barrier), against the whole-image op;
  K2's plain halo mode against JAX's conv reference path;
- 2 gloo ranks on a (1, 2) mesh and 4 on (2, 2), started with a ``file://``
  rendezvous, each taking one Adam step (lr 1e-4) from the same perturbed
  flax init on a seeded 72-px batch of 4 at scale 0.7, depth 2 (levels of
  72, 51 and 36 rows: 51 splits 25 / 26), against JAX's one-device
  ``make_sr_train_step``: loss rtol 1e-5, params atol 1e-6; the port's own
  one-process step holds to JAX at atol 1e-6 too. The ranks also check the
  mesh guards and that a model the slice does not cover raises.

Tolerances: float64 convs and resizes to 1e-12 / 1e-6 (the resizes compute
in float32); the simulated model's gradients 1e-4 relative L2 per tensor
(float32 sums split over shards; a near-zero tensor's norm drifts).
"""

import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from adunet.kernels import conv64 as jconv
from adunet.losses import build_losses_and_metrics as jax_losses
from adunet.models import build_super_resolution_unet as build_jax
from adunet.train import create_train_state as jax_state
from adunet.train import make_optimizer as jax_optimizer
from adunet.train import make_sr_train_step as jax_train_step
from adunet_torch.convert import state_dict_from_flax
from adunet_torch.kernels import conv64
from adunet_torch.losses import charbonnier_loss
from adunet_torch.models import build_super_resolution_unet
from adunet_torch.ops import degrade, resize, scaled_size
from adunet_torch.parallel.spatial import SpaceShard, _row_plan, attach, height_split
from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step
from adunet_torch.train.sr import sr_loss_and_metrics

REPO = Path(__file__).resolve().parents[1]
SCALE, DEPTH, SIZE, BATCH, LR = 0.7, 2, 72, 4, 1e-4


class _Hub:
    def __init__(self, n: int):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=60)


class ThreadSpace(SpaceShard):
    """A shard of a space group simulated by a thread: ``all_gather`` goes
    through shared slots and a barrier."""

    def __init__(self, hub: _Hub, shards: int, index: int):
        super().__init__(None, shards, index)
        self.hub = hub

    def all_gather(self, t):
        self.hub.slots[self.index] = t.detach().clone()
        self.hub.barrier.wait()
        out = [s.clone() for s in self.hub.slots]
        self.hub.barrier.wait()
        return out


def on_shards(shards: int, fn):
    """``fn(space)`` on every shard at once, one thread each; the results in
    shard order."""
    hub, results, errors = _Hub(shards), [None] * shards, []

    def run(i):
        try:
            results[i] = fn(ThreadSpace(hub, shards, i))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def _levels(size: int, scale: float, depth: int):
    sizes = [size]
    for _ in range(depth):
        sizes.append(scaled_size(sizes[-1], scale))
    return sizes


def _path_resizes(size: int, scale: float, depth: int):
    """Every resize along H of a train step: degrade's two, the encoder's
    shrinks and the decoder's upsizes."""
    down = int(round(size * 0.5))
    out = [(size, down, "area", True), (down, size, "bicubic_cv2", False)]
    sizes = _levels(size, scale, depth)
    out += [(a, b, "bilinear", True) for a, b in zip(sizes, sizes[1:])]
    out += [(b, a, "bilinear", True) for a, b in zip(sizes, sizes[1:])]
    return out


_CONFIGS = [(SIZE, SCALE, DEPTH), (256, 0.5, 3), (256, 0.8, 5)]


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("height", [36, 51, 72, 85, 205, 256])
def test_height_split_covers_every_row_once(height, shards):
    spans = [height_split(height, shards, i) for i in range(shards)]
    assert spans[0][0] == 0 and spans[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [b - a for a, b in spans]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_height_split_refuses_empty_shards():
    with pytest.raises(ValueError):
        height_split(3, 4, 0)
    assert _levels(256, 0.8, 5) == [256, 205, 164, 132, 106, 85]
    assert [height_split(205, 2, i) for i in range(2)] == [(0, 102), (102, 205)]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("config", _CONFIGS)
def test_resize_bands_on_the_path(config, shards):
    """Each shard's band is its output rows' slice of the resize matrix over
    its own input rows and k more on each side; the bands put back together
    are the matrix, and k stays within 2 rows."""
    from adunet_torch.ops.resize import resize_matrix

    for in_h, out_h, method, aa in _path_resizes(*config):
        k, bands = _row_plan(in_h, out_h, method, aa, shards)
        assert k <= 2
        rebuilt = np.zeros((out_h, in_h + 2 * k), np.float32)
        for i, band in enumerate(bands):
            (i0, i1), (o0, o1) = height_split(in_h, shards, i), height_split(out_h, shards, i)
            assert band.shape == (o1 - o0, i1 - i0 + 2 * k)
            rebuilt[o0:o1, i0 : i1 + 2 * k] += band
        np.testing.assert_array_equal(rebuilt[:, k : k + in_h], resize_matrix(in_h, out_h, method, aa))
        assert not rebuilt[:, :k].any() and not rebuilt[:, k + in_h :].any()


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_halo_conv_matches_whole_image(shards):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 51, 20, 8, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn(8, 8, 3, 3, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 51, 20, 8, generator=gen, dtype=torch.float64)
    want = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    (want_dx,) = torch.autograd.grad(want, x, g)

    def shard(space):
        a, b = space.rows(51)
        xl = x.detach()[:, a:b].clone().requires_grad_()
        xp = space.halo(xl, 1)
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, padding=(0, 1)).permute(0, 2, 3, 1)
        (dx,) = torch.autograd.grad(y, xl, g[:, a:b])
        return y.detach(), dx

    got = on_shards(shards, shard)
    torch.testing.assert_close(torch.cat([y for y, _ in got], 1), want.detach(), rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.cat([d for _, d in got], 1), want_dx, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("config", _CONFIGS[:2])
def test_row_resize_matches_whole_image(config, shards):
    gen = torch.Generator().manual_seed(1)
    for in_h, out_h, method, aa in _path_resizes(*config):
        x = torch.randn(2, in_h, 6, 3, generator=gen, dtype=torch.float64, requires_grad=True)
        want = resize(x, (out_h, 6), method, aa)
        g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        (want_dx,) = torch.autograd.grad(want, x, g)

        def shard(space):
            (a, b), (oa, ob) = space.rows(in_h), space.rows(out_h)
            xl = x.detach()[:, a:b].clone().requires_grad_()
            y = resize(xl, (out_h, 6), method, aa, space=space, height=in_h)
            (dx,) = torch.autograd.grad(y, xl, g[:, oa:ob])
            return y.detach(), dx

        got = on_shards(shards, shard)
        torch.testing.assert_close(torch.cat([y for y, _ in got], 1).float(),
                                   want.detach().float(), rtol=0, atol=1e-6)
        torch.testing.assert_close(torch.cat([d for _, d in got], 1).float(), want_dx.float(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("shards", [2, 4])
def test_k2_halo_rows_plain_matches_jax_conv(shards):
    """K2's halo-row mode (its autograd Function, the plain version on the
    CPU) on each shard's rows with its neighbours' rows around them, against
    JAX's conv reference path on the whole image."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 64, 128, 64)).astype(np.float32)
    w_hwio = (0.05 * rng.normal(size=(3, 3, 64, 64))).astype(np.float32)
    b = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    want = np.asarray(jconv._xla_conv(jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b)))
    w = torch.from_numpy(w_hwio).permute(3, 2, 0, 1).contiguous()
    before = conv64.conv3x3_rows.launches

    def shard(space):
        a, b_ = space.rows(64)
        xp = space.halo(torch.from_numpy(x[:, a:b_]), 1)
        return conv64.conv3x3_rows(xp, w, torch.from_numpy(b)).numpy()

    got = np.concatenate(on_shards(shards, shard), axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert conv64.conv3x3_rows.launches == before  # the CPU runs the plain version


def _perturbed(seed: int = 3):
    model, _ = build_super_resolution_unet(SCALE, base_channels=8, residual_head_channels=8,
                                           depth_override=DEPTH, input_size=SIZE, device="cpu",
                                           seed=seed)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model


@pytest.mark.parametrize("shards", [2, 3])
def test_model_on_simulated_shards_matches_one_process(shards):
    """Degrade, forward, loss share and PSNR on each shard's rows, and the
    mean of the shards' gradients (what DDP averages), against the whole
    batch in one process."""
    import copy

    model = _perturbed()
    hr = torch.from_numpy(np.random.default_rng(4).random((2, SIZE, SIZE, 3), dtype=np.float32))
    lr = degrade(hr, 0.5)
    pred = model(lr)
    loss, metrics = sr_loss_and_metrics(charbonnier_loss, hr, pred)
    grads = torch.autograd.grad(loss, list(model.parameters()))

    def shard(space):
        m = copy.deepcopy(model)
        attach(m, space)
        a, b = space.rows(SIZE)
        lr_rows = degrade(hr[:, a:b], 0.5, space=space, height=SIZE)
        p = m(lr_rows, height=SIZE)
        part, met = sr_loss_and_metrics(charbonnier_loss, hr[:, a:b], p, space, SIZE)
        return lr_rows, p.detach(), float(part.detach()), float(met["psnr"]), torch.autograd.grad(
            part, list(m.parameters()))

    got = on_shards(shards, shard)
    torch.testing.assert_close(torch.cat([g[0] for g in got], 1), lr, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat([g[1] for g in got], 1), pred.detach(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.mean([g[2] for g in got]), float(loss), rtol=1e-6)
    np.testing.assert_allclose([g[3] for g in got], float(metrics["psnr"]), rtol=1e-6)
    for i, want in enumerate(grads):
        mean = sum(g[4][i] for g in got) / shards
        assert float((mean - want).norm() / want.norm()) <= 1e-4


def test_forward_on_a_space_mesh_needs_the_height():
    model = _perturbed()
    model.space = SpaceShard(None, 2, 0)
    with pytest.raises(ValueError, match="global height"):
        model(torch.zeros(1, 36, SIZE, 3))


_WORKER = r'''
import sys
import torch
import torch.distributed as dist

rank, world, rdv, inp, out_dir, shards = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4], sys.argv[5], int(sys.argv[6]))
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method="file://" + rdv, rank=rank, world_size=world)
from adunet_torch.losses import charbonnier_loss
from adunet_torch.models import build_adaptive_depth_unet, build_super_resolution_unet
from adunet_torch.parallel import data_parallel, make_dp_spatial_mesh, shard_batch
from adunet_torch.train import create_train_state, make_optimizer, make_sr_train_step

data = torch.load(inp)
res = {"errors": {}}
for name, call in (("indivisible", lambda: make_dp_spatial_mesh(3)),
                   ("too_many", lambda: make_dp_spatial_mesh(shards, n_devices=2 * world))):
    try:
        call()
    except ValueError as e:
        res["errors"][name] = str(e)
mesh = make_dp_spatial_mesh(shards)
model, _ = build_super_resolution_unet(data["scale"], base_channels=8, residual_head_channels=8,
                                       depth_override=data["depth"], input_size=data["size"],
                                       device="cpu")
model.load_state_dict(data["init"])
state = data_parallel(create_train_state(model, make_optimizer(model.parameters(), data["lr"])),
                      mesh)
local = shard_batch(data["hr"], mesh)
_, m = make_sr_train_step(model, charbonnier_loss)(state, local)
res.update(loss=float(m["loss"]), psnr=float(m["psnr"]), local_shape=tuple(local.shape),
           params={n: p.detach().clone() for n, p in model.named_parameters()})
seg = build_adaptive_depth_unet(input_size=32, base_channels=4, depth=1, device="cpu")
try:
    data_parallel(create_train_state(seg, make_optimizer(seg.parameters(), 1e-4)), mesh)
except NotImplementedError as e:
    res["errors"]["seg"] = str(e)
torch.save(res, f"{out_dir}/rank{rank}.pt")
dist.destroy_process_group()
'''


def _run_ranks(tmp: Path, world: int, shards: int, inp: Path, timeout: float = 240):
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="-1", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                               str(tmp / "rendezvous"), str(inp), str(tmp), str(shards)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture
def reference(perturb_params, tmp_path):
    """JAX's one-device step from a perturbed flax init, that init as a
    torch state dict, the batch, and the port's one-process step."""
    jmodel, _ = build_jax(SCALE, base_channels=8, residual_head_channels=8,
                          depth_override=DEPTH, input_size=SIZE)
    jstate = jax_state(jmodel, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), jax_optimizer(LR))
    jstate = jstate.replace(params=perturb_params(jstate.params))
    init = state_dict_from_flax(jax.device_get(jstate.params))
    rng = np.random.default_rng(5)
    coarse = rng.random((BATCH, SIZE // 4, SIZE // 4, 3), dtype=np.float32)
    hr = np.clip(np.repeat(np.repeat(coarse, 4, 1), 4, 2)
                 + 0.05 * rng.normal(size=(BATCH, SIZE, SIZE, 3)), 0, 1).astype(np.float32)
    jloss, _ = jax_losses("charbonnier")
    jstate, jm = jax_train_step(jmodel, jloss, donate=False)(jstate, jnp.asarray(hr), None)
    want = state_dict_from_flax(jax.device_get(jstate.params))

    model, _ = build_super_resolution_unet(SCALE, base_channels=8, residual_head_channels=8,
                                           depth_override=DEPTH, input_size=SIZE, device="cpu")
    model.load_state_dict(init)
    state = create_train_state(model, make_optimizer(model.parameters(), LR))
    _, m = make_sr_train_step(model, charbonnier_loss)(state, hr)
    one = {"loss": float(m["loss"]), "params": dict(model.named_parameters())}
    torch.save({"init": init, "hr": torch.from_numpy(hr), "scale": SCALE, "depth": DEPTH,
                "size": SIZE, "lr": LR}, tmp_path / "in.pt")
    return {"loss": float(jm["loss"]), "params": want, "one": one, "input": tmp_path / "in.pt"}


def _assert_matches(got_loss, got_params, ref):
    np.testing.assert_allclose(got_loss, ref["loss"], rtol=1e-5)
    assert got_params.keys() == ref["params"].keys()
    for n, want in ref["params"].items():
        torch.testing.assert_close(got_params[n].detach(), want, rtol=0, atol=1e-6, msg=n)


def test_one_process_step_matches_jax(reference):
    _assert_matches(reference["one"]["loss"], reference["one"]["params"], reference)


@pytest.mark.parametrize("world, shards", [(2, 2), (4, 2)])
def test_space_sharded_step_matches_jax(reference, tmp_path, world, shards):
    """(1, 2) and (2, 2) meshes: each rank holds its rows of its data shard's
    images (72 rows: 36 / 36; the 51-row level 25 / 26), and one Adam step
    equals JAX's one-device step."""
    ranks = _run_ranks(tmp_path, world, shards, reference["input"])
    data = world // shards
    for r, res in enumerate(ranks):
        rows = height_split(SIZE, shards, r % shards)
        assert res["local_shape"] == (BATCH // data, rows[1] - rows[0], SIZE, 3)
        assert res["loss"] == ranks[0]["loss"] and res["psnr"] == ranks[0]["psnr"]
        _assert_matches(res["loss"], res["params"], reference)
        for n, p in res["params"].items():  # DDP keeps the replicas equal
            assert torch.equal(p, ranks[0]["params"][n]), n
    errors = ranks[0]["errors"]
    assert "not divisible by space shards=3" in errors["indivisible"]
    assert f"only {world} available" in errors["too_many"]
    assert "AdaptiveSegUNet" in errors["seg"] and "BatchNorm" in errors["seg"]
