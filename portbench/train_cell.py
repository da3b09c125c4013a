"""The training driver: one run of a ``train`` traffic mix.

Set-up builds one object, the model's train step (its module's
``train_step``, ``portbench/models/``) with its model and Adam state, from
the seed's weights and data (the model's ``data``), and drives it
through its first ``checked_steps`` steps (the first two eager, the third
captured in a CUDA graph and replayed, the rest replays of that graph, each
drawing its own patches), reading what the check compares:
each step's loss, the first gradient as Adam holds it, the parameters'
change. After ``warm_replays`` more replays the same object runs the
measured window: replays, at most ``in_flight`` steps queued ahead of the
device, until ``seconds`` have passed on the host's clock; the window ends
in a device synchronise. Once the window has closed and the peak memory is
read, the program's state is freed and the reference follows the checked
steps from the same weights and data.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Dict

import torch

from portbench import catalog, check, program
from portbench.lib import inputs, trace as tracing


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().to(torch.float64))) for k, v in tensors.items()}


def reference_readings(cfg: dict, seed: int, data, steps: int, device, quant=None,
                       loss_rows=None) -> dict:
    """The reference's losses, first-gradient norms and change norms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = inputs.weights(cfg, seed, device)
    params = {k: v.clone() for k, v in start.items()}
    out = catalog.model(cfg).reference_follow(
        params, data, inputs.sub_seed(seed, "sampling"), cfg, steps,
        program.DTYPES[cfg["train"]["dtype"]], quant, loss_rows)
    change = _norms({k: out["params"][k] - start[k] for k in start})
    return {"losses": out["losses"], "grad_norms": _norms(out["first_grad"]),
            "change_norms": change}


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The program's train step, driven through the checked steps and the
    warm replays; returns it with the program's readings."""
    train = cfg["train"]
    model = catalog.model(cfg)
    data = model.data(traffic, seed, device)
    start = inputs.weights(cfg, seed, device)
    net = model.build(cfg, start, train["dtype"], device, remat=bool(train.get("remat")))
    state, step = model.train_step(cfg, net, data)
    gen = torch.Generator(device).manual_seed(inputs.sub_seed(seed, "sampling"))
    losses, grad_norms = [], {}
    for i in range(int(traffic["checked_steps"])):
        state, metrics = step(state, None, gen)
        losses.append(metrics["loss"])
        if i == 0:  # a parameter Adam holds no moment for got no update: its reading is 0
            b1 = state.optimizer.param_groups[0]["betas"][0]
            moments = state.optimizer.state
            grad_norms = _norms({n: moments[p]["exp_avg"] / (1.0 - b1) if "exp_avg" in moments.get(p, {})
                                 else torch.zeros(()) for n, p in net.named_parameters()})
    change_norms = _norms({n: p.detach() - start[n] for n, p in net.named_parameters()})
    readings = {"losses": [float(v) for v in losses], "grad_norms": grad_norms,
                "change_norms": change_norms}
    del start
    for _ in range(int(traffic["warm_replays"])):
        state, _ = step(state, None, gen)
    torch.cuda.synchronize(device) if torch.device(device).type == "cuda" else None
    return {"state": state, "step": step, "gen": gen, "net": net, "data": data,
            "readings": readings}


def window(run: dict, seconds: float, in_flight: int, device) -> dict:
    """Replays for ``seconds`` of the host's clock; (steps, wall seconds)."""
    cuda = torch.device(device).type == "cuda"
    state, step, gen = run["state"], run["step"], run["gen"]
    pending: deque = deque()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    steps = 0
    while True:
        state, _ = step(state, None, gen)
        steps += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > in_flight:
                pending.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return {"steps": steps, "seconds": time.perf_counter() - t0}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, log) -> dict:
    cfg, traffic = cell["config"], cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    batch = int(cfg["train"]["batch_size"])
    prepared = setup(cfg, traffic, seed, device)
    before = program.launch_counts()
    setup_end = time.time()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    in_flight = int(traffic["in_flight"])
    if trace:
        timed, tr = tracing.record(lambda: window(prepared, seconds, in_flight, device), sync)
    else:
        timed, tr = window(prepared, seconds, in_flight, device), None
    steps = timed["steps"]
    per_step = tuple((a - b) / steps for a, b in zip(program.launch_counts(), before))
    log(f"[launches] K1 / K1 backward / K2 / K2 backward / resize a step: "
        f"{' / '.join(f'{v:g}' for v in per_step)}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    readings = prepared.pop("readings")
    data = prepared.pop("data")
    prepared.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(cfg, seed, data, int(traffic["checked_steps"]), device)
    numbers = check.train_numbers(readings, ref)
    log(f"[check] loss_gap {numbers['loss_gap']!r}, grad_gap {numbers['grad_gap']!r}, change_gap "
        f"{numbers['change_gap']!r} (worst leaf {numbers['change_worst']!r}); program losses {readings['losses']}, reference "
        f"{ref['losses']}; worst "
        f"gradient leaf {numbers['worst_grad_leaf']}, worst change leaf "
        f"{numbers['worst_change_leaf']}, {numbers['leaves_left_out']} leaves left out")
    model, patch = catalog.model(cfg), int(cfg["patch_size"])
    ctx = {"trace": tr, "steps": steps, "convs": model.conv_layers(cfg, batch, patch),
           "norms": model.norm_layers(cfg, batch, patch),
           "resizes": model.resize_layers(cfg, batch, patch),
           "dtype": cfg["train"]["dtype"], "remat": bool(cfg["train"].get("remat")),
           "launches": per_step}
    return {"setup_end": setup_end, "end_to_end": {
                "train_img_per_s": steps * batch / timed["seconds"]},
            "ctx": ctx, "numbers": numbers, "attempted": steps, "failed": 0,
            "memory_peak_bytes": peak}
