"""The compiled train step: a trainer's step captured whole in a CUDA graph.

The port's form of the reference's ``jax.jit(step, donate_argnums=(0,))``
(``adunet/train/sr.py:159,275,389``, ``seg.py:91``, ``joint.py:78``): the
forward, the loss, the backward and the Adam update run as one captured
program, and the state is updated in place. A step is split in two:

- **staging**, on the host at every call: the batch as tensors
  (``as_tensors``; nothing is moved yet), copied into the graph's static
  input buffers; the rate of this update from the schedule, written into the
  optimizer's device rate (``Adam.set_update_count``); the state's update
  count, advanced after the call;
- the **body** ``(state, inputs, rng) -> metrics``, on the device: uint8 to
  float, the LR side degraded, augmentation drawn, forward, loss, backward
  and ``TrainState.update``.

``CompiledStep(body, graph=...)`` is ``(state, batch, rng=None) -> (state,
metrics)``. ``captures(state)`` says whether it captures: ``graph=None``
captures a model on CUDA in one process (``state.parallel is None``) and
runs the body eagerly on the CPU, under torchrun and on the space mesh;
``graph=True`` raises where it cannot capture; ``graph=False`` is eager
(for A/B runs).

A captured step is keyed, as ``jit`` retraces for a new shape, by its
inputs' shapes and dtypes, the generator, the storage of every parameter and
that of every optimizer tensor (moments, update counts, the rate). The first
2 calls of a key run eagerly, and they are real steps, the second on a side
stream (PyTorch's whole-network capture recipe): caches, cuDNN's plans,
Adam's moments and ``.grad`` exist before the capture. The third call
captures on that stream (``capture_error_mode="thread_local"``) and replays;
that replay is the third step, and every later call of the key replays. A
key whose optimizer tensors were replaced (a checkpoint restore) is
captured anew after 2 eager calls, never replayed against the old ones; a
new key (a ragged last batch) gets a graph of its own. There is no
fallback: a capture that fails raises.

Around a replay:

- the generator given as ``rng`` is registered with the graph, so its draws
  equal an eager step's, call for call;
- the gradients live in the graph's pool (the body sets them to None
  first); the graph hands them back to the parameters after it replays, so
  ``.grad`` holds this step's, as after an eager step. They are not part of
  the key: the body never reads a ``.grad`` it did not write, and a ragged
  batch's eager step in between would otherwise void the full batch's graph;
- the metrics are copied out of the graph's outputs, so they survive the
  next replay;
- the kernel wrappers' launch counters get what the capture counted
  (``adunet_torch.kernels.add_launches``): launches a step read as eager.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from adunet_torch.kernels import add_launches, launch_counts
from adunet_torch.train.state import TrainState

__all__ = ["CompiledStep"]

WARMUP_CALLS = 2

Body = Callable[[TrainState, Tuple[torch.Tensor, ...], Optional[torch.Generator]],
                Dict[str, torch.Tensor]]


def as_tensors(batch) -> Tuple[torch.Tensor, ...]:
    """A host batch (an array or tensor, a tuple of them, or None) as a
    tuple of tensors where they lie (numpy arrays wrapped, not copied)."""
    if batch is None:
        return ()
    leaves = batch if isinstance(batch, (tuple, list)) else (batch,)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
                 for x in leaves)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device, for every warm-up and capture (the recipe
    warms up on the stream it captures on).

    cuBLAS holds a workspace for each handle (one a thread) and stream for
    the process's life, carved from the caching allocator at the first
    matmul. Carved from a step's freed activations, it keeps the whole
    segment reserved (5.8 GB for the float32 flagship at batch 32); carved
    under capture, it keeps the graph's pool. So the stream's first matmuls,
    forward and backward, float32 and bf16, with and without a bias, run
    here, while the stream holds no memory: each workspace gets a segment
    of its own."""
    stream = torch.cuda.Stream(device)
    torch.cuda.empty_cache()  # a stream from PyTorch's pool may hold freed blocks
    with torch.cuda.stream(stream), torch.enable_grad():
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.ones(8, 8, dtype=dtype, device=device, requires_grad=True)
            torch.nn.functional.linear(a @ a, a, a[0]).sum().backward()
    stream.synchronize()
    return stream


def _optimizer_tensors(optimizer: torch.optim.Optimizer) -> Tuple[int, ...]:
    """The storage of every tensor the optimizer's update reads or writes
    besides the parameters and their gradients."""
    ptrs = [g["lr"].data_ptr() for g in optimizer.param_groups if isinstance(g["lr"], torch.Tensor)]
    for slots in optimizer.state.values():
        ptrs.extend(v.data_ptr() for v in slots.values() if isinstance(v, torch.Tensor))
    return tuple(ptrs)


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]  # static buffers each call copies its batch into
    metrics: Dict[str, torch.Tensor]  # the graph's outputs
    grads: List[Tuple[torch.nn.Parameter, torch.Tensor]]
    launches: tuple  # what the capture counted (``launch_counts`` order)
    optimizer: Tuple[int, ...]  # ``_optimizer_tensors`` after the capture


class CompiledStep:
    """``(state, batch, rng=None) -> (state, metrics)`` over ``body`` (module
    docstring); the body gets ``as_tensors(batch)`` on the model's device.
    ``captures_made`` counts the captures."""

    def __init__(self, body: Body, graph: Optional[bool] = None):
        self.body = body
        self.graph = graph
        self.captures_made = 0
        self._captured: Dict[tuple, _Captured] = {}
        self._eager_calls: Dict[tuple, int] = {}

    def captures(self, state: TrainState) -> bool:
        """Whether a call on ``state`` runs captured (raises for
        ``graph=True`` where it cannot)."""
        if self.graph is False:
            return False
        if state.parallel is not None:
            reason = "across processes (torchrun, the space mesh) the step runs eagerly"
        elif next(state.model.parameters()).device.type != "cuda":
            reason = "a CUDA graph needs a model on a CUDA device"
        else:
            return True
        if self.graph:
            raise ValueError(f"graph=True: {reason}")
        return False

    def __call__(self, state: TrainState, batch, rng: Optional[torch.Generator] = None):
        inputs = as_tensors(batch)
        state.optimizer.set_update_count(state.step)
        if self.captures(state):
            metrics = self._run_captured(state, inputs, rng)
        else:
            metrics = self.body(state, self._on_device(state, inputs), rng)
        state.step += 1
        return state, metrics

    @staticmethod
    def _on_device(state: TrainState, inputs) -> Tuple[torch.Tensor, ...]:
        device = next(state.model.parameters()).device
        return tuple(t.to(device, non_blocking=True) for t in inputs)

    def _run_captured(self, state: TrainState, inputs, rng) -> Dict[str, torch.Tensor]:
        params = list(state.model.parameters())
        key = (tuple((tuple(t.shape), t.dtype) for t in inputs), rng,
               tuple(p.data_ptr() for p in params))
        cap = self._captured.get(key)
        if cap is not None and cap.optimizer != _optimizer_tensors(state.optimizer):
            del self._captured[key]  # restored: the graph would update the old tensors
            cap = None
        if cap is None:
            calls = self._eager_calls.get(key, 0)
            if calls < WARMUP_CALLS:
                self._eager_calls[key] = calls + 1
                return self._eager(state, inputs, rng, side_stream=calls > 0)
            del self._eager_calls[key]
            cap = self._capture(state, inputs, rng, params)
            self._captured[key] = cap
            cap.graph.replay()  # the third step; the capture counted its launches
        else:
            for static, t in zip(cap.inputs, inputs):
                static.copy_(t, non_blocking=True)
            cap.graph.replay()
            add_launches(cap.launches)
        # another step (another key's, or another builder's on the same
        # model) may have set the gradients since this graph last ran
        if cap.grads and cap.grads[0][0].grad is not cap.grads[0][1]:
            for p, g in cap.grads:
                p.grad = g
        return {k: v.clone() for k, v in cap.metrics.items()}

    def _eager(self, state: TrainState, inputs, rng, side_stream: bool):
        inputs = self._on_device(state, inputs)
        if not side_stream:
            return self.body(state, inputs, rng)
        device = next(state.model.parameters()).device
        main = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics = self.body(state, inputs, rng)
        main.wait_stream(side)
        # what the side stream allocated is then free of pending work when
        # the main stream drops it
        torch.cuda.synchronize(device)
        return {k: v.clone() for k, v in metrics.items()}

    def _capture(self, state: TrainState, inputs, rng, params) -> _Captured:
        device = params[0].device
        static = tuple(torch.empty(t.shape, dtype=t.dtype, device=device) for t in inputs)
        for s, t in zip(static, inputs):
            s.copy_(t, non_blocking=True)
        graph = torch.cuda.CUDAGraph()
        if rng is not None and rng.device.type == "cuda":
            graph.register_generator_state(rng)
        before = launch_counts()
        with torch.cuda.graph(graph, stream=_side_stream(device),
                              capture_error_mode="thread_local"):
            metrics = self.body(state, static, rng)
        launches = tuple(a - b for a, b in zip(launch_counts(), before))
        self.captures_made += 1
        grads = [(p, p.grad) for p in params if p.grad is not None]
        return _Captured(graph, static, metrics, grads, launches,
                         _optimizer_tensors(state.optimizer))
