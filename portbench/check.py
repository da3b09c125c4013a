"""The comparisons that decide ``correct``, and their limits.

Training (a cell's first steps, which the reference follows from the same
weights and the same corpus): each number is a relative gap between the
program's reading and the reference's.

- ``loss_gap``: the worst of the steps' |loss - reference loss| / reference loss.
- ``grad_gap``: the first step's gradient as Adam got it (its first moment
  after one step over 1 - b1), by the worst parameter leaf: |norm - reference
  norm| / max(reference norm, the median leaf's reference norm).
- ``change_gap``: the parameters' change over the steps, each leaf's gap
  taken as ``grad_gap``'s, by the median leaf; leaves whose reference
  gradient is under a thousandth of the median leaf's (nought to rounding:
  Adam moves them by round-off alone) are left out. Not the worst leaf:
  Adam's first updates are close to lr * sign(g), so in a small leaf whose
  gradient is mostly rounding (a 64-channel conv bias ahead of a
  LayerNorm) the bf16 runs' signs differ and its change swings from seed to
  seed (``change_worst`` reads up to 0.05 where the median leaf reads under
  0.01); float32 runs agree to 2e-5 on every leaf.

Serving: ``tile_gap``, the largest |served - reference| over the sampled
tiles (outputs in [0, 1]), and ``missing`` (limit 0), the requests that
never got an answer: no reply at all (a timeout), or a connection that the
server closed with no reply beyond those that its admission control refused.
A refusal is an answer, counted as failed: a 503, or a reset, since the
server refuses before it reads the body and a socket closed with its body
unread resets. The server's own count of the requests it admitted tells the
two kinds of reset apart.

A number passes when it is finite and at most its limit
(``limits/<workload>.json``); a run is correct when every number passes.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

DEAD_LEAF = 1e-3
RESET = -1  # a request's status when the server closed its connection with no reply


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> Dict[str, float]:
    """Each leaf's |norm - reference norm| / max(reference norm, the median leaf's)."""
    med = statistics.median(ref[k] for k in keep)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}
    return {k: (g if math.isfinite(g) else math.inf) for k, g in gaps.items()}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, losses)):
        losses.append(math.inf)
    leaves = sorted(ref["grad_norms"])
    grad = _leaf_gaps(prog["grad_norms"], ref["grad_norms"], leaves)
    med = statistics.median(ref["grad_norms"][k] for k in leaves)
    live = [k for k in leaves if ref["grad_norms"][k] >= DEAD_LEAF * med]
    change = _leaf_gaps(prog["change_norms"], ref["change_norms"], live)
    grad_leaf, change_leaf = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": max(losses), "grad_gap": grad[grad_leaf],
            "change_gap": statistics.median(change.values()), "change_worst": change[change_leaf],
            "worst_grad_leaf": grad_leaf, "worst_change_leaf": change_leaf,
            "leaves_left_out": len(leaves) - len(live)}


def missing(statuses: List[int], admitted: int) -> int:
    """Requests that never got an answer, from every request's status (0: no
    reply at all; ``RESET``) and the number that the server admitted: the
    resets that the requests it did not admit and did not answer with a 503
    leave unexplained, and every request with no reply."""
    refused = len(statuses) - admitted - sum(1 for s in statuses if s == 503)
    resets = sum(1 for s in statuses if s == RESET)
    return sum(1 for s in statuses if s == 0) + max(0, resets - max(0, refused))


def serve_numbers(served: Dict[int, object], reference: Dict[int, object], missing: int) -> dict:
    """``served`` / ``reference``: request id -> the (P, P, 3) tile;
    ``missing``: requests that never got an answer (``missing()``)."""
    import numpy as np

    gaps = [float(np.abs(np.asarray(served[k]) - np.asarray(reference[k])).max())
            for k in served]
    return {"tile_gap": max(gaps) if gaps else math.inf, "missing": missing}


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a limit;
    a cell without limits is not correct."""
    compared = {name: {"value": numbers[name], "limit": spec["limit"]}
                for name, spec in limits.items() if name in numbers}
    ok = bool(compared) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
