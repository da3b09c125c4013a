"""Runs of the harness on the CPU at toy sizes (``toy.py``), past its look
for a card: a smoke run of each driver, which prints a line marked as no
measurement, and runs with the timed path broken underneath, which must
come out not correct: a step that leaves the state unchanged, the loss of
half of the batch, steps that train on the same patches again, an answer
altered where it is produced, half of a served batch left out, an admitted
request whose connection is dropped unanswered. (The cells run on one card:
no exchange between chips to leave out.)"""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import run
from portbench.tests.toy import toy_cell

SEED = 2_147_483_713


def run_toy(workload: str, seconds: float = 2.0, trace: bool = False) -> dict:
    return run.run_cell(toy_cell(workload), SEED, seconds, trace, "cpu")


@pytest.mark.parametrize("workload, trace", [("sr_flagship.train", False),
                                             ("sr_flagship.serve_bulk", True),
                                             ("sr_flagship.serve_open", False)])
def test_smoke_run_prints_no_measurement(workload, trace, capsys):
    result = run_toy(workload, trace=trace)
    print(json.dumps(result))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["measurement"].startswith("none")
    assert result["device"]["platform"] == "cpu" and result["attempted"] > 0
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from adunet_torch.train.state import TrainState

    monkeypatch.setattr(TrainState, "update", lambda self: None)
    result = run_toy("sr_flagship.train")
    assert not result["correct"] and result["checks"]["change_gap"]["value"] > 0.9  # about 1


def test_loss_of_half_the_batch_is_not_correct(monkeypatch):
    import adunet_torch.losses as losses

    full = losses.charbonnier_loss
    monkeypatch.setattr(losses, "charbonnier_loss",
                        lambda t, p: full(t[: len(t) // 2], p[: len(p) // 2]))
    assert not run_toy("sr_flagship.train")["correct"]


def test_steps_that_retrain_the_same_patches_are_not_correct(monkeypatch):
    """From the third step on (on the card: the graph's replays) every step
    trains on the third step's patches: the later steps' losses betray it."""
    import adunet_torch.train.sr as sr

    draw, calls, kept = sr.sample_patch_batch, [], []

    def stale(*args, **kwargs):
        calls.append(1)
        if len(calls) < 3 or not kept:
            batch = draw(*args, **kwargs)
            if len(calls) >= 3:
                kept.append(batch)
            return batch
        return kept[0]

    monkeypatch.setattr(sr, "sample_patch_batch", stale)
    result = run_toy("sr_flagship.train")
    assert not result["correct"] and result["checks"]["loss_gap"]["value"] > 0.01


def _break_program(monkeypatch, fault):
    from adunet_torch.export.program import Program

    call = Program.__call__

    def broken(self, tiles):
        return fault(np.array(call(self, tiles)))

    monkeypatch.setattr(Program, "__call__", broken)


def test_altered_answer_is_not_correct(monkeypatch):
    def alter(out):
        out[:, :4, :4, :] = 1.0 - out[:, :4, :4, :]
        return out

    _break_program(monkeypatch, alter)
    result = run_toy("sr_flagship.serve_bulk")
    assert not result["correct"] and result["checks"]["tile_gap"]["value"] > 0.1


def test_half_of_a_served_batch_left_out_is_not_correct(monkeypatch):
    def halve(out):
        out[len(out) // 2:] = 0.0
        return out

    _break_program(monkeypatch, halve)
    assert not run_toy("sr_flagship.serve_bulk", seconds=3.0)["correct"]


def test_admitted_request_dropped_unanswered_is_not_correct(monkeypatch):
    """The server admits every seventh request and then drops its connection
    with no reply: the client reads a reset, as it reads some refusals, but
    the server's count of admitted requests shows that these were not."""
    from adunet_torch.cli.serve import _Batcher

    submit, calls = _Batcher.submit, []

    def dropping(self, image):
        calls.append(1)
        if len(calls) % 7 == 0:
            raise ValueError("dropped")  # not caught by the handler: the connection closes
        return submit(self, image)

    monkeypatch.setattr(_Batcher, "submit", dropping)
    result = run_toy("sr_flagship.serve_bulk")
    assert not result["correct"] and result["checks"]["missing"]["value"] > 0
