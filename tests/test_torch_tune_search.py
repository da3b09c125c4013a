"""The port's search engine (``adunet_torch.tune``) against the reference's
(``adunet.tune``), and the reference's own engine tests on the port.

Both engines are driven by the same pure-Python objectives, which report
intermediate values, so every trial's parameters, value, state and
intermediate curve, and each study's ``results_payload()``, must be equal
bit for bit: each trial's RNG is ``random.Random(seed * 1_000_003 + n)`` and
the samplers and pruners are the same arithmetic. No model runs here.
"""

import json
import math

import pytest

import adunet.tune as ref
import adunet_torch.tune as port
from adunet_torch.tune import Study, TrialPruned, create_study, group_trials_by


def _mixed_objective(engine, direction):
    """Four kinds of parameter and a 4-step intermediate curve; the curve
    of a trial depends on its parameters, so pruning decisions differ
    between trials."""

    def objective(trial):
        x = trial.suggest_float("x", -10, 10)
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        depth = trial.suggest_int("depth", 3, 9, step=2)
        kind = trial.suggest_categorical("kind", ["a", "b", "c"])
        loss = (x - 3.0) ** 2 / 10 + abs(math.log10(lr) + 3.0) + (depth - 5) ** 2 / 4
        loss += 0.0 if kind == "a" else 0.5
        sign = 1.0 if direction == "minimize" else -1.0
        for step in range(4):
            trial.report(sign * loss * (1.0 + 1.0 / (step + 1)), step)
            if trial.should_prune():
                raise engine.TrialPruned()
        return sign * loss

    return objective


def _study(engine, direction, sampler, pruner, warmup):
    return engine.create_study(direction=direction, seed=5, pruner=pruner, sampler=sampler,
                               prefer_optuna=False, pruner_warmup_trials=warmup[0],
                               pruner_warmup_steps=warmup[1])


@pytest.mark.parametrize("warmup", [(2, 1), (1, 0), (3, 2)])
@pytest.mark.parametrize("direction", ["minimize", "maximize"])
@pytest.mark.parametrize("pruner", ["median", "hyperband", "none"])
@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_study_equals_the_reference(sampler, pruner, direction, warmup):
    studies = {}
    for name, engine in (("ref", ref), ("port", port)):
        study = _study(engine, direction, sampler, pruner, warmup)
        study.optimize(_mixed_objective(engine, direction), n_trials=24)
        studies[name] = study
    want, got = studies["ref"].results_payload(), studies["port"].results_payload()
    assert got == want
    # the payloads compare floats by value: the JSON text is the same too
    assert json.dumps(got) == json.dumps(want)
    if pruner != "none" and warmup == (1, 0):  # the pruner is live in these runs
        assert got["n_pruned"] > 0


@pytest.mark.parametrize("pruner", ["median", "hyperband"])
def test_no_warmup_trials_prunes_nothing_before_a_trial_completes(pruner):
    """Pinned divergence: with ``pruner_warmup_trials=0`` the reference's
    pruner indexes the empty history of completed trials when the first
    trial reports, and raises IndexError; the port's does not prune."""
    for engine, raises in ((ref, True), (port, False)):
        study = _study(engine, "minimize", "tpe", pruner, (0, 0))
        trial = study.ask()
        trial.report(1.0, 0)
        if raises:
            with pytest.raises(IndexError):
                trial.should_prune()
        else:
            assert trial.should_prune() is False
    study = _study(port, "minimize", "tpe", pruner, (0, 0))
    study.optimize(_mixed_objective(port, "minimize"), n_trials=24)
    assert study.results_payload()["n_pruned"] > 0


def _suggest(trial):
    trial.suggest_float("lr", 1e-5, 5e-3, log=True)
    trial.suggest_float("alpha", 0.5, 2.0)
    trial.suggest_categorical("batch_size", [4, 8, 16])


@pytest.mark.parametrize("history", [0, 7])
@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_ask_batch_and_grouping_equal_the_reference(direction, history):
    """Constant-liar batched asks (lies only once trials have completed:
    ``history`` of them, past TPE's 5 start-up trials) give the reference's
    trials, and ``group_trials_by`` its groups."""
    studies, groups = {}, {}
    for name, engine in (("ref", ref), ("port", port)):
        study = engine.Study(direction=direction, seed=9)
        for _ in range(history):
            t = study.ask()
            _suggest(t)
            study.tell(t, t.params["alpha"] * math.log(t.params["lr"]))
        for _round in range(2):
            asked = study.ask_batch(_suggest, 5)
            assert all(t.state == "RUNNING" and t.value is None for t in asked)
            grouped = engine.group_trials_by(asked, "batch_size")
            groups.setdefault(name, []).append(
                [(bs, [t.number for t in ts]) for bs, ts in grouped.items()])
            for t in asked:
                study.tell(t, t.params["alpha"])
        studies[name] = study
    assert groups["port"] == groups["ref"]
    assert studies["port"].results_payload() == studies["ref"].results_payload()


# ------------------------------------------- the reference's engine tests


def _quadratic(trial):
    x = trial.suggest_float("x", -10, 10)
    return (x - 3.0) ** 2


def test_study_minimize_quadratic_and_deterministic():
    study = Study(direction="minimize", seed=0)
    study.optimize(_quadratic, n_trials=50)
    assert abs(study.best_params["x"] - 3.0) < 2.0
    assert study.best_value < 4.0
    again = Study(direction="minimize", seed=0)
    again.optimize(_quadratic, n_trials=50)
    assert [t.value for t in again.trials] == [t.value for t in study.trials]


def test_tpe_beats_random_on_quadratic():
    def best_after(sampler, n=40, seeds=(0, 1, 2, 3, 4)):
        vals = []
        for seed in seeds:
            s = Study(direction="minimize", seed=seed, sampler=sampler)
            s.optimize(_quadratic, n)
            vals.append(s.best_value)
        return sum(vals) / len(vals)

    tpe = best_after("tpe")
    assert tpe < best_after("random")
    assert tpe < 0.2


def test_tpe_log_categorical_and_int_exploitation():
    def objective(trial):
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        kind = trial.suggest_categorical("kind", ["a", "b", "c"])
        d = trial.suggest_int("d", 3, 5)
        return abs(math.log10(lr) + 3.0) + (0.0 if kind == "a" else 1.0) + (d - 4) ** 2

    study = Study(direction="minimize", seed=2, sampler="tpe")
    study.optimize(objective, 50)
    kinds = [t.params["kind"] for t in study.trials[30:]]
    assert kinds.count("a") > len(kinds) / 2
    assert abs(math.log10(study.best_params["lr"]) + 3.0) < 0.5
    assert all(3 <= t.params["d"] <= 5 for t in study.trials)
    assert study.best_params["d"] == 4


@pytest.mark.parametrize("pruner, warmup_trials, rungs", [("median", 2, None),
                                                          ("hyperband", 3, (2, 8))])
def test_pruners_cut_bad_trials(pruner, warmup_trials, rungs):
    """Median: bad trials get cut. Hyperband: they die at rung steps
    (eta^k - 1) only, and the study still converges."""
    study = Study(direction="minimize", seed=0, pruner=pruner, n_warmup_trials=warmup_trials,
                  n_warmup_steps=0 if pruner == "median" else 1)
    n_steps = 3 if pruner == "median" else 9

    def objective(trial):
        x = trial.suggest_float("x", 0, 1)
        for step in range(n_steps):
            trial.report(x + (0.001 * step if rungs else 0.0), step)
            if trial.should_prune():
                raise TrialPruned()
        return x

    study.optimize(objective, n_trials=20 if pruner == "median" else 30)
    assert "PRUNED" in {t.state for t in study.trials}
    assert study.best_value == min(t.value for t in study.completed_trials)
    if rungs:
        assert all(max(t.intermediate) in rungs for t in study.trials if t.state == "PRUNED")
        assert study.best_value < 0.3


def test_pruner_warmup_steps_delays_pruning():
    pruned_at = []

    def objective(trial):
        x = trial.suggest_float("x", 0, 1)
        for step in range(4):
            trial.report(10.0 - x if step < 3 else -x, step)
            if trial.should_prune():
                pruned_at.append(step)
                raise TrialPruned()
        return -x

    create_study(direction="minimize", seed=0, prefer_optuna=False, pruner_warmup_trials=2,
                 pruner_warmup_steps=2).optimize(objective, n_trials=12)
    assert all(step >= 2 for step in pruned_at)
    pruned_at.clear()
    create_study(direction="minimize", seed=0, prefer_optuna=False, pruner_warmup_trials=2,
                 pruner_warmup_steps=0).optimize(objective, n_trials=12)
    assert pruned_at and min(pruned_at) < 2


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_median_pruner_decision_rule_semantics(direction):
    """Strictly worse than the median of completed trials at the same step
    is cut, ties survive; warm-up steps and trials; PRUNED trials do not
    count; maximize mirrors minimize."""
    sign = 1.0 if direction == "minimize" else -1.0
    study = Study(direction=direction, seed=0, pruner="median", n_warmup_trials=2,
                  n_warmup_steps=1)
    for final in (0.2, 0.4, 0.6):
        t = study.ask()
        for step, v in enumerate([final - 0.1, final]):
            t.report(sign * v, step)
        study.tell(t, sign * final)
    probe = study.ask()
    for value, cut in ((0.39, False), (0.40, False), (0.41, True)):
        probe.report(sign * value, 1)
        assert probe.should_prune() is cut
    early = study.ask()
    early.report(sign * 99.0, 0)
    assert not early.should_prune()
    study.tell(probe, state="PRUNED")
    ghost = study.ask()
    ghost.report(sign * -100.0, 1)
    study.tell(ghost, state="PRUNED")
    probe2 = study.ask()
    probe2.report(sign * 0.40, 1)
    assert not probe2.should_prune()

    fresh = Study(direction=direction, seed=0, pruner="median", n_warmup_trials=2,
                  n_warmup_steps=0)
    t0 = fresh.ask()
    t0.report(sign * 0.1, 0)
    fresh.tell(t0, sign * 0.1)
    lone = fresh.ask()
    lone.report(sign * 99.0, 0)
    assert not lone.should_prune()


def test_results_payload_roundtrip_and_fallback(tmp_path):
    study = Study(seed=1)
    study.optimize(lambda t: t.suggest_float("x", 0, 1), 3)
    path = tmp_path / "results.json"
    study.save_results(path)
    payload = json.loads(path.read_text())
    assert payload["n_trials"] == 3 and "best_params" in payload
    assert isinstance(create_study(direction="maximize", seed=3), Study)  # no optuna here


def test_ask_tell_matches_optimize():
    def objective(trial):
        return trial.suggest_float("x", 0, 1) * trial.suggest_categorical("y", [1, 2, 4])

    auto = Study(seed=11)
    auto.optimize(objective, 6)
    manual = Study(seed=11)
    for _ in range(6):
        t = manual.ask()
        manual.tell(t, objective(t))
    assert [t.params for t in auto.trials] == [t.params for t in manual.trials]
    assert [t.value for t in auto.trials] == [t.value for t in manual.trials]
    assert auto.best_params == manual.best_params


def test_ask_batch_retracts_lies_and_tell_needs_a_value():
    def suggest(trial):
        trial.suggest_float("x", 0, 1)
        trial.suggest_categorical("batch_size", [4, 8])

    study = Study(direction="minimize", seed=3)
    for _ in range(6):
        t = study.ask()
        suggest(t)
        study.tell(t, t.params["x"])
    n_complete, best_before = len(study.completed_trials), study.best_value
    asked = study.ask_batch(suggest, 4)
    assert len(asked) == 4
    for t in asked:
        assert t.state == "RUNNING" and t.value is None
        assert set(t.params) == {"x", "batch_size"}
    assert len(study.completed_trials) == n_complete and study.best_value == best_before
    for t in asked:
        study.tell(t, t.params["x"])
    assert len(study.completed_trials) == n_complete + 4
    with pytest.raises(ValueError):
        study.ask_batch(suggest, 0)

    t = Study(seed=0).ask()
    with pytest.raises(ValueError):
        t._study.tell(t)
    t._study.tell(t, state="PRUNED")
    assert t.state == "PRUNED"


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_ask_batch_lies_are_pessimistic(direction):
    """The lie is the WORST completed value (CL-max): it puts the lied
    params in TPE's bad group and repels the remaining asks."""
    study = Study(direction=direction, seed=7)
    for v in (0.2, 0.9, 0.5, 0.4, 0.7, 0.3):
        t = study.ask()
        t.suggest_float("x", 0, 1)
        study.tell(t, v)
    worst = 0.9 if direction == "minimize" else 0.2
    observed = []

    def suggest(trial):
        observed.extend(t.value for t in study.trials
                        if t.state == "COMPLETE" and t.intermediate == {} and t.value == worst
                        and t is not trial and t.number >= 6)
        trial.suggest_float("x", 0, 1)

    asked = study.ask_batch(suggest, 3)
    assert observed == [worst] * 3
    assert all(t.state == "RUNNING" and t.value is None for t in asked)


def test_group_trials_by_orders_and_groups():
    class T:
        def __init__(self, bs):
            self.params = {"batch_size": bs}

    ts = [T(8), T(4), T(8), T(4), T(16)]
    groups = group_trials_by(ts, "batch_size")
    assert list(groups) == [8, 4, 16]
    assert groups[8] == [ts[0], ts[2]] and groups[4] == [ts[1], ts[3]]
