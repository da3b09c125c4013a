"""Hyperparameter search engine with an optuna-compatible surface.

The port's own copy of ``adunet/tune/search.py`` (which imports no JAX, but
the port imports nothing of the reference package). The engine is the same
line for line, so one seed gives the same trials in both packages, bit for
bit: trial ``n`` draws from ``random.Random(seed * 1_000_003 + n)``.

The reference tunes with optuna (TPESampler + MedianPruner,
Super_resolution/code/u_net_vanilla_optuna.py:153-283,
Segmenation/code/unet_vinillia_optuna.py). ``create_study`` returns a real
optuna study when the package is importable and otherwise this module's
built-in engine, whose default
sampler is a univariate **TPE** (tree-structured Parzen estimator): after a
random startup phase, completed trials are split into a good quantile and
the rest, each parameter is modelled with a Parzen (Gaussian-kernel) density
per group, candidates are drawn from the good density and ranked by the
density ratio l(x)/g(x) — the same capability class as the reference's
sampler, not a random-search stand-in. Median pruning on intermediate values
is supported either way, and the objective code is identical.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Trial", "Study", "TrialPruned", "TPESampler", "RandomSampler", "create_study"]


try:  # pragma: no cover - optuna is optional
    # one exception class for BOTH engines: objectives raise adunet's
    # TrialPruned, and when create_study returns a real optuna study its
    # optimize() must recognise the prune signal — a distinct local class
    # would be treated as an unknown error and abort the whole study on
    # the first pruned trial
    from optuna.exceptions import TrialPruned
except Exception:
    class TrialPruned(Exception):
        """Raised by objectives when Trial.should_prune() is honoured."""


# --------------------------------------------------------------- samplers


class RandomSampler:
    """Uniform sampling over each parameter's range."""

    def suggest_float(self, study, rng, name, low, high, log=False) -> float:
        if log:
            return math.exp(rng.uniform(math.log(low), math.log(high)))
        return rng.uniform(low, high)

    def suggest_int(self, study, rng, name, low, high, step=1) -> int:
        return rng.randrange(low, high + 1, step)

    def suggest_categorical(self, study, rng, name, choices) -> Any:
        return rng.choice(list(choices))


class TPESampler(RandomSampler):
    """Univariate tree-structured Parzen estimator.

    For each parameter: completed trials are ranked by objective value, the
    best ``gamma`` fraction forms the "good" group l(x), the rest g(x); both
    are Parzen mixtures (per-observation Gaussians plus one uniform prior
    component for exploration). ``n_candidates`` draws from l(x) are scored
    by log l(x) - log g(x) and the best one wins. Falls back to random
    sampling for the first ``n_startup_trials`` completed trials.
    """

    def __init__(self, n_startup_trials: int = 5, n_candidates: int = 24, gamma: float = 0.25):
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma

    # ---- helpers ----

    def _observations(self, study, name) -> Tuple[List[Any], List[Any]]:
        """(good_values, bad_values) of parameter ``name``, direction-aware."""
        done = [
            t for t in study.trials
            if t.state == "COMPLETE" and t.value is not None and name in t.params
        ]
        if len(done) < self.n_startup_trials:
            return [], []
        reverse = study.direction == "maximize"
        done.sort(key=lambda t: t.value, reverse=reverse)
        n_good = max(1, math.ceil(self.gamma * len(done)))
        good = [t.params[name] for t in done[:n_good]]
        bad = [t.params[name] for t in done[n_good:]] or good
        return good, bad

    @staticmethod
    def _bandwidth(xs: List[float], lo: float, hi: float) -> float:
        span = max(hi - lo, 1e-12)
        if len(xs) < 2:
            return span / 4.0
        mean = sum(xs) / len(xs)
        var = sum((x - mean) ** 2 for x in xs) / (len(xs) - 1)
        silverman = 1.06 * math.sqrt(var) * len(xs) ** -0.2
        # "magic clip" floor (as in optuna's TPE): never let the kernel get
        # narrower than span/(n+1) — a collapsed bandwidth freezes the search
        # on the first decent observation and kills exploration.
        floor = span / min(100.0, 1.0 + len(xs))
        return min(max(silverman, floor), span)

    @staticmethod
    def _log_mixture_pdf(c: float, xs: List[float], sigma: float, lo: float, hi: float) -> float:
        """log of (sum of Gaussians + one uniform prior component) / (n+1)."""
        span = max(hi - lo, 1e-12)
        total = 1.0 / span  # uniform prior component
        inv = 1.0 / (math.sqrt(2.0 * math.pi) * sigma)
        for x in xs:
            z = (c - x) / sigma
            total += inv * math.exp(-0.5 * z * z)
        return math.log(total / (len(xs) + 1))

    def _tpe_float(self, rng, good, bad, lo, hi) -> float:
        bw_g = self._bandwidth(good, lo, hi)
        bw_b = self._bandwidth(bad, lo, hi)
        best_c, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            if rng.random() < 1.0 / (len(good) + 1):
                c = rng.uniform(lo, hi)  # uniform prior draw
            else:
                c = rng.gauss(rng.choice(good), bw_g)
            c = min(max(c, lo), hi)
            score = (
                self._log_mixture_pdf(c, good, bw_g, lo, hi)
                - self._log_mixture_pdf(c, bad, bw_b, lo, hi)
            )
            if score > best_score:
                best_c, best_score = c, score
        return best_c

    # ---- suggest API ----

    def suggest_float(self, study, rng, name, low, high, log=False) -> float:
        good, bad = self._observations(study, name)
        if not good:
            return super().suggest_float(study, rng, name, low, high, log)
        if log:
            g = [math.log(v) for v in good]
            b = [math.log(v) for v in bad]
            return math.exp(self._tpe_float(rng, g, b, math.log(low), math.log(high)))
        return self._tpe_float(rng, good, bad, low, high)

    def suggest_int(self, study, rng, name, low, high, step=1) -> int:
        good, bad = self._observations(study, name)
        if not good:
            return super().suggest_int(study, rng, name, low, high, step)
        c = self._tpe_float(rng, [float(v) for v in good], [float(v) for v in bad],
                            float(low), float(high))
        # snap onto the {low, low+step, ...} grid and clamp WITHIN the grid —
        # min(snapped, high) could return an off-grid value when (high - low)
        # is not a multiple of step (e.g. low=0 high=10 step=4 -> 10)
        n_steps = max(0, (high - low) // step)
        k = round((c - low) / step)
        return int(low + min(max(k, 0), n_steps) * step)

    def suggest_categorical(self, study, rng, name, choices) -> Any:
        choices = list(choices)
        good, bad = self._observations(study, name)
        if not good:
            return super().suggest_categorical(study, rng, name, choices)
        # smoothed category weights; sample proportional to the density ratio
        def probs(obs):
            counts = {c: 1.0 for c in choices}  # +1 smoothing
            for v in obs:
                if v in counts:
                    counts[v] += 1.0
            total = sum(counts.values())
            return {c: counts[c] / total for c in choices}

        pg, pb = probs(good), probs(bad)
        ratios = [pg[c] / pb[c] for c in choices]
        total = sum(ratios)
        pick = rng.uniform(0.0, total)
        acc = 0.0
        for c, r in zip(choices, ratios):
            acc += r
            if pick <= acc:
                return c
        return choices[-1]


# --------------------------------------------------------------- trials


@dataclass
class Trial:
    number: int
    _rng: random.Random
    _study: "Study"
    params: Dict[str, Any] = field(default_factory=dict)
    intermediate: Dict[int, float] = field(default_factory=dict)
    value: Optional[float] = None
    state: str = "RUNNING"  # RUNNING | COMPLETE | PRUNED | FAIL

    # ---- optuna-compatible suggest API (delegates to the study sampler) ----
    def suggest_float(self, name: str, low: float, high: float, *, log: bool = False) -> float:
        value = self._study.sampler.suggest_float(self._study, self._rng, name, low, high, log)
        self.params[name] = value
        return value

    def suggest_int(self, name: str, low: int, high: int, *, step: int = 1) -> int:
        value = self._study.sampler.suggest_int(self._study, self._rng, name, low, high, step)
        self.params[name] = value
        return value

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        value = self._study.sampler.suggest_categorical(self._study, self._rng, name, choices)
        self.params[name] = value
        return value

    # ---- pruning ----
    def report(self, value: float, step: int) -> None:
        self.intermediate[step] = float(value)

    def should_prune(self) -> bool:
        return self._study._should_prune(self)


class Study:
    """Seeded TPE (default) or random-search study with median pruning."""

    def __init__(
        self,
        direction: str = "minimize",
        seed: int = 0,
        pruner: str = "median",
        sampler: str | RandomSampler = "tpe",
        n_warmup_trials: int = 2,
        n_warmup_steps: int = 1,
    ):
        if direction not in ("minimize", "maximize"):
            raise ValueError("direction must be 'minimize' or 'maximize'")
        self.direction = direction
        self.seed = seed
        self.pruner = pruner
        if isinstance(sampler, str):
            sampler = TPESampler() if sampler == "tpe" else RandomSampler()
        self.sampler = sampler
        self.n_warmup_trials = n_warmup_trials
        self.n_warmup_steps = n_warmup_steps
        self.trials: List[Trial] = []

    # internal pruners over completed trials' intermediate curves
    def _should_prune(self, trial: Trial) -> bool:
        if not trial.intermediate:
            return False
        step = max(trial.intermediate)
        if step < self.n_warmup_steps:
            return False
        history = [
            t.intermediate[step]
            for t in self.trials
            if t.state == "COMPLETE" and step in t.intermediate
        ]
        # no completed trial at this step: nothing to compare with (the
        # reference indexes the empty history and raises IndexError when
        # n_warmup_trials is 0)
        if not history or len(history) < self.n_warmup_trials:
            return False
        current = trial.intermediate[step]
        ascending = sorted(history)

        if self.pruner == "median":
            median = ascending[len(ascending) // 2]
            return current > median if self.direction == "minimize" else current < median

        if self.pruner == "hyperband":
            # successive halving: at rung steps (eta^k - 1), survive only if
            # inside the top 1/eta of completed trials at the same step
            eta = 3
            rung = 1
            while rung - 1 < step:
                rung *= eta
            if step != rung - 1 and step != 0:
                return False
            k = max(1, len(ascending) // eta)  # size of the surviving tier
            if self.direction == "minimize":
                return current > ascending[k - 1]
            return current < ascending[-k]

        return False  # pruner == "none"

    # ---- ask/tell API (optuna-compatible split of optimize's loop body) ----

    def ask(self) -> Trial:
        """Create, register and return the next trial.

        The trial's parameters are drawn lazily: each ``trial.suggest_*``
        call consults the sampler against the study's state at that moment.
        """
        trial = Trial(
            number=len(self.trials),
            _rng=random.Random(self.seed * 1_000_003 + len(self.trials)),
            _study=self,
        )
        self.trials.append(trial)
        return trial

    def tell(self, trial: Trial, value: Optional[float] = None, state: str = "COMPLETE") -> None:
        """Record a trial's outcome (value for COMPLETE; PRUNED/FAIL otherwise)."""
        if state == "COMPLETE":
            if value is None:
                raise ValueError("tell(state='COMPLETE') requires a value.")
            trial.value = float(value)
        trial.state = state

    def ask_batch(self, suggest: Callable[[Trial], None], k: int) -> List[Trial]:
        """Ask ``k`` trials at once for parallel evaluation.

        Sequential TPE conditions each suggestion on all previous results;
        a naive k-ask would give k near-identical candidates. The standard
        fix is the constant-liar heuristic (Ginsbourger et al., batched
        Bayesian optimisation): after suggesting each trial's parameters,
        temporarily record a *pessimistic* value for it (the worst completed
        value — CL-max), so the lied parameters land in TPE's BAD group and
        inflate g(x) there: candidates near an already-asked point score
        lower on log l(x) - log g(x) and the remaining asks diversify.
        (Lying with the BEST value would do the opposite — the lie would
        join the top-gamma good group and ATTRACT the next asks.) The lies
        are removed before returning — the study's persistent state only
        ever contains real results.
        """
        if k < 1:
            raise ValueError("ask_batch needs k >= 1.")
        lie = None
        if self.completed_trials:
            values = [t.value for t in self.completed_trials]
            lie = max(values) if self.direction == "minimize" else min(values)
        asked: List[Trial] = []
        for _ in range(k):
            trial = self.ask()
            suggest(trial)
            if lie is not None:
                trial.value, trial.state = lie, "COMPLETE"  # temporary lie
            asked.append(trial)
        for trial in asked:  # retract the lies
            if lie is not None:
                trial.value, trial.state = None, "RUNNING"
        return asked

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int,
        callbacks: Optional[List[Callable]] = None,
    ) -> None:
        for _ in range(n_trials):
            trial = self.ask()
            try:
                self.tell(trial, float(objective(trial)))
            except TrialPruned:
                self.tell(trial, state="PRUNED")
            except Exception:
                self.tell(trial, state="FAIL")
                raise
            for cb in callbacks or []:
                cb(self, trial)

    @property
    def completed_trials(self) -> List[Trial]:
        return [t for t in self.trials if t.state == "COMPLETE"]

    @property
    def best_trial(self) -> Trial:
        done = self.completed_trials
        if not done:
            raise ValueError("No completed trials.")
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(done, key=key)

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial.params

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    def results_payload(self) -> Dict[str, Any]:
        return {
            "direction": self.direction,
            "sampler": type(self.sampler).__name__,
            "n_trials": len(self.trials),
            "n_complete": len(self.completed_trials),
            "n_pruned": sum(1 for t in self.trials if t.state == "PRUNED"),
            "best_value": self.best_value if self.completed_trials else None,
            "best_params": self.best_params if self.completed_trials else None,
            "trials": [
                {
                    "number": t.number,
                    "state": t.state,
                    "value": t.value,
                    "params": t.params,
                    "intermediate": t.intermediate,
                }
                for t in self.trials
            ],
        }

    def save_results(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.results_payload(), indent=2, default=str))


def create_study(
    direction: str = "minimize",
    seed: int = 0,
    pruner: str = "median",
    sampler: str = "tpe",
    prefer_optuna: bool = True,
    pruner_warmup_trials: int = 2,
    pruner_warmup_steps: int = 1,
):
    """Return an optuna study when available, else the built-in Study.

    ``pruner_warmup_steps``/``pruner_warmup_trials``: no trial is pruned
    before this many reported steps / completed reference trials. The
    fidelity study (experiments/round4_sweep/tune_fidelity) measured the
    default median rule pruning the true top-2 configs on the identity-start
    SR landscape — slow-starting low-lr trials sit in a plateau the early
    medians punish — so short-budget studies should raise the step warm-up
    (or use --pruner none)."""
    if prefer_optuna:
        try:  # pragma: no cover - optuna is optional
            import optuna

            osampler = (
                optuna.samplers.TPESampler(seed=seed)
                if sampler == "tpe"
                else optuna.samplers.RandomSampler(seed=seed)
            )
            if pruner == "median":
                opruner = optuna.pruners.MedianPruner(
                    n_startup_trials=pruner_warmup_trials,
                    n_warmup_steps=pruner_warmup_steps,
                )
            elif pruner == "hyperband":
                opruner = optuna.pruners.HyperbandPruner()
            else:
                opruner = optuna.pruners.NopPruner()
            return optuna.create_study(direction=direction, sampler=osampler, pruner=opruner)
        except ImportError:
            pass
    return Study(
        direction=direction, seed=seed, pruner=pruner, sampler=sampler,
        n_warmup_trials=pruner_warmup_trials, n_warmup_steps=pruner_warmup_steps,
    )
