"""Samplers: Random, Grid, TPE-lite, Regularized Evolution, NSGA-II.

These provide the Optuna sampler surface the paper builds on.  All
samplers implement *independent* per-distribution sampling through
``sample(study, trial, name, dist)`` — population-based samplers
additionally precompute a full parent configuration per trial and serve
values from it, falling back to random for never-seen parameters (which
naturally handles conditional search spaces created by the DSL's dynamic
block expansion).
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.explorer.registry import SAMPLERS
from repro_torch.search.detached import (
    DetachedEvolution,
    DetachedGrid,
    DetachedNSGA2,
    DetachedSampler,
    DetachedTPE,
    grid_value,
    tpe_pick,
    tpe_split,
)
from repro_torch.search.trial import Distribution, Trial, TrialState


class BaseSampler:
    #: True when the sampler's suggestions for trial *n* do not depend on
    #: which other trials have completed (been told) by the time trial *n*
    #: is asked.  Random and Grid qualify — their values derive from the
    #: per-trial RNG stream / the trial number alone — so the sliding-
    #: window scheduler (schedule="auto") runs them fully asynchronously.
    #: Population-based samplers (TPE/evolution/NSGA-II) consult completed
    #: history at ask time, so "auto" keeps them on the batch scheduler,
    #: whose snapshot boundaries are deterministic.
    order_independent = False

    def __init__(self, seed: Optional[int] = None):
        self._base_seed = seed if seed is not None else random.Random().getrandbits(31)
        self.rng = random.Random(seed)

    def trial_rng(self, trial: Trial) -> random.Random:
        """Concurrency-safe randomness hook: a per-trial RNG stream derived
        from (sampler seed, trial number).  Each trial is evaluated by at
        most one worker, so suggestions drawn from this stream are
        deterministic regardless of how many workers run concurrently or
        in which order their suggestions interleave."""
        rng = getattr(trial, "_sampler_rng", None)
        if rng is None:
            rng = random.Random(f"{self._base_seed}/{trial.number}")
            trial._sampler_rng = rng
        return rng

    def sample(self, study, trial: Trial, name: str, dist: Distribution) -> Any:
        raise NotImplementedError

    def on_trial_start(self, study, trial: Trial) -> None:
        """Hook run serially under the study lock at ask() time —
        population-based samplers snapshot parents here so their shared
        ``self.rng`` is never touched from worker threads."""

    def detached(self, study, trial: Trial) -> DetachedSampler:
        """Picklable sampling plan for evaluating ``trial`` in another
        process (see :mod:`repro.search.detached`).  The default plan is
        pure per-trial-stream random — correct for ``RandomSampler``;
        samplers that consult study state must override this to snapshot
        whatever their ``sample`` reads.  Called under the study lock."""
        return DetachedSampler(self._base_seed)


@SAMPLERS.register("random")
class RandomSampler(BaseSampler):
    order_independent = True

    def sample(self, study, trial, name, dist):
        return dist.random(self.trial_rng(trial))


@SAMPLERS.register("grid")
class GridSampler(BaseSampler):
    """Exhaustive sweep over categorical/int grids (continuous -> random)."""

    order_independent = True  # position = f(trial number, registry) only

    def sample(self, study, trial, name, dist):
        if dist.kind == "float":
            return dist.random(self.trial_rng(trial))
        # position determined by trial number so the cartesian product is
        # swept in mixed-radix order across trials
        with study._lock:
            return grid_value(study.distribution_registry, name, dist, trial.number)

    def detached(self, study, trial):
        return DetachedGrid(self._base_seed, study.distribution_registry)


@SAMPLERS.register("tpe")
class TPESampler(BaseSampler):
    """Tree-structured Parzen Estimator (lite).

    Splits completed trials into good/bad by the gamma-quantile of the
    first objective and samples the candidate maximizing l(x)/g(x)
    (kernel density for continuous, smoothed counts for categorical).
    """

    def __init__(self, seed: Optional[int] = None, gamma: float = 0.25,
                 n_candidates: int = 24, n_startup: int = 10):
        super().__init__(seed)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup

    @staticmethod
    def _records(study) -> List[Tuple[Dict[str, Any], float]]:
        return [
            (t.params, t.values[0]) for t in study.trials
            if t.state == TrialState.COMPLETE and t.values
        ]

    @staticmethod
    def _sign(study) -> float:
        return 1.0 if study.directions[0] == "minimize" else -1.0

    def sample(self, study, trial, name, dist):
        rng = self.trial_rng(trial)
        gvals, bvals = tpe_split(
            self._records(study), name, self.n_startup, self.gamma, self._sign(study))
        if gvals is None:
            return dist.random(rng)
        return tpe_pick(rng, dist, gvals, bvals, self.n_candidates)

    def detached(self, study, trial):
        # One records snapshot per batch, not per trial: every plan in a
        # batch sees the same completed set (tells only happen between
        # batches, and asks bump len(study.trials) before plans are
        # built), so key the memo on the trial count.  Each worker submit
        # still pickles the shared list — inherent to shipping TPE state.
        key = len(study.trials)
        cached = getattr(self, "_detached_snapshot", None)
        if cached is None or cached[0] != key:
            cached = self._detached_snapshot = (key, self._records(study))
        return DetachedTPE(self._base_seed, cached[1], self.gamma,
                           self.n_candidates, self.n_startup, self._sign(study))


@SAMPLERS.register("evolution")
class RegularizedEvolutionSampler(BaseSampler):
    """Regularized evolution (Real et al., 2019): tournament-select a parent
    from a sliding population, mutate one parameter."""

    def __init__(self, seed: Optional[int] = None, population: int = 20,
                 tournament: int = 5, mutation_rate: float = 1.0):
        super().__init__(seed)
        self.population = population
        self.tournament = tournament
        self.mutation_rate = mutation_rate
        self._parent_params: Dict[int, Dict[str, Any]] = {}
        self._mutated: Dict[int, set] = {}

    def on_trial_start(self, study, trial):
        done = [t for t in study.trials if t.state == TrialState.COMPLETE and t.values]
        pop = done[-self.population :]
        if not pop:
            return
        sign = 1.0 if study.directions[0] == "minimize" else -1.0
        cohort = [pop[self.rng.randrange(len(pop))] for _ in range(min(self.tournament, len(pop)))]
        parent = min(cohort, key=lambda t: sign * t.values[0])
        self._parent_params[trial.number] = dict(parent.params)
        names = list(parent.params)
        n_mut = max(1, int(round(self.mutation_rate)))
        self._mutated[trial.number] = set(self.rng.sample(names, min(n_mut, len(names))))

    def sample(self, study, trial, name, dist):
        parent = self._parent_params.get(trial.number)
        if parent is None or name not in parent or name in self._mutated.get(trial.number, ()):
            return dist.random(self.trial_rng(trial))
        return parent[name]

    def detached(self, study, trial):
        return DetachedEvolution(self._base_seed, self._parent_params.get(trial.number),
                                 self._mutated.get(trial.number, ()))


def _dominates(a, b, directions) -> bool:
    signs = [1.0 if d == "minimize" else -1.0 for d in directions]
    av = [s * v for s, v in zip(signs, a)]
    bv = [s * v for s, v in zip(signs, b)]
    return all(x <= y for x, y in zip(av, bv)) and any(x < y for x, y in zip(av, bv))


def pareto_front(trials, directions) -> List[Trial]:
    done = [t for t in trials if t.state == TrialState.COMPLETE and t.values]
    front = []
    for t in done:
        if not any(_dominates(o.values, t.values, directions) for o in done if o is not t):
            front.append(t)
    return front


@SAMPLERS.register("nsga2")
class NSGA2Sampler(BaseSampler):
    """Multi-objective evolutionary sampler: nondominated-rank + crowding
    tournament selection, uniform crossover, per-param mutation."""

    def __init__(self, seed: Optional[int] = None, population: int = 24, mutation_p: float = 0.1):
        super().__init__(seed)
        self.population = population
        self.mutation_p = mutation_p
        self._parent_params: Dict[int, Dict[str, Any]] = {}

    def _rank(self, trials, directions):
        ranks = {}
        remaining = list(trials)
        r = 0
        while remaining:
            front = [
                t for t in remaining
                if not any(_dominates(o.values, t.values, directions) for o in remaining if o is not t)
            ]
            if not front:
                front = list(remaining)
            for t in front:
                ranks[t.number] = r
            remaining = [t for t in remaining if t not in front]
            r += 1
        return ranks

    def _crowding(self, pop):
        """Crowding distance per trial: boundary points get inf, interior
        points the normalized objective-space gap to their neighbours."""
        dist = {t.number: 0.0 for t in pop}
        for k in range(len(pop[0].values)):
            srt = sorted(pop, key=lambda t: t.values[k])
            span = max(srt[-1].values[k] - srt[0].values[k], 1e-12)
            dist[srt[0].number] = dist[srt[-1].number] = float("inf")
            for i in range(1, len(srt) - 1):
                dist[srt[i].number] += (srt[i + 1].values[k] - srt[i - 1].values[k]) / span
        return dist

    def on_trial_start(self, study, trial):
        done = [t for t in study.trials if t.state == TrialState.COMPLETE and t.values]
        pop = done[-self.population :]
        if len(pop) < 2:
            return
        ranks = self._rank(pop, study.directions)
        crowd = self._crowding(pop)
        pick = lambda: min(
            (pop[self.rng.randrange(len(pop))] for _ in range(2)),
            key=lambda t: (ranks[t.number], -crowd[t.number]),
        )
        p1, p2 = pick(), pick()
        child = {
            k: (p1.params.get(k) if self.rng.random() < 0.5 else p2.params.get(k, p1.params.get(k)))
            for k in set(p1.params) | set(p2.params)
        }
        self._parent_params[trial.number] = child

    def sample(self, study, trial, name, dist):
        rng = self.trial_rng(trial)
        parent = self._parent_params.get(trial.number)
        if parent is None or name not in parent or parent[name] is None:
            return dist.random(rng)
        if rng.random() < self.mutation_p:
            # local (polynomial-style) mutation around the inherited value
            return dist.perturb(rng, parent[name])
        return parent[name]

    def detached(self, study, trial):
        return DetachedNSGA2(self._base_seed, self._parent_params.get(trial.number),
                             self.mutation_p)
