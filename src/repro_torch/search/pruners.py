"""Pruners: median stopping and asynchronous successive halving (ASHA).

Worker-side contract: on the process backend a pruner instance is
pickled into each submission's :class:`~repro_torch.search.detached.PrunerContext`
and its ``prune(study, trial)`` runs *inside the worker* against a
:class:`~repro_torch.search.detached.StudyView` — a snapshot exposing only
``study.directions`` and ``study.trials`` records with ``state``,
``intermediate`` and ``values``.  Both shipped pruners read nothing
else, so they run unchanged in workers; a custom pruner that touches
more study state still works on the serial/thread backends, and on the
process backend degrades to "don't prune" (the context swallows its
errors) — or to no worker-side pruning at all if it doesn't pickle.
ASHA is the natural fit for the sliding-window scheduler: its rungs are
explicitly asynchronous, so deciding from a slightly stale rung
population (the submit-time snapshot plus streamed sibling reports) is
the algorithm working as designed, not an approximation.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.explorer.registry import PRUNERS
from repro_torch.search.trial import TrialState


@PRUNERS.register("median")
class MedianPruner:
    def __init__(self, n_startup_trials: int = 4, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def prune(self, study, trial) -> bool:
        step = max(trial.intermediate)
        if step < self.n_warmup_steps:
            return False
        done = [t for t in study.trials if t.state == TrialState.COMPLETE and t.intermediate]
        if len(done) < self.n_startup_trials:
            return False
        sign = 1.0 if study.directions[0] == "minimize" else -1.0
        peers = []
        for t in done:
            steps = [s for s in t.intermediate if s <= step]
            if steps:
                peers.append(sign * t.intermediate[max(steps)])
        if not peers:
            return False
        peers.sort()
        median = peers[len(peers) // 2]
        return sign * trial.intermediate[step] > median


@PRUNERS.register("asha")
@PRUNERS.register("successive_halving")
class SuccessiveHalvingPruner:
    """ASHA: rungs at ``min_resource * reduction_factor**k``; a trial is
    pruned at a rung unless it is in the top ``1/reduction_factor`` of all
    values reported at that rung so far (asynchronous — no waiting)."""

    def __init__(self, min_resource: int = 1, reduction_factor: int = 3, min_early_stopping_rate: int = 0):
        self.min_resource = min_resource
        self.rf = reduction_factor
        self.rate = min_early_stopping_rate

    def _rung(self, step: int) -> Optional[int]:
        k = self.rate
        while True:
            r = self.min_resource * self.rf ** k
            if r > step:
                return None
            if self.min_resource * self.rf ** (k + 1) > step:
                return k
            k += 1

    def prune(self, study, trial) -> bool:
        step = max(trial.intermediate)
        rung = self._rung(step)
        if rung is None:
            return False
        resource = self.min_resource * self.rf ** rung
        sign = 1.0 if study.directions[0] == "minimize" else -1.0
        rung_vals = []
        for t in study.trials:
            if t.intermediate:
                steps = [s for s in t.intermediate if s >= resource]
                if steps:
                    rung_vals.append(sign * t.intermediate[min(steps)])
        me_steps = [s for s in trial.intermediate if s >= resource]
        me = sign * trial.intermediate[min(me_steps)]
        if len(rung_vals) < self.rf:
            return False
        rung_vals.sort()
        cutoff = rung_vals[max(0, int(math.ceil(len(rung_vals) / self.rf)) - 1)]
        return me > cutoff
