"""Evaluation API (paper §V): estimators + optimization criteria.

Estimators are independent of the NAS workflow; each produces one scalar
for a candidate.  They can be used directly as study objectives or
registered as :class:`OptimizationCriteria` with a kind:

  * ``objective``        — enters the scalarized score
  * ``soft_constraint``  — enters the score via a direction-aware hinge
                           penalty (minimize: above the limit; maximize:
                           below it)
  * ``hard_constraint``  — checked FIRST; violation terminates the trial
                           early (staged evaluation); direction-aware
                           like the hinge, so "val_accuracy >= 0.9" is
                           ``direction="maximize", limit=0.9``

Scalarization defaults to a weighted sum; a custom aggregator can be
injected (paper: "custom optimization aggregation functions").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.search.study import HardConstraintViolated


class Estimator:
    """Base class: estimate(candidate, context) -> float."""

    name: str = "estimator"

    def estimate(self, candidate: Any, context: Optional[Dict] = None) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class OptimizationCriteria:
    estimator: Estimator
    kind: str = "objective"  # objective | soft_constraint | hard_constraint
    # objectives: which way the score folds the value; constraints: which
    # side of ``limit`` violates (minimize: value must stay <= limit,
    # maximize: value must stay >= limit — "val_accuracy >= 0.9" is
    # ``direction="maximize", limit=0.9``)
    direction: str = "minimize"
    weight: float = 1.0
    limit: Optional[float] = None  # constraints: threshold

    KINDS = ("objective", "soft_constraint", "hard_constraint")
    DIRECTIONS = ("minimize", "maximize")

    def __post_init__(self):
        # real raises, not asserts: criteria frequently come from config
        # (YAML experiments), and asserts vanish under ``python -O``
        if self.kind not in self.KINDS:
            raise ValueError(
                f"unknown criteria kind {self.kind!r}; expected one of {self.KINDS}"
            )
        if self.direction not in self.DIRECTIONS:
            raise ValueError(
                f"unknown direction {self.direction!r}; expected one of {self.DIRECTIONS}"
            )
        if self.kind != "objective" and self.limit is None:
            raise ValueError(f"{self.kind} requires a limit")


def constraint_violation(criterion: OptimizationCriteria, value: float) -> float:
    """Relative violation of a constraint criterion: positive when the
    constraint is violated, scaled by ``|limit|`` so hinge penalties are
    comparable across criteria of different magnitudes.  Honors the
    criterion's ``direction``: a minimize constraint violates above its
    limit, a maximize constraint below it."""
    scale = max(abs(criterion.limit), 1e-12)
    if criterion.direction == "minimize":
        return (value - criterion.limit) / scale
    return (criterion.limit - value) / scale


def weighted_sum(values: Dict[str, float], criteria: List[OptimizationCriteria]) -> float:
    """Default scalarization: weighted sum; soft constraints add a hinge
    penalty proportional to relative violation (direction-aware, see
    :func:`constraint_violation`)."""
    score = 0.0
    by_name = {c.estimator.name: c for c in criteria}
    for name, v in values.items():
        c = by_name[name]
        if c.kind == "objective":
            score += c.weight * (v if c.direction == "minimize" else -v)
        elif c.kind == "soft_constraint":
            score += c.weight * max(0.0, constraint_violation(c, v))
    return score


def check_distinct_names(criteria: Sequence[OptimizationCriteria]) -> None:
    """Values (and the weighted_sum aggregation) key by estimator name:
    two criteria sharing a name would silently overwrite each other,
    dropping one from the score — fail loudly at construction instead."""
    by_name: Dict[str, OptimizationCriteria] = {}
    for c in criteria:
        name = c.estimator.name
        if name in by_name:
            raise ValueError(
                f"criteria share estimator name {name!r}: {by_name[name]!r} "
                f"and {c!r} — values aggregate by name, so one would be "
                f"silently dropped; give the estimators distinct .name values"
            )
        by_name[name] = c


class CriteriaRunner:
    """Staged evaluation: hard constraints first (early termination),
    then objectives + soft constraints, then scalarization.

    This is the degenerate single-stage case of the fidelity cascade: a
    :class:`~repro.evaluation.cascade.CascadeRunner` with no screening
    stages evaluates exactly like a ``CriteriaRunner`` over its final
    stage (``CascadeRunner`` subclasses this class and inherits both
    evaluation paths unchanged)."""

    def __init__(
        self,
        criteria: Sequence[OptimizationCriteria],
        aggregator: Callable[[Dict[str, float], List[OptimizationCriteria]], float] = weighted_sum,
        cache=None,
    ):
        self.criteria = list(criteria)
        check_distinct_names(self.criteria)
        self.aggregator = aggregator
        # One shared EvaluationCache for every compiled-cost estimator in
        # the runner: candidates evaluated under several criteria (e.g.
        # latency soft constraint + memory hard constraint) compile once.
        self.cache = cache
        if cache is not None:
            for c in self.criteria:
                if hasattr(c.estimator, "cache"):
                    c.estimator.cache = cache

    def _staged_values(self, candidate: Any, context: Dict, trial,
                       later_kinds: Sequence[str]) -> Dict[str, float]:
        """The one staged iteration both evaluation paths share: hard
        constraints run FIRST in declaration order (violation terminates
        the trial before any expensive later-kind estimator runs), then
        the ``later_kinds`` in declaration order.  Every computed value is
        recorded on ``trial`` (when given) under the estimator's name."""
        values: Dict[str, float] = {}

        def record(c: OptimizationCriteria) -> float:
            v = float(c.estimator.estimate(candidate, context))
            values[c.estimator.name] = v
            if trial is not None:
                trial.set_user_attr(c.estimator.name, v)
            return v

        for c in self.criteria:
            if c.kind == "hard_constraint":
                v = record(c)
                if constraint_violation(c, v) > 0.0:
                    raise HardConstraintViolated(c.estimator.name, v, c.limit,
                                                 direction=c.direction)
        for c in self.criteria:
            if c.kind in later_kinds:
                record(c)
        return values

    def evaluate(self, candidate: Any, context: Optional[Dict] = None, trial=None) -> float:
        values = self._staged_values(candidate, context or {}, trial,
                                     ("objective", "soft_constraint"))
        return self.aggregator(values, self.criteria)

    def evaluate_multi(self, candidate: Any, context: Optional[Dict] = None, trial=None):
        """Multi-objective form: returns the tuple of objective values
        (hard constraints still terminate early)."""
        values = self._staged_values(candidate, context or {}, trial,
                                     ("objective",))
        return tuple(values[c.estimator.name]
                     for c in self.criteria if c.kind == "objective")
