"""Fidelity cascade: staged candidate screening before the measured
evaluation (the JAX package's ``evaluation/cascade.py`` on the port).

The flat :class:`~repro_torch.evaluation.api.CriteriaRunner` places and
runs every candidate on the target before any criterion can reject it.
A cascade restructures the evaluation layer as an ordered list of
:class:`FidelityStage`\\ s, from cheap to expensive::

    CascadeRunner([
        FidelityStage("zero_cost",                    # tier 0: ~ms/candidate
                      [OptimizationCriteria(SynFlowEstimator(),
                                            direction="maximize")],
                      keep=KeepRule(top_frac=0.25)),
        FidelityStage("analytic",                     # tier 1: analytic/roofline
                      [OptimizationCriteria(FlopsEstimator())],
                      keep=KeepRule(top_k=8)),
        FidelityStage("measured",                     # tier 2: the old flat pass
                      [OptimizationCriteria(latency), ...]),
    ])

Every stage but the last carries a **keep rule** — ``top_k`` / ``top_frac``
(rank the cohort by the stage's scalarized score, lower = better, and
keep the best) or ``threshold`` (keep candidates whose stage score is
<= the threshold; per-candidate, no cohort needed).  ``screen_cohort``
runs the screening stages over a cohort of candidates in-process;
survivors are *promoted* to the final stage, which is evaluated by the
inherited :meth:`~repro_torch.evaluation.api.CriteriaRunner.evaluate` /
``evaluate_multi`` — a ``CascadeRunner`` **is** a ``CriteriaRunner``
over its final stage, and a cascade with no screening stages is exactly
the old flat runner (the degenerate one-stage case).

Stage scores scalarize through the same aggregator as the final score
(maximize objectives fold in by sign), so "keep the best" always means
"keep the lowest stage score"; a hard constraint inside a screening
stage marks the candidate infeasible right there, before anything runs
on the target.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.evaluation.api import (
    CriteriaRunner,
    OptimizationCriteria,
    check_distinct_names,
    weighted_sum,
)
from repro_torch.search.study import HardConstraintViolated

KEEP_RULES = ("top_k", "top_frac", "threshold")


@dataclasses.dataclass(frozen=True)
class KeepRule:
    """Which candidates survive a screening stage.  Exactly one of the
    three fields must be set: ``top_k`` / ``top_frac`` rank the cohort by
    stage score (lower = better, ties broken by ask order) and keep the
    best k / fraction (at least one); ``threshold`` keeps candidates
    whose stage score is <= the threshold, independent of the cohort."""

    top_k: Optional[int] = None
    top_frac: Optional[float] = None
    threshold: Optional[float] = None

    def __post_init__(self):
        set_fields = [name for name in KEEP_RULES
                      if getattr(self, name) is not None]
        if len(set_fields) != 1:
            raise ValueError(
                f"a keep rule needs exactly one of {KEEP_RULES}, "
                f"got {set_fields or 'none'}")
        if self.top_k is not None and int(self.top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_frac is not None and not 0.0 < float(self.top_frac) <= 1.0:
            raise ValueError(
                f"top_frac must be in (0, 1], got {self.top_frac}")

    def survivors(self, scored: Sequence[Tuple[int, float]]) -> List[int]:
        """Indices surviving this rule.  ``scored`` is ``(index, score)``
        with lower scores better; ranking rules sort by ``(score, index)``
        so ties keep ask order and the selection is deterministic."""
        if self.threshold is not None:
            return [i for i, s in scored if s <= float(self.threshold)]
        ranked = sorted(scored, key=lambda pair: (pair[1], pair[0]))
        if self.top_k is not None:
            n = int(self.top_k)
        else:
            n = max(1, math.ceil(float(self.top_frac) * len(ranked)))
        return sorted(i for i, _ in ranked[:n])

    def to_dict(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in KEEP_RULES
                if getattr(self, name) is not None}


@dataclasses.dataclass
class FidelityStage:
    """One rung of the cascade: a named criteria list plus the keep rule
    that decides who climbs to the next rung (``None`` marks the final,
    fully-evaluated stage)."""

    name: str
    criteria: List[OptimizationCriteria]
    keep: Optional[KeepRule] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("a fidelity stage needs a non-empty name")
        if not self.criteria:
            raise ValueError(
                f"fidelity stage {self.name!r} needs at least one criterion")


@dataclasses.dataclass
class CohortResult:
    """What screening one cohort decided, by candidate index:
    ``promoted`` survived every screening stage; ``screened`` were cut by
    a ranking/threshold rule (index -> stage name); ``infeasible`` hit a
    hard constraint inside a screening stage (index -> (stage name,
    exception))."""

    promoted: List[int]
    screened: Dict[int, str]
    infeasible: Dict[int, Tuple[str, HardConstraintViolated]]

    @property
    def counts(self) -> Dict[str, int]:
        return {"promoted": len(self.promoted),
                "screened": len(self.screened),
                "infeasible": len(self.infeasible)}


# user-attr prefix for per-stage scalarized scores (the report's
# proxy-vs-final Spearman reads these back)
STAGE_SCORE_ATTR = "fidelity_score:"


class CascadeRunner(CriteriaRunner):
    """A :class:`CriteriaRunner` over the final stage, plus in-process
    screening stages.  ``evaluate`` / ``evaluate_multi`` run the final
    stage only (identical to the flat runner — existing callers see no
    difference); :meth:`screen_cohort` runs the screening stages over a
    cohort and says who gets promoted to them."""

    def __init__(self, stages: Sequence[FidelityStage],
                 aggregator: Callable[[Dict[str, float], List[OptimizationCriteria]], float] = weighted_sum,
                 cache=None):
        stages = list(stages)
        if not stages:
            raise ValueError("a cascade needs at least one stage")
        names = [s.name for s in stages]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(f"duplicate fidelity stage name(s) {dupes}")
        for s in stages[:-1]:
            if s.keep is None:
                raise ValueError(
                    f"screening stage {s.name!r} needs a keep rule "
                    f"(only the final stage evaluates everything it is given)")
        if stages[-1].keep is not None:
            raise ValueError(
                f"final stage {stages[-1].name!r} must not have a keep rule — "
                f"it evaluates every promoted candidate")
        # estimator names must be distinct across the WHOLE cascade, not
        # just within one stage: trials record values by estimator name
        check_distinct_names([c for s in stages for c in s.criteria])
        super().__init__(stages[-1].criteria, aggregator=aggregator, cache=cache)
        self.stages = stages
        self.screening = stages[:-1]
        # per-stage flat runners score cohorts with the same staged
        # iteration (hard constraints first) and the same aggregator as
        # the final score; the shared cache wires onto every estimator
        self._stage_runners = {
            s.name: CriteriaRunner(s.criteria, aggregator=aggregator, cache=cache)
            for s in self.screening
        }

    @property
    def all_criteria(self) -> List[OptimizationCriteria]:
        """Every criterion in cascade order (screening stages first)."""
        return [c for s in self.stages for c in s.criteria]

    def screen_cohort(self, candidates: Sequence[Any], trials: Optional[Sequence[Any]] = None,
                      context: Optional[Dict] = None) -> CohortResult:
        """Run the screening stages over a cohort of built candidates.

        ``trials`` (optional, parallel to ``candidates``) receives the
        per-criterion values and the scalarized stage score
        (``fidelity_score:<stage>``) as user attrs, so reports can
        correlate proxy rankings with final outcomes.  Candidates
        eliminated at stage *i* never run stage *i+1* — and never reach
        the measured final stage at all.
        """
        alive = list(range(len(candidates)))
        screened: Dict[int, str] = {}
        infeasible: Dict[int, Tuple[str, HardConstraintViolated]] = {}
        for stage in self.screening:
            runner = self._stage_runners[stage.name]
            scored: List[Tuple[int, float]] = []
            for i in alive:
                trial = trials[i] if trials is not None else None
                try:
                    score = runner.evaluate(candidates[i], context, trial=trial)
                except HardConstraintViolated as e:
                    infeasible[i] = (stage.name, e)
                    continue
                if trial is not None:
                    trial.set_user_attr(STAGE_SCORE_ATTR + stage.name, score)
                scored.append((i, score))
            kept = set(stage.keep.survivors(scored))
            for i, _ in scored:
                if i not in kept:
                    screened[i] = stage.name
            alive = [i for i, _ in scored if i in kept]
        return CohortResult(promoted=alive, screened=screened,
                            infeasible=infeasible)
