"""Detached sampling: picklable per-trial plans for out-of-process trials.

A ``ProcessExecutor`` worker cannot share the live :class:`Study` with
the parent, so the sampler hands each trial a *detached plan* — a small
picklable object holding everything the worker needs to reproduce the
exact suggestions the in-process sampler would have made:

  * the sampler's base seed, from which the per-trial RNG stream is
    re-derived as ``random.Random(f"{base_seed}/{trial.number}")`` —
    byte-identical to :meth:`BaseSampler.trial_rng`, so a fixed seed
    yields the same parameters at any worker count and on any backend;
  * sampler-specific snapshots taken at ask time under the study lock
    (grid registry, TPE trial records, evolution/NSGA-II parents) —
    exactly the state the threaded path would read during the batch,
    because results are only told *between* batches.

The pure sampling math (grid position, TPE split/pick) lives here and is
called by both the live samplers and the detached plans, so the two
paths cannot drift apart numerically.

``DetachedTrial`` is the worker-side stand-in for :class:`Trial`: same
suggest/report/user-attr surface, no study.  Pruning works through a
:class:`PrunerContext` — a picklable snapshot of the study pruner plus
the intermediate-value history visible at submit time — so
MedianPruner/ASHA terminate doomed trials *inside* the worker instead of
after a full evaluation.  Without a context (no study pruner, or an
unpicklable one) ``should_prune`` returns ``False``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.search.trial import Distribution, TrialState


# ---------------------------------------------------------------------------
# shared sampling math (used by live samplers AND detached plans)
# ---------------------------------------------------------------------------

def grid_value(registry: Dict[str, Distribution], name: str,
               dist: Distribution, number: int) -> Any:
    """Mixed-radix grid position for trial ``number`` (GridSampler's core):
    the cartesian product over the registry's non-float grids is swept in
    sorted-name order.  Registers ``name`` in ``registry`` if unseen."""
    grid = dist.grid()
    registry.setdefault(name, dist)
    radix = 1
    for n in sorted(registry):
        if n == name:
            break
        d = registry[n]
        if d.kind != "float":
            radix *= max(1, len(d.grid()))
    return grid[(number // radix) % len(grid)]


def tpe_split(records: Sequence[Tuple[Dict[str, Any], float]], name: str,
              n_startup: int, gamma: float, sign: float):
    """Split completed-trial ``(params, value)`` records into good/bad
    value lists for ``name`` by the gamma-quantile of ``sign * value``.
    Returns ``(None, None)`` below the startup threshold."""
    done = [(p, v) for p, v in records if name in p]
    if len(done) < n_startup:
        return None, None
    done.sort(key=lambda pv: sign * pv[1])
    n_good = max(1, int(gamma * len(done)))
    gvals = [p[name] for p, _ in done[:n_good]]
    bvals = [p[name] for p, _ in done[n_good:]] or gvals
    return gvals, bvals


def tpe_pick(rng: random.Random, dist: Distribution, gvals: List[Any],
             bvals: List[Any], n_candidates: int) -> Any:
    """Pick the candidate maximizing l(x)/g(x) (kernel density for
    continuous, smoothed counts for categorical)."""
    if dist.kind == "categorical":
        def score(c):
            lg = (gvals.count(c) + 0.5) / (len(gvals) + 0.5 * len(dist.choices))
            lb = (bvals.count(c) + 0.5) / (len(bvals) + 0.5 * len(dist.choices))
            return lg / lb
        return max(dist.choices, key=score)
    # continuous / int: KDE with Scott bandwidth over candidates
    lo, hi = float(dist.low), float(dist.high)
    width = max(hi - lo, 1e-12)

    def kde(vals, x):
        bw = max(1.06 * width * len(vals) ** -0.2, width / 50)
        return sum(math.exp(-0.5 * ((x - v) / bw) ** 2) for v in vals) / (len(vals) * bw)

    cands = [dist.random(rng) for _ in range(n_candidates)]
    best = max(cands, key=lambda x: (kde(gvals, x) + 1e-12) / (kde(bvals, x) + 1e-12))
    if dist.kind == "int":
        best = dist.snap_int(best)
    return best


# ---------------------------------------------------------------------------
# detached plans
# ---------------------------------------------------------------------------

class DetachedSampler:
    """Base plan: pure random from the per-trial RNG stream.  This is the
    correct detachment for ``RandomSampler`` and the fallback any sampler
    inherits; samplers that consult study state must override
    :meth:`BaseSampler.detached` to snapshot what they need."""

    def __init__(self, base_seed: int):
        self.base_seed = base_seed

    def rng(self, trial) -> random.Random:
        r = getattr(trial, "_sampler_rng", None)
        if r is None:
            r = random.Random(f"{self.base_seed}/{trial.number}")
            trial._sampler_rng = r
        return r

    def sample(self, trial, name: str, dist: Distribution) -> Any:
        return dist.random(self.rng(trial))


class DetachedGrid(DetachedSampler):
    """Grid plan: a snapshot of the distribution registry at ask time.
    Parameters registered only inside the worker extend the local copy
    (best-effort sweep order, exactly like a resumed serial study)."""

    def __init__(self, base_seed: int, registry: Dict[str, Distribution]):
        super().__init__(base_seed)
        self.registry = dict(registry)

    def sample(self, trial, name, dist):
        if dist.kind == "float":
            return dist.random(self.rng(trial))
        return grid_value(self.registry, name, dist, trial.number)


class DetachedTPE(DetachedSampler):
    """TPE plan: the completed-trial records visible at ask time (the
    threaded path sees the same set — tells only happen between batches)."""

    def __init__(self, base_seed: int, records, gamma: float,
                 n_candidates: int, n_startup: int, sign: float):
        super().__init__(base_seed)
        self.records = records  # shared, read-only batch snapshot
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup = n_startup
        self.sign = sign

    def sample(self, trial, name, dist):
        rng = self.rng(trial)
        gvals, bvals = tpe_split(self.records, name, self.n_startup, self.gamma, self.sign)
        if gvals is None:
            return dist.random(rng)
        return tpe_pick(rng, dist, gvals, bvals, self.n_candidates)


class DetachedEvolution(DetachedSampler):
    """Regularized-evolution plan: the parent configuration and mutation
    set precomputed for this trial at ``on_trial_start``."""

    def __init__(self, base_seed: int, parent: Optional[Dict[str, Any]], mutated):
        super().__init__(base_seed)
        self.parent = dict(parent) if parent is not None else None
        self.mutated = set(mutated)

    def sample(self, trial, name, dist):
        if self.parent is None or name not in self.parent or name in self.mutated:
            return dist.random(self.rng(trial))
        return self.parent[name]


class DetachedNSGA2(DetachedSampler):
    """NSGA-II plan: the crossover child precomputed for this trial plus
    the per-parameter mutation probability."""

    def __init__(self, base_seed: int, parent: Optional[Dict[str, Any]], mutation_p: float):
        super().__init__(base_seed)
        self.parent = dict(parent) if parent is not None else None
        self.mutation_p = mutation_p

    def sample(self, trial, name, dist):
        rng = self.rng(trial)
        if self.parent is None or name not in self.parent or self.parent[name] is None:
            return dist.random(rng)
        if rng.random() < self.mutation_p:
            return dist.perturb(rng, self.parent[name])
        return self.parent[name]


# ---------------------------------------------------------------------------
# worker-side pruning
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrialRecord:
    """One study trial's pruning-relevant history, picklable: exactly the
    attributes the shipped pruners read (``state``, ``intermediate``,
    ``values``).  A custom pruner touching anything else on a study trial
    raises inside :meth:`PrunerContext.should_prune`, which degrades to
    "don't prune" rather than killing the worker trial."""

    state: TrialState
    intermediate: Dict[int, float]
    values: Optional[Tuple[float, ...]] = None


class StudyView:
    """Minimal study stand-in handed to a pruner inside a worker: the
    ``directions`` tuple plus ``trials`` as :class:`TrialRecord`s."""

    def __init__(self, directions: Tuple[str, ...], trials: List[TrialRecord]):
        self.directions = directions
        self.trials = trials


# Per-worker-process pruning history, keyed by the parent's context id:
# ``context_id -> (applied_len, {trial_number: TrialRecord})``.  Each
# PrunerContext ships only the delta-log *tail* the parent hasn't seen
# this process acknowledge yet; :meth:`PrunerContext.apply` folds it in
# idempotently, so a worker evaluating its 50th trial re-applies nothing
# it already holds.  One entry at a time — a new context id (new study /
# restarted executor) evicts the old history.
_DELTA_HISTORY: Dict[str, Tuple[int, Dict[int, TrialRecord]]] = {}


def _fold_deltas(records: Dict[int, TrialRecord], deltas) -> None:
    """Fold delta-log entries into ``records`` **in place** — every live
    :class:`PrunerContext` holding a reference to the dict sees the new
    history on its next ``should_prune`` call."""
    for delta in deltas:
        if delta[0] == "report":
            _, number, step, value = delta
            rec = records.get(number)
            if rec is None:
                rec = records[number] = TrialRecord(TrialState.RUNNING, {})
            rec.intermediate[int(step)] = float(value)
        else:  # "final" — terminal record supersedes streamed reports
            _, number, state, values, intermediate = delta
            records[number] = TrialRecord(state, dict(intermediate), values)


def apply_pruner_deltas(context_id: str, base: int, deltas) -> int:
    """Mid-trial refresh entry point: fold a delta-log tail starting at
    log offset ``base`` into this process's history for ``context_id``
    and return the resulting ``applied_len`` (the refresh ack).

    Because the fold mutates the shared records dict in place, a trial
    *already running* in this process — whose :class:`PrunerContext`
    applied an earlier slice of the same context — sees the refreshed
    sibling population on its very next ``should_prune`` call, letting
    long trials prune against history that did not exist when they were
    submitted.  Entries before the stored ``applied_len`` are skipped
    (idempotent, same as :meth:`PrunerContext.apply`); a tail starting
    past what this process holds is ignored — the gap cannot be
    reconstructed, so the stale ack tells the sender to stop truncating
    past us.

    Thread-safety: the folding thread (a worker's receive loop) races
    benignly with trial threads reading the dict — CPython dict ops are
    atomic, records are never deleted, and a pruner that trips over a
    concurrently-growing ``intermediate`` dict is caught by
    ``should_prune``'s degrade-to-no-prune guard."""
    applied, records = _DELTA_HISTORY.get(context_id, (0, {}))
    deltas = list(deltas or ())
    if applied < base:
        return applied  # missed prefix: unusable, report what we hold
    _fold_deltas(records, deltas[applied - base:])
    applied = max(applied, base + len(deltas))
    _DELTA_HISTORY[context_id] = (applied, records)
    return applied


class PrunerContext:
    """Picklable pruning snapshot shipped with a detached plan.

    Holds the study's pruner instance, its directions, and the
    intermediate-value history visible when the trial was submitted —
    completed trials plus whatever sibling workers have streamed back so
    far.  The decision is therefore *asynchronous* in the ASHA sense:
    based on a slightly stale rung population, never waiting on the
    parent.  MedianPruner and SuccessiveHalvingPruner read only what
    :class:`TrialRecord` carries, so they run unchanged.

    Two wire formats:

    * ``records`` — a full history snapshot.  Simple, but re-serializes
      every intermediate value of every trial on every submission
      (O(n²) over a study).  Kept for direct construction in tests and
      third-party executors.
    * ``deltas`` + ``base`` + ``context_id`` — an incremental slice of
      the parent's append-only delta log, starting at log offset
      ``base``.  Entries are ``("report", number, step, value)`` for a
      streamed intermediate report and ``("final", number, state,
      values, intermediate)`` for a merged-back terminal record (which
      supersedes that trial's streamed reports).  Workers accumulate the
      log in process-local :data:`_DELTA_HISTORY` and acknowledge how
      much they hold via :meth:`ack`, letting the parent truncate the
      prefix every worker has applied and ship only tails.  A worker
      that missed a truncated prefix (e.g. a replacement process joining
      mid-study) cannot reconstruct the population, so it degrades to
      "don't prune" rather than decide on partial history."""

    def __init__(self, pruner: Any, directions: Tuple[str, ...],
                 records: Optional[List[TrialRecord]] = None, *,
                 deltas: Optional[List[Tuple]] = None, base: int = 0,
                 context_id: Optional[str] = None):
        self.pruner = pruner
        self.directions = tuple(directions)
        self.records = records
        self.deltas = deltas
        self.base = int(base)
        self.context_id = context_id
        self._applied: Optional[Tuple[int, Optional[Dict[int, TrialRecord]]]] = None

    def apply(self) -> None:
        """Worker-side: fold this context's delta slice into the
        process-local history.  Idempotent — entries this process already
        applied (per the stored ``applied_len``) are skipped."""
        if self._applied is not None or self.context_id is None:
            return
        for stale in [k for k in _DELTA_HISTORY if k != self.context_id]:
            del _DELTA_HISTORY[stale]
        applied, records = _DELTA_HISTORY.get(self.context_id, (0, {}))
        if applied < self.base:
            # this process missed a truncated log prefix: the sibling
            # population can't be reconstructed, so degrade to no-prune
            # (ack the stale applied_len — the parent's min() over acks
            # then stops truncating past what this process holds)
            self._applied = (applied, None)
            return
        _fold_deltas(records, (self.deltas or [])[applied - self.base:])
        applied = max(applied, self.base + len(self.deltas or ()))
        _DELTA_HISTORY[self.context_id] = (applied, records)
        self._applied = (applied, records)

    def ack(self) -> Optional[Tuple[str, int, int]]:
        """``(context_id, pid, applied_len)`` for the worker result —
        tells the parent which log prefix this worker process durably
        holds, so it can truncate what *every* worker has applied.
        ``None`` for a legacy full-snapshot context."""
        if self.context_id is None:
            return None
        self.apply()
        return (self.context_id, os.getpid(), self._applied[0])

    def _history(self) -> Optional[List[TrialRecord]]:
        if self.context_id is None:
            return list(self.records or [])
        self.apply()
        records = self._applied[1]
        if records is None:  # degraded: missed a truncated prefix
            return None
        return [records[n] for n in sorted(records) if records[n].intermediate]

    def should_prune(self, trial: "DetachedTrial") -> bool:
        if not trial.intermediate:
            return False
        history = self._history()
        if history is None:
            return False
        # the live path sees the asking trial inside study.trials too
        # (ASHA counts its own rung value), so mirror that here
        view = StudyView(
            self.directions,
            history + [TrialRecord(TrialState.RUNNING, trial.intermediate)],
        )
        try:
            return bool(self.pruner.prune(view, trial))
        except Exception:
            # a pruner that needs more study state than the snapshot
            # carries must not crash the trial — run it to completion
            return False


# ---------------------------------------------------------------------------
# worker-side trial
# ---------------------------------------------------------------------------

class DetachedTrial:
    """Worker-side stand-in for :class:`Trial`: the same suggestion
    surface, backed by a :class:`DetachedSampler` plan instead of a live
    study.  Everything it accumulates (params, distributions, attrs,
    intermediate reports) is merged back into the real trial by the
    executor when the worker returns.  ``report`` additionally streams
    each intermediate value to ``report_queue`` (when the executor
    provides one) so the parent — and through it, later submissions'
    pruner snapshots — see sibling progress before the trial finishes.

    ``params`` pre-seeds suggestions the parent already sampled (the
    fidelity cascade samples in-parent to screen a cohort before
    promoting survivors to workers): ``_suggest`` returns a seeded value
    instead of re-deriving it, so the worker reuses the exact screened
    configuration."""

    def __init__(self, number: int, sampler: DetachedSampler,
                 pruner: Optional[PrunerContext] = None,
                 report_queue: Any = None,
                 params: Optional[Dict[str, Any]] = None):
        self.number = number
        self.params: Dict[str, Any] = dict(params) if params else {}
        self.distributions: Dict[str, Distribution] = {}
        self.intermediate: Dict[int, float] = {}
        self.user_attrs: Dict[str, Any] = {}
        self.system_attrs: Dict[str, Any] = {}
        self._sampler = sampler
        self._pruner = pruner
        self._report_queue = report_queue

    def _suggest(self, name: str, dist: Distribution) -> Any:
        if name in self.params:
            return self.params[name]
        value = self._sampler.sample(self, name, dist)
        self.params[name] = value
        self.distributions[name] = dist
        return value

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._suggest(name, Distribution("categorical", choices=tuple(choices)))

    def suggest_int(self, name: str, low: int, high: int, step: int = 1, log: bool = False) -> int:
        return int(self._suggest(name, Distribution("int", low=low, high=high, step=step, log=log)))

    def suggest_float(self, name: str, low: float, high: float, log: bool = False) -> float:
        return float(self._suggest(name, Distribution("float", low=low, high=high, log=log)))

    def report(self, step: int, value: float) -> None:
        self.intermediate[int(step)] = float(value)
        if self._report_queue is not None:
            try:
                self._report_queue.put_nowait((self.number, int(step), float(value)))
            except Exception:
                # best-effort streaming: a full/closed channel only makes
                # sibling snapshots staler, it must not fail the trial
                pass

    def should_prune(self) -> bool:
        if self._pruner is None:
            # no pruner shipped (study has none, or it didn't pickle)
            return False
        return self._pruner.should_prune(self)

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value

    @property
    def value(self) -> Optional[float]:
        return None
