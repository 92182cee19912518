"""ParallelStudy: concurrent trial evaluation — sliding-window or batch.

A copy of the JAX package's ``search/parallel.py``.  Hardware-in-the-loop
NAS is embarrassingly parallel across candidates — each objective call is
dominated by building, placing and measuring the candidate — and that
cost is highly *skewed*.  ``ParallelStudy`` keeps the exact ask/tell
surface and storage format of :class:`Study` but overlaps objective
evaluation on a pluggable executor backend
(:mod:`repro_torch.search.executors`) under one of two schedulers:

``schedule="sliding_window"`` (the fast path)
    Completion-driven: a new trial is asked the moment a slot frees and
    results are told as evaluations finish — no barrier, so workers
    never idle behind a straggler.  ``tell_order`` controls the tell
    stream:

      * ``"trial"`` (default) — a small reorder buffer defers each tell
        until every earlier trial has finished, so the JSONL storage and
        the study's completed-set evolve in exactly trial order (what
        the batch scheduler and a serial study produce);
      * ``"completion"`` — tell immediately.  Fastest and freshest (the
        pruner/history view lags nothing), at the price of a
        run-dependent storage order.  ``study.trials`` stays in trial
        order either way, and with a stateless sampler the sampled
        parameters and values are identical under both.

    ``window`` bounds in-flight submissions (default: ``n_workers``); a
    larger window keeps pool queues fed at the cost of asking further
    ahead of the tells.

``schedule="batch"`` (the legacy scheduler)
    Trials are asked ``n_workers`` at a time and every batch waits on
    its slowest member before any new trial is asked.  Population-based
    samplers see population snapshots at deterministic batch boundaries,
    so their trajectory is reproducible for a fixed ``n_workers`` and
    seed on every backend.

``schedule="auto"`` (the default) picks per sampler:
``sliding_window`` when the sampler declares itself
``order_independent`` (Random, Grid — suggestions derive from per-trial
RNG streams / the trial number alone, so a fixed seed yields identical
trials under either scheduler, any backend, any worker count), and
``batch`` for history-consulting samplers (TPE/evolution/NSGA-II),
whose sliding-window trajectory would depend on completion timing.

Determinism: with a stateless sampler (Random/Grid) and a deterministic
objective, every scheduler, backend and ``n_workers`` produce identical
trial parameters and identical best values.  The first trial of an
empty study runs synchronously so GridSampler's distribution registry
is complete before workers fan out (spaces whose parameter set varies
per trial — deeply conditional DSL spaces — can still register
parameters late, in which case Grid's sweep order is best-effort,
exactly as in a resumed serial study).

Timeouts: ``optimize(..., timeout_s=...)`` enforces the budget
per-submission under the sliding window (no new trial is submitted past
the deadline; in-flight ones drain) and per-batch under the batch
scheduler.

Error path: an uncaught objective exception stops new submissions,
**cancels** queued-but-not-started submissions (told FAIL with the
cancellation recorded in ``user_attrs["cancelled"]``), drains the
already-running evaluations (their results are told and persisted), and
then re-raises — no trial is ever left RUNNING.

Backend choice: ``thread`` (default) when the objective blocks without
holding the GIL (wall-clock benchmarking, remote devices); ``process``
when the objective's host work is the bound — each spawned worker process
has its own interpreter (measurements on one card still take turns
through the generator's measurement gate).
``process`` requires a picklable objective; with a picklable pruner it
prunes *worker-side* from submit-time snapshots (see
:mod:`repro_torch.search.detached`).

Generation-ring screening (``optimize(..., screen=..., cohort=N)``)
    The fidelity-cascade scheduling mode: trials are asked a *cohort* at
    a time and handed — still RUNNING, parameters sampled in-parent — to
    the ``screen`` callable, which ranks them with cheap zero-cost /
    analytic stages and returns a :class:`ScreenDecision`.  Trials cut by
    a keep rule are told :attr:`TrialState.SCREENED` immediately (with
    ``user_attrs["fidelity_stage"]`` naming the cutting stage) and
    **never reach a worker**; hard-constraint casualties are told
    INFEASIBLE the same way; survivors are promoted to the executor under
    the selected schedule (batch or sliding window).  Because screening
    samples every parameter in the parent, the usual synchronous first
    trial is unnecessary — the distribution registry is complete before
    any worker sees a trial.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional, Tuple, Union

from repro_torch.search.executors import BaseExecutor, evaluate_trial, make_executor
from repro_torch.search.study import Study
from repro_torch.search.trial import Trial, TrialState

SCHEDULE_MODES = ("auto", "batch", "sliding_window")
TELL_ORDERS = ("trial", "completion")
DEFAULT_COHORT = 16  # generation size when screening without an explicit cohort

# Clock used for timeout enforcement; module-level so tests can stub it.
_monotonic = time.monotonic


def _check_choice(value: str, allowed: Tuple[str, ...], what: str) -> str:
    if value not in allowed:
        raise ValueError(f"unknown {what} {value!r}; expected one of {allowed}")
    return value


@dataclasses.dataclass
class ScreenDecision:
    """What a ``screen`` callable decided about one cohort of RUNNING
    trials: ``promoted`` go to the executor; ``screened`` are told
    SCREENED (with the stage that cut them); ``infeasible`` are told
    INFEASIBLE (a screening-stage hard constraint, carried as the
    :class:`~repro_torch.search.study.HardConstraintViolated` it raised)."""

    promoted: List[Trial]
    screened: List[Tuple[Trial, str]] = dataclasses.field(default_factory=list)
    infeasible: List[Tuple[Trial, str, BaseException]] = dataclasses.field(default_factory=list)


class ParallelStudy(Study):
    """A Study whose ``optimize`` evaluates objectives concurrently."""

    def __init__(self, *args, n_workers: int = 4,
                 backend: Union[str, BaseExecutor] = "thread",
                 schedule: str = "auto", tell_order: str = "trial",
                 window: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.default_n_workers = max(1, int(n_workers))
        self.default_backend = backend
        self.default_schedule = _check_choice(schedule, SCHEDULE_MODES, "schedule")
        self.default_tell_order = _check_choice(tell_order, TELL_ORDERS, "tell_order")
        self.default_window = None if window is None else max(1, int(window))

    # -- scheduling helpers ----------------------------------------------------

    def _resolve_schedule(self, schedule: Optional[str]) -> str:
        mode = _check_choice(schedule if schedule is not None else self.default_schedule,
                             SCHEDULE_MODES, "schedule")
        if mode == "auto":
            return ("sliding_window"
                    if getattr(self.sampler, "order_independent", False) else "batch")
        return mode

    def _tell_outcome(self, trial: Trial, outcome) -> None:
        if isinstance(outcome, BaseException):
            trial.set_user_attr("error", repr(outcome))
            self.tell(trial, None, TrialState.FAIL)
        else:
            values, state = outcome
            self.tell(trial, values, state)

    # -- optimize --------------------------------------------------------------

    def optimize(self, objective: Callable[[Trial], object], n_trials: int,
                 n_workers: Optional[int] = None, catch: Tuple = (),
                 backend: Optional[Union[str, BaseExecutor]] = None,
                 schedule: Optional[str] = None,
                 tell_order: Optional[str] = None,
                 window: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 screen: Optional[Callable[[List[Trial]], ScreenDecision]] = None,
                 cohort: Optional[int] = None) -> None:
        workers = max(1, int(n_workers if n_workers is not None else self.default_n_workers))
        executor = make_executor(backend if backend is not None else self.default_backend)
        mode = self._resolve_schedule(schedule)
        order = _check_choice(tell_order if tell_order is not None else self.default_tell_order,
                              TELL_ORDERS, "tell_order")
        win = window if window is not None else self.default_window
        win = max(1, int(win)) if win is not None else workers
        deadline = None if timeout_s is None else _monotonic() + float(timeout_s)
        remaining = int(n_trials)
        coh = max(1, int(cohort)) if cohort is not None else DEFAULT_COHORT

        if screen is None:
            # Evaluate the first trial synchronously: it registers the
            # space's distributions (GridSampler's mixed-radix bookkeeping)
            # and warms shared caches before workers fan out, so concurrent
            # trials see a complete registry regardless of scheduling order.
            # (The ring path skips this — screening samples every parameter
            # in the parent before anything is submitted.)
            # An executor whose workers live elsewhere (``remote``) gets
            # the first trial alone, and the study waits for it: where it
            # runs changes nothing, since detached plans re-derive every
            # suggestion from (seed, number).
            if remaining > 0 and not self.trials:
                trial = self.ask()
                if executor.local_first_trial:
                    values, state = evaluate_trial(objective, trial, catch)
                    self.tell(trial, values, state)
                else:
                    self._first_trial_through(executor, workers, objective,
                                              trial, catch)
                remaining -= 1

        if remaining <= 0 or (deadline is not None and _monotonic() >= deadline):
            if not executor.local_first_trial:
                executor.shutdown()  # started for the first trial
            return
        executor.start(workers)
        try:
            if screen is not None:
                if mode == "batch":
                    self._ring_batch(objective, remaining, catch, executor,
                                     deadline, screen, coh)
                else:
                    self._ring_sliding(objective, remaining, catch, executor,
                                       order, win, deadline, screen, coh)
            elif mode == "batch":
                self._optimize_batch(objective, remaining, workers, catch,
                                     executor, deadline)
            else:
                self._optimize_sliding(objective, remaining, catch, executor,
                                       order, win, deadline)
        finally:
            executor.shutdown()

    def _first_trial_through(self, executor, workers, objective, trial,
                             catch) -> None:
        """Evaluate ``trial`` on ``executor`` and tell it before anything
        else is submitted; an uncaught error is told as FAIL and raised,
        with the executor shut down, as a local first trial's would be."""
        executor.start(workers)
        try:
            executor.submit(self, objective, trial, catch)
            trial, outcome = executor.next_completed()
            self._tell_outcome(trial, outcome)
        except BaseException:
            executor.shutdown()
            raise
        if isinstance(outcome, BaseException):
            executor.shutdown()
            raise outcome

    # -- batch scheduler (legacy) ----------------------------------------------

    def _optimize_batch(self, objective, remaining, workers, catch, executor,
                        deadline) -> None:
        while remaining > 0:
            if deadline is not None and _monotonic() >= deadline:
                return
            batch = [self.ask() for _ in range(min(workers, remaining))]
            # The executor drains the whole batch before surfacing any
            # uncaught objective exception: the sibling evaluations
            # already ran, so their results must be told (and persisted)
            # rather than silently discarded, leaving trials stranded as
            # RUNNING.
            outcomes = executor.run_batch(self, objective, batch, catch)
            # tell in trial order — outcomes are ordered like the batch,
            # so storage appends and sampler population updates are
            # deterministic even when evaluations finish out of order
            error: Optional[BaseException] = None
            for trial, outcome in zip(batch, outcomes):
                if isinstance(outcome, BaseException):
                    error = error or outcome
                self._tell_outcome(trial, outcome)
            if error is not None:
                raise error
            remaining -= len(batch)

    # -- sliding-window scheduler ----------------------------------------------

    def _optimize_sliding(self, objective, remaining, catch, executor,
                          tell_order, window, deadline) -> None:
        pending_tells = {}  # number -> (trial, outcome), tell_order="trial" only
        tell_cursor: Optional[int] = None  # next trial number owed a tell
        error: Optional[BaseException] = None
        stop_submitting = False

        def flush_tells():
            nonlocal tell_cursor
            while tell_cursor in pending_tells:
                trial, outcome = pending_tells.pop(tell_cursor)
                self._tell_outcome(trial, outcome)
                tell_cursor += 1

        def handle(trial, outcome):
            nonlocal error
            if isinstance(outcome, BaseException):
                error = error or outcome
            if tell_order == "trial":
                pending_tells[trial.number] = (trial, outcome)
                flush_tells()
            else:
                self._tell_outcome(trial, outcome)

        while True:
            # fill the window — the deadline is checked before EVERY
            # submission, so a timeout can never overshoot by a batch
            while (error is None and not stop_submitting and remaining > 0
                   and executor.pending_count() < window):
                if deadline is not None and _monotonic() >= deadline:
                    stop_submitting = True
                    break
                trial = self.ask()
                if tell_cursor is None:
                    tell_cursor = trial.number
                executor.submit(self, objective, trial, catch)
                remaining -= 1
            if executor.pending_count() == 0:
                break
            trial, outcome = executor.next_completed()
            handle(trial, outcome)
            if error is not None:
                # pull back whatever hasn't started; running trials keep
                # draining through next_completed above
                for cancelled in executor.cancel_pending():
                    cancelled.set_user_attr(
                        "cancelled",
                        f"submission cancelled: trial {trial.number} raised "
                        f"{type(error).__name__}")
                    handle(cancelled, (None, TrialState.FAIL))
        # every submission completed or was cancelled, so with
        # tell_order="trial" the buffer has flushed; sweep defensively in
        # number order in case a gap ever slipped through
        for number in sorted(pending_tells):
            trial, outcome = pending_tells.pop(number)
            self._tell_outcome(trial, outcome)
        if error is not None:
            raise error

    # -- generation-ring schedulers (fidelity cascade) ---------------------------

    def _screen_and_tell(self, screen, trials: List[Trial]) -> List[Trial]:
        """Run ``screen`` over one asked cohort and resolve everything it
        rejected: screened trials are told SCREENED, screening-stage hard
        constraint casualties INFEASIBLE (mirroring
        :func:`~repro_torch.search.study.evaluate_trial`'s ``violated`` attr),
        both carrying ``fidelity_stage``.  Survivors come back still
        RUNNING, tagged ``fidelity_stage="promoted"``, for the executor.
        A screen that *raises* fails the whole cohort (no trial may stay
        RUNNING) and re-raises."""
        try:
            decision = screen(trials)
        except BaseException as e:
            for t in trials:
                if t.state == TrialState.RUNNING:
                    t.set_user_attr("error", f"screen raised: {e!r}")
                    self.tell(t, None, TrialState.FAIL)
            raise
        for t, stage in decision.screened:
            t.set_user_attr("fidelity_stage", stage)
            self.tell(t, None, TrialState.SCREENED)
        for t, stage, exc in decision.infeasible:
            t.set_user_attr("fidelity_stage", stage)
            t.set_user_attr("violated", {
                "name": getattr(exc, "name", None),
                "value": getattr(exc, "value", None),
                "limit": getattr(exc, "limit", None)})
            self.tell(t, None, TrialState.INFEASIBLE)
        for t in decision.promoted:
            t.set_user_attr("fidelity_stage", "promoted")
        return list(decision.promoted)

    def _fail_unsubmitted(self, queued, reason: str) -> None:
        """Trials that survived screening but never reached the executor
        (deadline hit, or a sibling error stopped submissions) must not
        stay RUNNING — tell them FAIL with the cancellation recorded,
        exactly like cancelled executor submissions."""
        for t in queued:
            t.set_user_attr("cancelled", reason)
            self._tell_outcome(t, (None, TrialState.FAIL))

    def _ring_batch(self, objective, remaining, catch, executor, deadline,
                    screen, cohort) -> None:
        while remaining > 0:
            if deadline is not None and _monotonic() >= deadline:
                return
            trials = [self.ask() for _ in range(min(cohort, remaining))]
            remaining -= len(trials)
            promoted = self._screen_and_tell(screen, trials)
            if not promoted:
                continue  # whole cohort screened out — ask the next one
            outcomes = executor.run_batch(self, objective, promoted, catch)
            error: Optional[BaseException] = None
            for trial, outcome in zip(promoted, outcomes):
                if isinstance(outcome, BaseException):
                    error = error or outcome
                self._tell_outcome(trial, outcome)
            if error is not None:
                raise error

    def _ring_sliding(self, objective, remaining, catch, executor, tell_order,
                      window, deadline, screen, cohort) -> None:
        """Sliding window over screened survivors: refill by asking +
        screening a cohort whenever the survivor queue runs dry, submit up
        to ``window`` in flight.  With ``tell_order="trial"`` the reorder
        buffer keys by *submission sequence* (trial numbers have gaps
        where cohort-mates were screened out), so storage appends evolve
        in promotion order."""
        queue: "collections.deque[Trial]" = collections.deque()
        pending_tells = {}  # submission seq -> (trial, outcome)
        seq_of = {}         # trial number -> submission seq
        next_seq = 0
        tell_cursor = 0
        error: Optional[BaseException] = None
        stop_submitting = False

        def flush_tells():
            nonlocal tell_cursor
            while tell_cursor in pending_tells:
                trial, outcome = pending_tells.pop(tell_cursor)
                self._tell_outcome(trial, outcome)
                tell_cursor += 1

        def handle(trial, outcome):
            nonlocal error
            if isinstance(outcome, BaseException):
                error = error or outcome
            if tell_order == "trial":
                pending_tells[seq_of[trial.number]] = (trial, outcome)
                flush_tells()
            else:
                self._tell_outcome(trial, outcome)

        while True:
            # refill the survivor queue — a cohort can be screened out
            # entirely, so keep asking until survivors appear or the
            # budget/deadline runs out
            while (error is None and not stop_submitting and remaining > 0
                   and not queue):
                if deadline is not None and _monotonic() >= deadline:
                    stop_submitting = True
                    break
                trials = [self.ask() for _ in range(min(cohort, remaining))]
                remaining -= len(trials)
                try:
                    queue.extend(self._screen_and_tell(screen, trials))
                except BaseException as e:
                    error = error or e
            # fill the window from the survivor queue
            while (error is None and not stop_submitting and queue
                   and executor.pending_count() < window):
                if deadline is not None and _monotonic() >= deadline:
                    stop_submitting = True
                    break
                trial = queue.popleft()
                seq_of[trial.number] = next_seq
                next_seq += 1
                executor.submit(self, objective, trial, catch)
            if error is not None:
                for cancelled in executor.cancel_pending():
                    cancelled.set_user_attr(
                        "cancelled",
                        f"submission cancelled: a sibling raised "
                        f"{type(error).__name__}")
                    handle(cancelled, (None, TrialState.FAIL))
            if executor.pending_count() == 0:
                break
            trial, outcome = executor.next_completed()
            handle(trial, outcome)
        for seq in sorted(pending_tells):
            trial, outcome = pending_tells.pop(seq)
            self._tell_outcome(trial, outcome)
        if queue:
            self._fail_unsubmitted(
                queue, "submission cancelled: "
                + ("deadline reached before submission" if error is None
                   else f"a sibling raised {type(error).__name__}"))
        if error is not None:
            raise error
