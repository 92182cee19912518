"""Pluggable evaluation executors for :class:`ParallelStudy` (a copy of
the JAX package's, with process workers always spawned).

The study owns *what* runs (scheduling, tell order, error draining); an
executor owns *where* objective calls run:

  * :class:`SerialExecutor`  — in the calling thread, one at a time.
    The reference backend: zero concurrency, zero surprises.
  * :class:`ThreadExecutor`  — a thread pool.  Wins when the objective
    blocks (I/O, remote devices); measurements on one device still take
    turns through the generator's measurement gate.
  * :class:`ProcessExecutor` — a ``ProcessPoolExecutor`` of spawned
    workers (CUDA does not survive a fork), each with its own interpreter
    and GIL; measurements on one card take turns across the processes
    through the measurement gate's file lock.
    Objectives must be picklable (module-level functions or callables —
    closures won't cross the process boundary), and each trial ships as
    a picklable payload: the trial number plus the sampler's *detached
    plan* (see :mod:`repro_torch.search.detached`).  Per-trial RNG streams are
    re-derived in the worker from the same ``(seed, number)`` key, so a
    fixed seed yields identical trials on every backend at any worker
    count.  Everything the worker-side trial accumulates — params,
    distributions, user/system attrs, intermediate reports — is merged
    back into the parent's trial before ``tell``.  When the study has a
    (picklable) pruner, every submission also carries a
    :class:`~repro_torch.search.detached.PrunerContext` snapshot and a report
    channel, so doomed trials terminate *inside* the worker.

The primary surface is **streaming**: ``submit(study, objective, trial,
catch)`` schedules one evaluation, ``next_completed()`` blocks for the
next finished one and returns ``(trial, outcome)`` where the outcome is
either ``(values, state)`` or the ``BaseException`` the objective
escaped with — never raised, so the scheduler sees every sibling
result.  ``run_batch`` is a shim over the streaming surface kept for the
batch scheduler and executor-parity tests.  ``cancel_pending()`` pulls
back submissions whose evaluation has not started (the error path uses
it so queued trials don't run — or stay RUNNING — after a failure).
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import queue as queue_module
import shutil
import tempfile
import threading
import traceback
import uuid
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple, Union

from repro_torch import faults
from repro_torch.envvars import read_env
from repro_torch.explorer.registry import EXECUTORS
from repro_torch.search.detached import (
    DetachedSampler,
    DetachedTrial,
    PrunerContext,
)
from repro_torch.search.study import evaluate_trial
from repro_torch.search.trial import Distribution, Trial, TrialState

Outcome = Union[Tuple[Optional[object], TrialState], BaseException]

#: Returned by a completion thunk when the trial was resubmitted (worker
#: death below the quarantine threshold) — ``next_completed`` keeps
#: waiting instead of surfacing it.
RESUBMITTED = object()


# ---------------------------------------------------------------------------
# process-backend payloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerResult:
    """What one out-of-process trial evaluation sends back to the parent."""

    number: int
    values: Optional[object]
    state: TrialState
    params: Dict[str, Any]
    distributions: Dict[str, Distribution]
    user_attrs: Dict[str, Any]
    system_attrs: Dict[str, Any]
    intermediate: Dict[int, float]
    # (context_id, pid, applied_len): which pruner delta-log prefix the
    # worker process holds (see PrunerContext) — lets the parent truncate
    pruner_ack: Optional[Tuple[str, int, int]] = None
    error: Optional[BaseException] = None


def _record_values(values: Any) -> Optional[Tuple[float, ...]]:
    """Normalize a worker's raw objective value(s) to the tuple form
    :class:`~repro_torch.search.detached.TrialRecord` carries."""
    if values is None:
        return None
    if isinstance(values, (tuple, list)):
        try:
            return tuple(float(v) for v in values)
        except (TypeError, ValueError):
            return None
    try:
        return (float(values),)
    except (TypeError, ValueError):
        return None


def _portable_exception(e: BaseException) -> BaseException:
    """Return ``e`` if it survives a pickle round-trip, else a
    ``RuntimeError`` carrying its repr + traceback (the parent re-raises
    whichever comes back)."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:
        return RuntimeError(
            f"unpicklable {type(e).__name__} in process worker: {e}\n"
            + "".join(traceback.format_exception(type(e), e, e.__traceback__))
        )


def run_detached_trial(objective: Callable, number: int, plan: DetachedSampler,
                       catch: Tuple, pruner: Optional[PrunerContext] = None,
                       report_queue: Any = None,
                       params: Optional[Dict[str, Any]] = None,
                       start_dir: Optional[str] = None) -> WorkerResult:
    """Worker entry point: evaluate the objective on a detached trial.
    Uncaught exceptions are *returned* (not raised) so the sampled params
    and attrs collected before the failure still reach the parent.
    ``params`` pre-seeds suggestions already sampled in the parent (the
    cascade's in-parent screening), so the worker evaluates exactly the
    configuration that was screened.  ``start_dir`` is the process
    backend's blame channel: a marker file written *before* the objective
    runs survives a SIGKILL, so on pool breakage the parent knows which
    trials were actually executing (and may be poison) versus merely
    queued (innocent, resubmitted without a strike)."""
    if start_dir is not None:
        try:
            with open(os.path.join(start_dir, str(number)), "w"):
                pass
        except OSError:
            pass  # blame degrades to "unknown": the trial is never struck
    trial = DetachedTrial(number, plan, pruner=pruner, report_queue=report_queue,
                          params=params)
    if pruner is not None:
        # fold the shipped delta slice into this process's history up
        # front, so the ack reflects it even if the objective never
        # reports (and the first should_prune() pays no apply cost)
        pruner.apply()
    error: Optional[BaseException] = None
    try:
        # the worker.trial fault site: `kill` here SIGKILLs this worker
        # process/daemon mid-trial, exactly like an OOM kill would
        faults.fault_point("worker.trial", key=number)
        values, state = evaluate_trial(objective, trial, catch)
    except BaseException as e:  # uncaught objective error
        trial.set_user_attr("error", repr(e))
        values, state = None, TrialState.FAIL
        error = _portable_exception(e)
    return WorkerResult(
        number=number, values=values, state=state, params=trial.params,
        distributions=trial.distributions, user_attrs=trial.user_attrs,
        system_attrs=trial.system_attrs, intermediate=trial.intermediate,
        pruner_ack=pruner.ack() if pruner is not None else None,
        error=error,
    )


def merge_worker_result(study, trial: Trial, res: WorkerResult) -> None:
    """Fold everything a worker-side trial accumulated — params,
    distributions, attrs, intermediate reports — back into the parent's
    trial before ``tell`` (shared by the process and remote backends)."""
    trial.params.update(res.params)
    trial.distributions.update(res.distributions)
    trial.user_attrs.update(res.user_attrs)
    trial.system_attrs.update(res.system_attrs)
    trial.intermediate.update(res.intermediate)
    with study._lock:
        for name, dist in res.distributions.items():
            study.distribution_registry.setdefault(name, dist)


# ---------------------------------------------------------------------------
# pruner delta log (shared by the process + remote backends)
# ---------------------------------------------------------------------------

class PrunerDeltaLog:
    """Parent-side append-only log of pruning history, the O(n)-not-O(n²)
    source for :class:`~repro_torch.search.detached.PrunerContext` snapshots.

    Instead of re-serializing the full intermediate history of every
    trial per submission — O(trials × reports) each time — the parent
    appends streamed ``("report", ...)`` entries and merged ``("final",
    ...)`` terminal records here, and each submission ships only the
    suffix past the prefix every worker has acknowledged holding.
    Workers ack via ``WorkerResult.pruner_ack`` (and, for the remote
    backend, ``refresh_ack`` frames), keyed by a caller-chosen worker
    identity: the worker *pid* for the process pool, the connection's
    worker id for remote daemons (two loopback daemons can share a pid).

    Thread-safe under an internal lock: the process backend only touches
    it from the scheduler thread, but the remote backend's per-connection
    receiver threads append reports and acks concurrently with the
    scheduler's snapshots."""

    def __init__(self):
        self._lock = threading.RLock()
        self._study = None            # study the current context belongs to
        self.context_id: Optional[str] = None
        self._log: List[Tuple] = []
        self._offset = 0              # global index of _log[0]
        self._finalized: set = set()  # trial numbers with a final delta
        self._reported: set = set()   # numbers with streamed, unfinalized reports
        self._acked: Dict[Hashable, int] = {}  # worker key -> applied log length
        self._pruner_ok: Dict[int, Tuple[Any, bool]] = {}  # id -> (pruner, picklable?)

    def clear(self) -> None:
        """Forget the context entirely (executor shutdown: workers died
        with their ``_DELTA_HISTORY``, so a restart must open fresh)."""
        with self._lock:
            self._study = None
            self.context_id = None
            self._log = []
            self._offset = 0
            self._finalized = set()
            self._reported = set()
            self._acked = {}

    def pruner_ok(self, pruner) -> bool:
        """Memoized "does this pruner survive pickling" check (a failure
        degrades that study to no worker-side pruning)."""
        with self._lock:
            # the memo holds a strong reference alongside the verdict:
            # keyed by id() alone, a collected pruner's address could be
            # reused and return the wrong cached answer
            entry = self._pruner_ok.get(id(pruner))
            if entry is not None and entry[0] is pruner:
                return entry[1]
            try:
                pickle.dumps(pruner)
                ok = True
            except Exception:
                ok = False
            self._pruner_ok[id(pruner)] = (pruner, ok)
            return ok

    def reset(self, study) -> None:
        """Open a fresh delta context when the study changes (a reused
        executor), seeding the log with the history visible now."""
        with self._lock:
            if study is self._study:
                return
            self._study = study
            self.context_id = uuid.uuid4().hex
            self._offset = 0
            self._acked = {}
            self._finalized = set()
            self._reported = set()
            self._log = []
            for t in study.trials:
                if t.intermediate:
                    self._log.append(
                        ("final", t.number, t.state, _record_values(t.values),
                         dict(t.intermediate)))
                if t.state != TrialState.RUNNING:
                    self._finalized.add(t.number)

    def add_report(self, number: int, step: int, value: float) -> None:
        """Append one streamed intermediate report."""
        with self._lock:
            if self.context_id is None:
                return
            number = int(number)
            if number in self._finalized:
                return  # the merged terminal record already supersedes these
            self._reported.add(number)
            self._log.append(("report", number, int(step), float(value)))

    def finalize(self, number: int, state: TrialState,
                 values: Any, intermediate: Dict[int, float]) -> None:
        """Append a trial's terminal record, superseding its streamed
        reports (an empty record drops a dead worker's partial values
        from future snapshots)."""
        with self._lock:
            if self.context_id is None or number in self._finalized:
                return
            self._finalized.add(number)
            if intermediate or number in self._reported:
                self._log.append(
                    ("final", number, state, _record_values(values),
                     dict(intermediate)))
            self._reported.discard(number)

    def ack(self, key: Hashable, context_id: Optional[str], applied: int) -> None:
        """Record that worker ``key`` holds the log up to ``applied``."""
        with self._lock:
            if context_id is not None and context_id == self.context_id:
                self._acked[key] = max(self._acked.get(key, 0), int(applied))

    def drop_worker(self, key: Hashable) -> None:
        """Forget a dead worker's ack so truncation tracks the living."""
        with self._lock:
            self._acked.pop(key, None)

    def truncate(self, n_workers: int) -> None:
        """Drop the prefix every one of ``n_workers`` workers has
        acknowledged applying.  Until all have acked at least once,
        everything ships from the context origin — a worker that misses
        a truncated prefix can never prune again for this study (see
        PrunerContext), so truncation waits for proof of delivery."""
        with self._lock:
            if self._acked and len(self._acked) >= n_workers:
                base = max(self._offset, min(self._acked.values()))
                if base > self._offset:
                    del self._log[: base - self._offset]
                    self._offset = base

    def snapshot(self, pruner, directions) -> PrunerContext:
        """A picklable :class:`PrunerContext` of the current log slice
        (copied under the lock: the pickling thread must not race
        appends)."""
        with self._lock:
            return PrunerContext(pruner, directions,
                                 deltas=list(self._log),
                                 base=self._offset,
                                 context_id=self.context_id)

    def tail_for(self, key: Hashable) -> Optional[Tuple[str, int, List[Tuple]]]:
        """The ``(context_id, base, deltas)`` slice worker ``key`` has not
        acknowledged yet, for a mid-trial refresh push — or ``None`` when
        there is no context or nothing new for that worker."""
        with self._lock:
            if self.context_id is None:
                return None
            acked = self._acked.get(key, 0)
            end = self._offset + len(self._log)
            if acked >= end:
                return None
            base = max(self._offset, acked)
            return (self.context_id, base, self._log[base - self._offset:])


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

class _StreamState:
    """Per-executor streaming bookkeeping.  ``pending`` is touched only
    by the scheduler thread; ``done`` is the completion channel fed by
    pool callbacks (or inline, for the serial backend)."""

    def __init__(self):
        self.done: "queue_module.SimpleQueue" = queue_module.SimpleQueue()
        self.pending: Dict[int, Tuple[Trial, Any]] = {}  # number -> (trial, future|None)


class BaseExecutor:
    """Lifecycle: ``start(n_workers)``, any number of ``submit`` /
    ``next_completed`` rounds (or ``run_batch`` calls), then
    ``shutdown()`` (optimize does all of it; an executor instance is
    restartable).  ``start`` on an already-started executor keeps the
    existing pool, so a caller can pre-start (and :meth:`warmup`) an
    executor before handing it to ``optimize``.

    Subclasses implement :meth:`submit`; completions flow through the
    shared stream state via :meth:`_complete`, as ``(trial, thunk)``
    pairs where the thunk — run in the scheduler thread by
    :meth:`next_completed` — produces the final outcome (and, for the
    process backend, merges worker state back into the parent trial).

    ``local_first_trial``: whether :class:`ParallelStudy` evaluates an
    empty study's first trial in the calling process (before the
    executor fans out) or submits it, alone, to the executor.
    """

    name = "base"
    local_first_trial = True

    def _stream(self) -> _StreamState:
        st = getattr(self, "_stream_state", None)
        if st is None:
            st = self._stream_state = _StreamState()
        return st

    def _track(self, trial: Trial, future: Any = None) -> None:
        faults.fault_point("executor.submit", key=trial.number)
        self._stream().pending[trial.number] = (trial, future)

    def _complete(self, trial: Trial, thunk: Callable[[], Outcome]) -> None:
        self._stream().done.put((trial, thunk))

    # -- lifecycle -------------------------------------------------------------

    def start(self, n_workers: int) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def warmup(self, fn: Callable[[], Any]) -> None:
        """Best-effort: run ``fn()`` once per worker so one-time
        per-process costs (interpreter spawn, heavyweight imports, CUDA
        backend init) land before the first measured batch.  In-process
        executors share the parent's modules, so the default is a no-op."""

    # -- streaming surface -----------------------------------------------------

    def submit(self, study, objective: Callable, trial: Trial, catch: Tuple) -> None:
        """Schedule one objective evaluation; returns immediately (the
        serial backend evaluates inline, which is its semantics)."""
        raise NotImplementedError

    def pending_count(self) -> int:
        """Submissions not yet returned by :meth:`next_completed`."""
        return len(self._stream().pending)

    def next_completed(self) -> Tuple[Trial, Outcome]:
        """Block until any in-flight submission finishes; return its
        trial and outcome.  Outcomes are ``(values, state)`` or the
        ``BaseException`` the objective escaped with — never raised, so
        the scheduler's draining error path sees every sibling result."""
        st = self._stream()
        while True:
            if not st.pending:
                raise RuntimeError("next_completed() with no in-flight submissions")
            trial, thunk = st.done.get()
            # identity check, not just number: a cancelled submission's
            # callback still enqueues here, and a stale entry left from a
            # previous optimize round on a reused executor could otherwise
            # collide with a new study's trial of the same number
            entry = st.pending.get(trial.number)
            if entry is None or entry[0] is not trial:
                continue
            st.pending.pop(trial.number)
            outcome = thunk()
            if outcome is RESUBMITTED:
                # a worker death below the quarantine threshold: the
                # thunk re-submitted the trial (it is pending again), so
                # keep waiting for a real completion
                continue
            return trial, outcome

    def cancel_pending(self) -> List[Trial]:
        """Cancel submissions whose evaluation has not started and return
        their trials (the scheduler tells them FAIL with the cancellation
        recorded).  Already-running evaluations keep going — drain them
        with :meth:`next_completed`."""
        st = self._stream()
        cancelled: List[Trial] = []
        for number, (trial, future) in list(st.pending.items()):
            if future is not None and future.cancel():
                st.pending.pop(number, None)
                cancelled.append(trial)
        return cancelled

    # -- batch shim ------------------------------------------------------------

    def run_batch(self, study, objective: Callable, trials: List[Trial],
                  catch: Tuple) -> List[Outcome]:
        """Submit ``trials``, wait for all of them, return outcomes in
        trial order.  The whole batch drains before any outcome is
        surfaced, so sibling results of a failing trial are preserved."""
        for trial in trials:
            self.submit(study, objective, trial, catch)
        outcomes: Dict[int, Outcome] = {}
        for _ in trials:
            trial, outcome = self.next_completed()
            outcomes[trial.number] = outcome
        return [outcomes[t.number] for t in trials]


def _future_outcome(future) -> Outcome:
    try:
        return future.result()
    except BaseException as e:
        return e


@EXECUTORS.register("serial")
class SerialExecutor(BaseExecutor):
    name = "serial"

    def submit(self, study, objective, trial, catch):
        outcome: Outcome
        try:
            outcome = evaluate_trial(objective, trial, catch)
        except BaseException as e:
            outcome = e
        self._track(trial)
        self._complete(trial, lambda outcome=outcome: outcome)


@EXECUTORS.register("thread")
class ThreadExecutor(BaseExecutor):
    name = "thread"

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None

    def start(self, n_workers):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=n_workers)

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def submit(self, study, objective, trial, catch):
        future = self._pool.submit(evaluate_trial, objective, trial, catch)
        self._track(trial, future)
        future.add_done_callback(
            lambda f, trial=trial: self._complete(trial, lambda: _future_outcome(f)))


def numerics_flags() -> Dict[str, Any]:
    """This process's settings that decide how fp32 matrix products and
    convolutions round on CUDA: TF32 for matmuls and for cuDNN, and the
    float32 matmul precision."""
    import torch

    return {"matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def apply_numerics_flags(flags: Dict[str, Any]) -> None:
    """Set :func:`numerics_flags` in this process (a spawned worker's
    initializer).  The precision first: it also sets the matmul flag."""
    import torch

    torch.set_float32_matmul_precision(flags["float32_matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn_allow_tf32"]


@EXECUTORS.register("process")
class ProcessExecutor(BaseExecutor):
    """Evaluate trials in spawned worker processes (a forked child of a
    process that has initialised CUDA cannot use the card, so ``fork`` and
    ``forkserver`` are refused).  When the study has a picklable pruner,
    each submission ships a pruner snapshot + a report channel, so workers
    prune doomed trials themselves (see
    :class:`~repro_torch.search.detached.PrunerContext`)."""

    name = "process"

    def __init__(self, mp_context: str = "spawn",
                 quarantine_after: Optional[int] = None):
        if mp_context != "spawn":
            raise ValueError(
                f"the port's process workers are spawned, not started by "
                f"{mp_context!r}: CUDA does not survive a fork")
        self.mp_context = mp_context
        # worker deaths one trial may be implicated in before it is told
        # FAIL (user_attrs["quarantined"]) instead of resubmitted — a
        # poison trial that OOM-kills every process it lands on must not
        # break the pool for its siblings forever
        self.quarantine_after = (
            quarantine_after if quarantine_after is not None
            else read_env("REPRO_QUARANTINE_DEATHS", 2))
        self._pool: Optional[ProcessPoolExecutor] = None
        self._n_workers = 0
        self._manager = None          # multiprocessing.Manager for the report channel
        self._report_queue = None     # proxy queue workers stream reports into
        self._deaths: Dict[int, int] = {}  # trial number -> implicated deaths
        self._start_dir: Optional[str] = None  # blame markers (see run_detached_trial)
        # append-only pruner-history delta log (see _pruner_context);
        # this backend touches it only from the scheduler thread (submit
        # + next_completed's collect thunks), acks keyed by worker pid
        self._delta = PrunerDeltaLog()

    def start(self, n_workers):
        if self._pool is not None:
            return
        self._pool = self._make_pool(n_workers)
        self._n_workers = n_workers
        if self._start_dir is None:
            self._start_dir = tempfile.mkdtemp(prefix="repro-trial-blame-")

    def _make_pool(self, n_workers: int) -> ProcessPoolExecutor:
        """A pool of spawned workers that start with this process's fp32
        numerics flags (:func:`numerics_flags`): a spawned interpreter
        starts from torch's defaults, which let cuDNN convolutions take TF32,
        so a worker would run other algorithms, with other workspaces and
        values, than the process that spawned it."""
        ctx = multiprocessing.get_context(self.mp_context)
        return ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx,
                                   initializer=apply_numerics_flags,
                                   initargs=(numerics_flags(),))

    def _restart_pool(self, broken: ProcessPoolExecutor) -> None:
        """Replace a broken pool exactly once: the first in-flight future
        to observe the breakage swaps it, siblings (whose ``broken`` ref
        no longer matches) reuse the replacement."""
        if self._pool is not broken:
            return
        try:
            broken.shutdown(wait=False)
        except Exception:
            pass
        self._pool = self._make_pool(self._n_workers)

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._manager is not None:
            self._manager.shutdown()
            self._manager = None
            self._report_queue = None
        if self._start_dir is not None:
            shutil.rmtree(self._start_dir, ignore_errors=True)
            self._start_dir = None
        self._deaths.clear()
        # pool workers died with their _DELTA_HISTORY; a restarted
        # executor must open a fresh context rather than resume this log
        self._delta.clear()

    def warmup(self, fn):
        """Run ``fn`` once per worker.  ``fn`` should be slow enough
        (importing torch qualifies) that every worker process spawns and
        takes one task; a racy double-grab only means one worker warms
        lazily at its first real trial."""
        if self._pool is None:
            return
        for fut in [self._pool.submit(fn) for _ in range(self._n_workers)]:
            fut.result()

    # -- worker-side pruning ---------------------------------------------------

    def _drain_reports(self) -> None:
        """Pull streamed (number, step, value) intermediate reports into
        the delta log consulted by new pruner snapshots."""
        q = self._report_queue
        if q is None:
            return
        while True:
            try:
                number, step, value = q.get_nowait()
            except Exception:  # queue.Empty, or the manager going down
                break
            self._delta.add_report(number, step, value)

    def _pruner_context(self, study) -> Optional[PrunerContext]:
        """Snapshot the pruner + history *slice* for one submission
        (called under the study lock, so siblings' merged state is
        stable).  See :class:`PrunerDeltaLog` for why a delta slice and
        not a full history snapshot."""
        pruner = getattr(study, "pruner", None)
        if pruner is None or not self._delta.pruner_ok(pruner):
            return None
        if self._report_queue is None:
            ctx = multiprocessing.get_context(self.mp_context)
            self._manager = ctx.Manager()
            self._report_queue = self._manager.Queue()
        self._delta.reset(study)
        self._drain_reports()
        self._delta.truncate(self._n_workers)
        return self._delta.snapshot(pruner, study.directions)

    # -- submission ------------------------------------------------------------

    def _merge(self, study, trial: Trial, res: WorkerResult) -> None:
        merge_worker_result(study, trial, res)

    def _blame_marker(self, number: int) -> str:
        return os.path.join(self._start_dir or "", str(number))

    def _worker_death(self, study, objective, trial: Trial, catch,
                      pool: ProcessPoolExecutor, exc: BaseException) -> Outcome:
        """One in-flight future observed pool breakage (a worker process
        was SIGKILLed / OOM-killed / segfaulted).  Restart the pool, then
        either resubmit the trial or — if its blame marker shows it was
        actually *executing* across ``quarantine_after`` deaths —
        quarantine it so a poison trial cannot break the pool forever.
        Trials that were only queued when the pool broke carry no marker
        and are resubmitted without a strike."""
        self._restart_pool(pool)
        marker = self._blame_marker(trial.number)
        implicated = self._start_dir is not None and os.path.exists(marker)
        if implicated:
            self._deaths[trial.number] = deaths = self._deaths.get(trial.number, 0) + 1
            try:
                os.unlink(marker)  # re-arm the marker for the resubmission
            except OSError:
                pass
            if deaths >= self.quarantine_after:
                warnings.warn(
                    f"trial {trial.number} implicated in {deaths} worker "
                    f"death(s); quarantining it instead of resubmitting",
                    RuntimeWarning, stacklevel=2)
                self._delta.finalize(trial.number, TrialState.FAIL, None, {})
                trial.set_user_attr("quarantined", {
                    "deaths": deaths, "error": repr(exc)})
                trial.set_user_attr("error", repr(exc))
                return (None, TrialState.FAIL)
        try:
            self.submit(study, objective, trial, catch)
        except BrokenProcessPool as e:  # replacement pool died instantly
            self._delta.finalize(trial.number, TrialState.FAIL, None, {})
            trial.set_user_attr("error", repr(e))
            return e
        return RESUBMITTED

    def _collect(self, study, objective, trial: Trial, catch,
                 pool: ProcessPoolExecutor, future) -> Outcome:
        try:
            res = future.result()
        except BrokenProcessPool as e:
            return self._worker_death(study, objective, trial, catch, pool, e)
        except BaseException as e:  # payload/result failed to pickle
            # retract any reports the dead worker streamed: no merge
            # happened, so later pruner snapshots must not count its
            # partial values
            self._delta.finalize(trial.number, TrialState.FAIL, None, {})
            trial.set_user_attr("error", repr(e))
            return e
        if self._start_dir is not None:
            try:
                os.unlink(self._blame_marker(trial.number))
            except OSError:
                pass
        self._deaths.pop(trial.number, None)
        self._merge(study, trial, res)
        if res.pruner_ack is not None:
            cid, pid, applied = res.pruner_ack
            self._delta.ack(pid, cid, applied)
        self._delta.finalize(res.number, res.state, res.values, res.intermediate)
        if res.error is not None:
            return res.error
        return (res.values, res.state)

    def submit(self, study, objective, trial, catch):
        with study._lock:
            plan = study.sampler.detached(study, trial)
            pruner_ctx = self._pruner_context(study)
        pool = self._pool
        future = pool.submit(
            run_detached_trial, objective, trial.number, plan, catch,
            pruner=pruner_ctx, report_queue=self._report_queue,
            params=dict(trial.params) or None, start_dir=self._start_dir)
        self._track(trial, future)
        future.add_done_callback(
            lambda f, trial=trial: self._complete(
                trial, lambda: self._collect(study, objective, trial, catch,
                                             pool, f)))


def make_executor(backend: Union[str, BaseExecutor]) -> BaseExecutor:
    """Resolve a backend name through the executor registry ("serial" |
    "thread" | "process" | any plugin key) or pass an instance through.
    Unknown names raise a ValueError listing the registered backends."""
    if isinstance(backend, BaseExecutor):
        return backend
    return EXECUTORS.get(backend)()
