""":class:`RemoteExecutor` — the streaming executor surface over a pool
of worker daemons (the JAX package's ``search/remote/executor.py`` on
the port).

Registry-pluggable (``executor: {backend: remote, workers:
["host:7471", ...]}`` in an experiment YAML just works), and
semantically a sibling of the process backend: every submission ships
the trial number, the sampler's picklable detached plan, and (when the
study has a picklable pruner) a :class:`PrunerContext` slice of the
shared :class:`~repro_torch.search.executors.PrunerDeltaLog`; everything a
worker-side trial accumulates merges back into the parent trial before
``tell``.  Because detached plans re-derive per-trial RNG streams from
``(seed, number)``, a fixed-seed study produces identical trials on the
remote backend as on serial — the property the parity tests and the
bounded-resubmission fault story both rest on.

What this class adds over :class:`RemoteClient` (which owns
connections, dispatch, failure detection, and retries):

* the delta-log bookkeeping — streamed ``report`` frames append to the
  log, worker acks (result-borne and refresh-borne) advance truncation,
  a lost worker's ack entry is dropped so truncation tracks the living;
* **mid-trial pruner refreshes**: after every report and every merged
  completion, unacknowledged log tails are pushed to workers still
  running trials, so a long trial prunes against sibling history that
  did not exist when it was submitted;
* **graceful degradation**: when zero configured workers are reachable
  at ``start()``, the executor warns once and delegates the entire
  surface to a local backend (``fallback``, default ``process``) — a
  cluster outage degrades a run to single-host speed, not to a crash.
  The fallback runs where the trials would have (``trial_device``, which
  the Explorer sets to its target's device): a candidate of a CUDA target
  is still measured on this host's card, never on its CPU, and a host
  without a card raises :class:`~repro_torch.device.NoCudaCardError`
  naming the unreachable workers.

Worker configuration precedence: the ``workers`` constructor argument
(what ``executor.workers`` in a spec feeds), else the
``REPRO_REMOTE_WORKERS`` environment list; neither set raises at
``start``.
"""
from __future__ import annotations

import pickle
import warnings
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.envvars import read_env
from repro_torch.explorer.registry import EXECUTORS
from repro_torch.search.executors import (
    BaseExecutor,
    Outcome,
    PrunerDeltaLog,
    WorkerResult,
    make_executor,
    merge_worker_result,
)
from repro_torch.search.remote.client import PoisonTrialError, RemoteClient
from repro_torch.search.trial import Trial, TrialState

WORKERS_ENV = "REPRO_REMOTE_WORKERS"


@EXECUTORS.register("remote")
class RemoteExecutor(BaseExecutor):
    name = "remote"
    # the pool runs every trial, the first included: the submitting host
    # need not be able to evaluate one (see ParallelStudy.optimize)
    local_first_trial = False

    def __init__(self, workers: Optional[List[str]] = None,
                 retries: Optional[int] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 task_timeout_s: Optional[float] = None,
                 connect_timeout_s: float = 5.0,
                 fallback: str = "process",
                 quarantine_after: Optional[int] = None,
                 rejoin: bool = True):
        self.workers = [str(w) for w in workers] if workers else None
        self.retries = retries
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.task_timeout_s = task_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.fallback = fallback
        # a trial implicated in this many worker deaths is a poison
        # trial: quarantined as FAIL instead of burning the whole pool
        self.quarantine_after = (quarantine_after
                                 if quarantine_after is not None
                                 else read_env("REPRO_QUARANTINE_DEATHS", 2))
        self.rejoin = rejoin
        # the device the trials run on, which the local fallback needs here
        # (None: whatever the fallback's objective asks for)
        self.trial_device: Optional[str] = None
        self._client: Optional[RemoteClient] = None
        self._delegate: Optional[BaseExecutor] = None
        self._delta = PrunerDeltaLog()

    # -- lifecycle -------------------------------------------------------------

    def start(self, n_workers: int) -> None:
        if self._client is not None or self._delegate is not None:
            return
        addrs = self.workers or read_env(WORKERS_ENV, None)
        if not addrs:
            raise ValueError(
                "the remote executor needs a worker pool: pass "
                "workers=['host:port', ...], set executor.workers in the "
                "experiment spec, or export REPRO_REMOTE_WORKERS")
        client = RemoteClient(
            list(addrs),
            retries=self.retries,
            heartbeat_timeout_s=self.heartbeat_timeout_s,
            task_timeout_s=self.task_timeout_s,
            connect_timeout_s=self.connect_timeout_s,
            quarantine_after=self.quarantine_after,
            rejoin=self.rejoin,
            on_report=self._on_report,
            on_refresh_ack=self._on_refresh_ack,
            on_worker_lost=self._on_worker_lost)
        live = client.connect()
        if not live:
            client.close()
            self._check_fallback_device(list(addrs))
            warnings.warn(
                f"no remote workers reachable among {list(addrs)}; degrading "
                f"to local {self.fallback!r} execution for this run",
                RuntimeWarning, stacklevel=2)
            self._delegate = make_executor(self.fallback)
            self._delegate.start(n_workers)
            return
        self._client = client

    def _check_fallback_device(self, addrs: List[str]) -> None:
        """Raise if this host cannot run the trials the pool would have:
        a CUDA target's, on a host without a card."""
        if self.trial_device is None:
            return
        from repro_torch.device import NoCudaCardError, resolve_device

        try:
            resolve_device(self.trial_device)
        except NoCudaCardError as e:
            raise NoCudaCardError(
                f"no remote workers reachable among {addrs}, and this host cannot "
                f"run the trials in their place ({e}): start the daemons, or run "
                f"on a host with a card") from e

    def shutdown(self) -> None:
        if self._delegate is not None:
            self._delegate.shutdown()
            self._delegate = None
        if self._client is not None:
            self._client.close()
            self._client = None
        # the daemons outlive us, but their _DELTA_HISTORY context does
        # not match any future study of ours: open fresh next time
        self._delta.clear()

    def warmup(self, fn: Callable[[], Any]) -> None:
        """Run ``fn`` once per live worker (daemons already warm torch,
        CUDA and the kernels at startup; this warms *caller* state such as
        objective globals)."""
        if self._delegate is not None:
            return self._delegate.warmup(fn)
        if self._client is None:
            return
        import threading

        events = []
        payload = pickle.dumps(("call", (fn, (), {})),
                               protocol=pickle.HIGHEST_PROTOCOL)
        for addr in self._client.live_workers():
            ev = threading.Event()
            self._client.submit(addr, lambda payload=payload: payload,
                                lambda *a, ev=ev: ev.set())
            events.append(ev)
        for ev in events:
            ev.wait(timeout=60.0)

    # -- streaming surface -----------------------------------------------------

    def pending_count(self) -> int:
        if self._delegate is not None:
            return self._delegate.pending_count()
        return super().pending_count()

    def next_completed(self) -> Tuple[Trial, Outcome]:
        if self._delegate is not None:
            return self._delegate.next_completed()
        return super().next_completed()

    def cancel_pending(self) -> List[Trial]:
        if self._delegate is not None:
            return self._delegate.cancel_pending()
        return super().cancel_pending()

    def submit(self, study, objective: Callable, trial: Trial, catch: Tuple) -> None:
        if self._delegate is not None:
            return self._delegate.submit(study, objective, trial, catch)
        with study._lock:
            plan = study.sampler.detached(study, trial)
            pruner = getattr(study, "pruner", None)
            use_pruner = pruner is not None and self._delta.pruner_ok(pruner)
            if use_pruner:
                self._delta.reset(study)
        params = dict(trial.params) or None

        def make_payload() -> bytes:
            # built per dispatch *attempt*, so a resubmitted trial
            # carries a pruner snapshot that includes everything learned
            # since the first attempt
            ctx = None
            if use_pruner:
                self._delta.truncate(len(self._client.live_workers()))
                ctx = self._delta.snapshot(pruner, study.directions)
            return pickle.dumps(
                ("trial", {"objective": objective, "number": trial.number,
                           "plan": plan, "catch": tuple(catch), "pruner": ctx,
                           "params": params}),
                protocol=pickle.HIGHEST_PROTOCOL)

        def on_done(key, value, error, worker_addr):
            # receiver thread: hand the merge to the scheduler thread via
            # the stream state, mirroring the process backend's _collect
            self._complete(trial, lambda: self._collect(
                study, trial, value, error, worker_addr))

        task = self._client.submit(trial, make_payload, on_done)
        self._track(trial, task)

    # -- completion + delta-log bookkeeping ------------------------------------

    def _collect(self, study, trial: Trial, value, error, worker_addr) -> Outcome:
        if isinstance(error, PoisonTrialError):
            # the trial itself keeps killing daemons — quarantine it as a
            # FAIL with forensics, and let its siblings finish the study
            self._delta.finalize(trial.number, TrialState.FAIL, None, {})
            warnings.warn(
                f"trial {trial.number} implicated in {error.deaths} worker "
                f"death(s); quarantining", RuntimeWarning, stacklevel=2)
            trial.set_user_attr(
                "quarantined", {"deaths": error.deaths, "error": repr(error)})
            trial.set_user_attr("error", repr(error))
            return (None, TrialState.FAIL)
        if error is not None or not isinstance(value, WorkerResult):
            # worker lost beyond retries, undecodable result, or payload
            # build failure: retract any reports the attempts streamed so
            # later pruner snapshots don't count partial values
            self._delta.finalize(trial.number, TrialState.FAIL, None, {})
            if error is None:
                error = RuntimeError(
                    f"remote worker returned {type(value).__name__}, "
                    f"expected WorkerResult")
            trial.set_user_attr("error", repr(error))
            return error
        res = value
        merge_worker_result(study, trial, res)
        if res.pruner_ack is not None and worker_addr is not None:
            cid, _pid, applied = res.pruner_ack
            self._delta.ack(worker_addr, cid, applied)
        self._delta.finalize(res.number, res.state, res.values, res.intermediate)
        self._push_refresh()
        if res.error is not None:
            return res.error
        return (res.values, res.state)

    def _on_report(self, worker_addr: str, meta) -> None:
        self._delta.add_report(meta.get("number"), meta.get("step"),
                               meta.get("value"))
        self._push_refresh()

    def _on_refresh_ack(self, worker_addr: str, context_id, applied: int) -> None:
        self._delta.ack(worker_addr, context_id, applied)

    def _on_worker_lost(self, worker_addr: str, reason: str) -> None:
        self._delta.drop_worker(worker_addr)

    def _push_refresh(self) -> None:
        """Ship unacked delta-log tails to busy workers (throttled inside
        the client), so running trials see fresh sibling history."""
        client = self._client
        if client is not None and self._delta.context_id is not None:
            client.push_refresh(self._delta.tail_for)
