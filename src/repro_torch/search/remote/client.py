"""Client-side worker-pool plumbing shared by the remote executor and
the sweep-cell scheduler (the JAX package's ``search/remote/client.py``
on the port).

:class:`RemoteClient` owns everything between "a list of host:port
strings" and "call this function when the task finishes": connecting +
handshaking each address (unreachable or rejecting workers are warned
about and dropped), one receiver thread per connection, task dispatch
to idle workers with a FIFO overflow queue, and the fault-tolerance
discipline the acceptance tests pin down:

* **failure detection** — a connection error, EOF, a worker silent past
  ``heartbeat_timeout_s`` (daemons heartbeat every couple of seconds),
  or a task running past ``task_timeout_s`` (straggler; off by default)
  all declare the worker lost;
* **bounded resubmission** — a lost worker's in-flight task is re-built
  (``make_payload`` runs per attempt, so retried trials carry *fresh*
  pruner snapshots) and resubmitted to a sibling, up to ``retries``
  extra attempts.  This is safe for trials because detached plans are
  deterministic: the retry reproduces the original parameters exactly.
  Retries exhausted — or the last live worker gone — surface as an
  error through the task's completion callback, never as an exception
  on a pool thread.

Completion callbacks run on receiver threads; callers route them into
their own completion channel (the executor's stream state, the sweep
scheduler's queue) and must not block in them.
"""
from __future__ import annotations

import collections
import pickle
import random
import threading
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.envvars import read_env
from repro_torch.search.remote import transport
from repro_torch.search.remote.transport import (
    Connection,
    HandshakeError,
    TransportError,
)

TIMEOUT_ENV = "REPRO_REMOTE_TIMEOUT_S"
RETRIES_ENV = "REPRO_REMOTE_RETRIES"
DEFAULT_HEARTBEAT_TIMEOUT_S = 10.0
DEFAULT_RETRIES = 2

_monotonic = time.monotonic  # stubable in tests

# reconnect backoff for rejoin-enabled pools: exponential from the base
# up to the cap, each sleep jittered so a restarted pool's clients don't
# thundering-herd one daemon socket
REJOIN_BACKOFF_BASE_S = 0.2
REJOIN_BACKOFF_CAP_S = 5.0

# (context_id, base, deltas) — what a pruner-refresh push ships
RefreshTail = Tuple[str, int, List[Tuple]]


class PoisonTrialError(RuntimeError):
    """A task was implicated in ``quarantine_after`` worker deaths: the
    evidence says the task itself kills workers (OOM, a segfault in
    a kernel), so resubmitting it anywhere would drain the pool.  The
    executor converts this into a quarantined FAIL for the trial."""

    def __init__(self, message: str, deaths: int):
        super().__init__(message)
        self.deaths = deaths


class RemoteTask:
    """One submitted unit of work.  ``cancel()`` implements the
    future-like protocol :meth:`BaseExecutor.cancel_pending` expects:
    only tasks not yet assigned to a worker cancel."""

    def __init__(self, key: Any, make_payload: Callable[[], bytes],
                 on_done: Callable[[Any, Any, Optional[BaseException],
                                    Optional[str]], None]):
        self.key = key
        self.make_payload = make_payload
        self.on_done = on_done
        self.attempts = 0
        self.deaths = 0  # workers lost while running this task
        self.task_id: Optional[str] = None  # fresh per attempt
        self.worker: Optional["_Worker"] = None
        self.done = False
        self.cancelled = False
        self._client: Optional["RemoteClient"] = None

    def cancel(self) -> bool:
        client = self._client
        return client is not None and client._cancel(self)


class _Worker:
    """Client-side view of one connected daemon."""

    def __init__(self, addr: str, conn: Connection, worker_id: str):
        self.addr = addr          # the pool-unique key callers see
        self.conn = conn
        self.worker_id = worker_id
        self.alive = True
        self.busy: Optional[RemoteTask] = None
        self.started = 0.0        # when the current task was assigned
        self.last_seen = _monotonic()
        self.last_refresh = 0.0
        self.tasks_done = 0


class RemoteClient:
    """See module docstring.  Callbacks (all optional, all invoked
    outside the pool lock):

    * ``on_report(worker_addr, meta)`` — a streamed intermediate report;
    * ``on_refresh_ack(worker_addr, context_id, applied)`` — a worker
      acknowledged a mid-trial pruner refresh;
    * ``on_worker_lost(worker_addr, reason)`` — bookkeeping hook (the
      executor drops the worker's delta-log ack entry)."""

    def __init__(self, addrs: List[str], *,
                 retries: Optional[int] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 task_timeout_s: Optional[float] = None,
                 connect_timeout_s: float = 5.0,
                 refresh_min_interval_s: float = 0.25,
                 quarantine_after: Optional[int] = None,
                 rejoin: bool = False,
                 on_report: Optional[Callable] = None,
                 on_refresh_ack: Optional[Callable] = None,
                 on_worker_lost: Optional[Callable] = None):
        self.addrs = [str(a) for a in addrs]
        for addr in self.addrs:
            transport.parse_addr(addr)  # fail fast on malformed config
        self.retries = (read_env(RETRIES_ENV, DEFAULT_RETRIES)
                        if retries is None else max(0, int(retries)))
        self.heartbeat_timeout_s = (
            read_env(TIMEOUT_ENV, DEFAULT_HEARTBEAT_TIMEOUT_S)
            if heartbeat_timeout_s is None else float(heartbeat_timeout_s))
        self.task_timeout_s = task_timeout_s
        self.connect_timeout_s = float(connect_timeout_s)
        self.refresh_min_interval_s = float(refresh_min_interval_s)
        # None disables quarantine at this layer: retry exhaustion stays
        # the client's only give-up path (the executor layers quarantine
        # on top with its own default)
        self.quarantine_after = (None if quarantine_after is None
                                 else max(1, int(quarantine_after)))
        self.rejoin = bool(rejoin)
        self.on_report = on_report
        self.on_refresh_ack = on_refresh_ack
        self.on_worker_lost = on_worker_lost
        self._lock = threading.Lock()
        self._workers: List[_Worker] = []
        self._queue: "collections.deque[RemoteTask]" = collections.deque()
        self._threads: List[threading.Thread] = []
        self._rejoining: Set[str] = set()  # addrs with a redial thread up
        self._wake = threading.Event()     # set at close: aborts backoff sleeps
        self._closing = False

    # -- pool lifecycle --------------------------------------------------------

    def connect(self) -> List[str]:
        """Connect + handshake every address; returns the addresses that
        made it into the pool.  Failures warn and are skipped — zero
        live workers is the *caller's* degradation decision."""
        for addr in self.addrs:
            self._connect_addr(addr)
        return self.live_workers()

    def _connect_addr(self, addr: str, quiet: bool = False) -> Optional["_Worker"]:
        """Connect + handshake one address and start its receiver thread.
        ``quiet`` suppresses the per-failure warnings (the rejoin loop
        retries for minutes and must not spam)."""
        try:
            conn = transport.connect(addr, timeout=self.connect_timeout_s)
        except OSError as e:
            if not quiet:
                warnings.warn(f"remote worker {addr} unreachable ({e}); skipping",
                              RuntimeWarning, stacklevel=3)
            return None
        try:
            hello = transport.client_hello(conn, timeout=self.connect_timeout_s)
        except (HandshakeError, TransportError) as e:
            conn.close()
            if not quiet:
                warnings.warn(f"remote worker {addr} rejected the handshake: {e}",
                              RuntimeWarning, stacklevel=3)
            return None
        worker = _Worker(addr, conn, str(hello.get("worker", addr)))
        with self._lock:
            if self._closing:
                conn.close()
                return None
            self._workers.append(worker)
        t = threading.Thread(target=self._recv_loop, args=(worker,),
                             daemon=True, name=f"repro-remote-recv-{addr}")
        t.start()
        self._threads.append(t)
        return worker

    # -- rejoin (dynamic pool membership) --------------------------------------

    def _start_rejoin(self, addr: str) -> None:
        """Begin redialing a lost worker's address on a background
        thread, with exponential backoff + jitter; on success the daemon
        re-enters the pool and queued work starts flowing to it."""
        with self._lock:
            if self._closing or addr in self._rejoining:
                return
            self._rejoining.add(addr)
        t = threading.Thread(target=self._rejoin_loop, args=(addr,),
                             daemon=True, name=f"repro-remote-rejoin-{addr}")
        t.start()
        self._threads.append(t)

    def _rejoin_loop(self, addr: str) -> None:
        delay = REJOIN_BACKOFF_BASE_S
        try:
            while not self._closing:
                # jittered sleep: simultaneous rejoiners (a whole pool
                # restarting) spread out instead of herding one socket
                self._wake.wait(delay * random.uniform(0.5, 1.5))
                if self._closing:
                    return
                worker = self._connect_addr(addr, quiet=True)
                if worker is not None:
                    warnings.warn(f"remote worker {addr} rejoined the pool",
                                  RuntimeWarning, stacklevel=2)
                    self._pump()
                    return
                delay = min(delay * 2.0, REJOIN_BACKOFF_CAP_S)
        finally:
            with self._lock:
                self._rejoining.discard(addr)

    def live_workers(self) -> List[str]:
        with self._lock:
            return [w.addr for w in self._workers if w.alive]

    def close(self) -> None:
        self._closing = True
        self._wake.set()  # abort rejoin backoff sleeps
        with self._lock:
            workers = list(self._workers)
            self._workers = []
            self._queue.clear()
        for w in workers:
            try:
                w.conn.send("bye")
            except TransportError:
                pass
            w.conn.close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    # -- task dispatch ---------------------------------------------------------

    def submit(self, key: Any, make_payload: Callable[[], bytes],
               on_done: Callable[[Any, Any, Optional[BaseException],
                                  Optional[str]], None]
               ) -> RemoteTask:
        """Queue one task; ``on_done(key, value, error, worker_addr)``
        fires exactly once from a receiver thread (or inline here when
        the pool is already dead) — ``worker_addr`` names the worker
        that produced a result, ``None`` on client-side failures."""
        task = RemoteTask(key, make_payload, on_done)
        task._client = self
        with self._lock:
            # a rejoin-enabled pool that is mid-reconnect holds the task
            # (the rejoin loop pumps the queue when a daemon redials);
            # only a pool with no way back fails inline
            healing = self.rejoin and bool(self._rejoining) and not self._closing
            if not any(w.alive for w in self._workers) and not healing:
                task.done = True
                dead = RuntimeError(
                    "no live remote workers (all lost or never connected)")
            else:
                dead = None
                self._queue.append(task)
        if dead is not None:
            on_done(key, None, dead, None)
            return task
        self._pump()
        return task

    def pending_count(self) -> int:
        with self._lock:
            queued = sum(1 for t in self._queue if not t.done)
            running = sum(1 for w in self._workers if w.alive and w.busy is not None)
            return queued + running

    def _cancel(self, task: RemoteTask) -> bool:
        with self._lock:
            if task.done or task.worker is not None:
                return False
            task.cancelled = True
            task.done = True
            try:
                self._queue.remove(task)
            except ValueError:
                pass
            return True

    def _pump(self) -> None:
        """Move queued tasks onto idle live workers.  Runs on whatever
        thread noticed capacity (submit, a completion, a worker loss);
        concurrent pumps are safe — assignment happens under the lock."""
        while True:
            with self._lock:
                worker = next((w for w in self._workers
                               if w.alive and w.busy is None), None)
                if worker is None or not self._queue:
                    return
                task = self._queue.popleft()
                if task.done or task.cancelled:
                    continue
                task.attempts += 1
                task.task_id = uuid.uuid4().hex
                task.worker = worker
                worker.busy = task
                worker.started = _monotonic()
                tid = task.task_id
            try:
                payload = task.make_payload()
            except BaseException as e:
                # the payload itself cannot be built (unpicklable
                # objective, say): permanent, no retry will help
                with self._lock:
                    worker.busy = None
                    task.worker = None
                    task.done = True
                task.on_done(task.key, None, e, None)
                continue
            try:
                worker.conn.send("submit", {"task": tid}, payload)
            except TransportError as e:
                self._worker_lost(worker, f"send failed: {e}")

    # -- receiving -------------------------------------------------------------

    def _recv_loop(self, w: _Worker) -> None:
        poll = 0.2
        while w.alive and not self._closing:
            try:
                msg = w.conn.recv(timeout=poll)
            except TransportError as e:
                if not self._closing:
                    self._worker_lost(w, str(e) or type(e).__name__)
                    self._pump()
                return
            now = _monotonic()
            if msg is None:
                if (self.heartbeat_timeout_s
                        and now - w.last_seen > self.heartbeat_timeout_s):
                    self._worker_lost(
                        w, f"silent for {now - w.last_seen:.1f}s "
                           f"(heartbeat timeout {self.heartbeat_timeout_s}s)")
                    self._pump()
                    return
                if (self.task_timeout_s and w.busy is not None
                        and now - w.started > self.task_timeout_s):
                    self._worker_lost(
                        w, f"straggler: task running past {self.task_timeout_s}s")
                    self._pump()
                    return
                continue
            w.last_seen = now
            if msg.kind == "heartbeat":
                w.tasks_done = int(msg.meta.get("tasks_done", w.tasks_done))
            elif msg.kind == "report":
                if self.on_report is not None:
                    self.on_report(w.addr, msg.meta)
            elif msg.kind == "refresh_ack":
                if self.on_refresh_ack is not None:
                    self.on_refresh_ack(w.addr, msg.meta.get("context"),
                                        int(msg.meta.get("applied", 0)))
            elif msg.kind in ("result", "error"):
                self._finish(w, msg)
                self._pump()
            elif msg.kind == "shutdown":
                # graceful daemon exit (SIGTERM): resubmit its in-flight
                # work *now* instead of waiting out the heartbeat timeout
                self._worker_lost(w, "worker announced shutdown")
                self._pump()
                return
            # "ack" and unknown kinds: liveness signal only

    def _finish(self, w: _Worker, msg) -> None:
        with self._lock:
            task = w.busy
            if task is None or task.task_id != msg.meta.get("task"):
                return  # stale frame from a superseded attempt
            w.busy = None
            task.done = True
        value = error = None
        try:
            obj = pickle.loads(msg.payload)
            if msg.kind == "error":
                error = obj
            else:
                value = obj
        except BaseException as e:
            error = RuntimeError(f"undecodable result from {w.addr}: {e!r}")
        w.tasks_done += 1
        task.on_done(task.key, value, error, w.addr)

    # -- failure handling ------------------------------------------------------

    def _worker_lost(self, w: _Worker, reason: str) -> None:
        """Retire a worker and re-route its in-flight task.  Callers
        follow up with :meth:`_pump`."""
        to_fail: List[Tuple[RemoteTask, BaseException]] = []
        with self._lock:
            if not w.alive:
                return
            w.alive = False
            self._workers.remove(w)
            task = w.busy
            w.busy = None
            any_alive = any(x.alive for x in self._workers)
            if task is not None and not task.done:
                task.worker = None
                task.deaths += 1
                if (self.quarantine_after is not None
                        and task.deaths >= self.quarantine_after):
                    # the common factor across these deaths is the task:
                    # stop feeding it workers.  Checked before pool state
                    # on purpose — a poison task that just took down the
                    # last worker is still a poison task, not a pool
                    # outage
                    task.done = True
                    to_fail.append((task, PoisonTrialError(
                        f"task implicated in {task.deaths} worker death(s) "
                        f"(last: {w.addr}, {reason}); quarantined",
                        deaths=task.deaths)))
                elif task.attempts > self.retries:
                    task.done = True
                    to_fail.append((task, RuntimeError(
                        f"task failed after {task.attempts} attempts; last "
                        f"worker {w.addr} lost ({reason})")))
                elif not any_alive and not self.rejoin:
                    task.done = True
                    to_fail.append((task, RuntimeError(
                        f"worker {w.addr} lost ({reason}) and no live workers "
                        f"remain to resubmit to")))
                else:
                    # a sibling is alive, or rejoin will heal the pool
                    self._queue.appendleft(task)
            if not any_alive and not self.rejoin:
                # total pool loss with no way back: every queued task can
                # only fail (rejoin-enabled pools hold the queue instead
                # and drain it when a daemon redials)
                while self._queue:
                    queued = self._queue.popleft()
                    if queued.done:
                        continue
                    queued.done = True
                    to_fail.append((queued, RuntimeError(
                        f"worker {w.addr} lost ({reason}); no live workers "
                        f"remain")))
        w.conn.close()
        warnings.warn(
            f"remote worker {w.addr} lost ({reason})"
            + ("; resubmitting its in-flight work to a sibling"
               if not to_fail else ""),
            RuntimeWarning, stacklevel=2)
        if self.on_worker_lost is not None:
            self.on_worker_lost(w.addr, reason)
        for task, err in to_fail:
            task.on_done(task.key, None, err, None)
        if self.rejoin and not self._closing:
            self._start_rejoin(w.addr)

    # -- mid-trial pruner refresh ---------------------------------------------

    def push_refresh(self, make_tail: Callable[[str], Optional[RefreshTail]]
                     ) -> None:
        """Ship unacknowledged pruner delta-log tails to workers that are
        *currently running* a trial (throttled per worker), so long
        trials prune against sibling history that postdates their
        submission.  ``make_tail(worker_addr)`` returns ``(context_id,
        base, deltas)`` or ``None`` when that worker is up to date."""
        now = _monotonic()
        with self._lock:
            targets = [w for w in self._workers
                       if w.alive and w.busy is not None
                       and now - w.last_refresh >= self.refresh_min_interval_s]
        for w in targets:
            tail = make_tail(w.addr)
            if tail is None:
                continue
            context_id, base, deltas = tail
            try:
                w.conn.send("pruner_refresh",
                            {"context": context_id, "base": int(base)},
                            pickle.dumps(deltas, protocol=pickle.HIGHEST_PROTOCOL))
                w.last_refresh = now
            except TransportError:
                pass  # the receiver loop will notice and handle the death
