"""The worker daemon behind ``python -m repro_torch.worker`` (the JAX
package's ``search/remote/worker.py`` on the port).

One :class:`WorkerServer` accepts any number of client connections
(each a :class:`~repro_torch.search.remote.executor.RemoteExecutor` or
:class:`~repro_torch.search.remote.client.RemoteClient`), handshakes them
(protocol version, toolchain salt and fp32 numerics flags, see
:mod:`repro_torch.search.remote.transport`), and then serves two task
kinds:

* ``("trial", {...})`` — a detached-plan trial evaluation: exactly the
  payload the process backend ships to a pool worker (objective,
  trial number, plan, catch tuple, optional
  :class:`~repro_torch.search.detached.PrunerContext`, pre-seeded params),
  executed by the same :func:`~repro_torch.search.executors.run_detached_trial`
  entry point.  Intermediate reports stream back as ``report`` frames
  while the trial runs, so the submitting host's pruner snapshots see
  this worker's progress before the trial finishes; the terminal
  ``result`` frame carries the pickled
  :class:`~repro_torch.search.executors.WorkerResult` (including the pruner
  delta-log ack).
* ``("call", (fn, args, kwargs))`` — a generic picklable call; the
  sweep-cell scheduler uses it to run whole experiment cells.

Control frames: every ``submit`` is acknowledged with an ``ack`` before
execution starts (delivery confirmation for the client's retry logic);
a ``heartbeat`` frame goes out every ``heartbeat_s`` seconds on each
live connection (the client's liveness signal); ``pruner_refresh``
frames fold a delta-log tail into this process's pruning history *while
trials are running* — see :func:`repro_torch.search.detached.apply_pruner_deltas`
— and are answered with ``refresh_ack``; ``cancel`` suppresses the
result of a task that has not finished (execution itself is not
interrupted — objectives are arbitrary code); ``bye`` closes cleanly.

Tasks run on their own threads so the receive loop keeps servicing
refreshes and cancels mid-trial.  Trials from different connections may
therefore run concurrently; on one card their measurements still take
turns through the generator's measurement gate (a lock file per card,
shared with every other process measuring there).  Grad mode is per
thread in torch, and a task thread starts with it on: the generator and
the timings run candidates under ``inference_mode`` themselves.

The fp32 numerics flags (TF32 for matmuls and cuDNN, the float32 matmul
precision) are global to the process, so the daemon takes them from the
client that connects while no other is connected, and rejects a client
whose flags differ from those of a live connection.  A daemon started
by hand otherwise runs torch's defaults, under which cuDNN takes TF32.

The device: ``--device cuda`` (the default) refuses to start on a
machine without a card; ``--device cpu`` hides the cards from the
process before torch starts, so the daemon never starts CUDA and a task
that asks for it fails with the device's own error.
"""
from __future__ import annotations

import argparse
import os
import pickle
import random
import signal
import socket
import threading
import time
import uuid
from typing import Any, Dict, Optional, Set, Tuple

from repro_torch.envvars import read_env
from repro_torch.search.detached import apply_pruner_deltas
from repro_torch.search.executors import _portable_exception, run_detached_trial
from repro_torch.search.remote import transport
from repro_torch.search.remote.transport import Connection, ConnectionClosed, TransportError

HEARTBEAT_ENV = "REPRO_REMOTE_HEARTBEAT_S"
DEFAULT_HEARTBEAT_S = 2.0


class DropConnection(Exception):
    """Raised by a task hook to make the daemon sever the client's
    connection without sending a result — the test seam for
    deterministic worker-death scenarios."""


class _WireReportQueue:
    """Duck-typed report channel for :class:`DetachedTrial`: each
    ``put_nowait((number, step, value))`` becomes a ``report`` frame.
    Send failures propagate to the caller, which already treats report
    streaming as best-effort."""

    def __init__(self, conn: Connection, task_id: str):
        self._conn = conn
        self._task_id = task_id

    def put_nowait(self, item: Tuple[int, int, float]) -> None:
        number, step, value = item
        self._conn.send("report", {"task": self._task_id, "number": int(number),
                                   "step": int(step), "value": float(value)})


class WorkerServer:
    """One listening daemon.  ``start()`` runs the accept loop on a
    background thread (tests embed servers in-process; ``port=0`` binds
    an ephemeral port), ``serve_forever()`` blocks (the CLI path),
    ``stop()`` severs everything.

    ``heartbeat_s=0`` disables heartbeats and ``task_hook`` (called as
    ``hook(task_id, task)`` before execution) may raise
    :class:`DropConnection` — both are failure-injection seams used by
    the fault-tolerance tests."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_s: Optional[float] = None,
                 worker_id: Optional[str] = None,
                 toolchain: Optional[Dict[str, str]] = None,
                 task_hook: Any = None):
        self.host = host
        self.port = int(port)
        if heartbeat_s is None:
            heartbeat_s = read_env(HEARTBEAT_ENV, DEFAULT_HEARTBEAT_S)
        self.heartbeat_s = float(heartbeat_s)
        self.worker_id = worker_id or f"worker-{uuid.uuid4().hex[:8]}"
        self._toolchain = toolchain
        self._task_hook = task_hook
        self._listener: Optional[socket.socket] = None
        self._stopping = threading.Event()
        self._threads: list = []
        self._conns: Set[Connection] = set()
        self._flags: Dict[Connection, Dict[str, Any]] = {}  # accepted conns' flags
        self._lock = threading.Lock()
        self.tasks_done = 0

    # -- lifecycle -------------------------------------------------------------

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> Tuple[str, int]:
        """Bind + listen, accept on a background thread; returns the
        bound (host, port) — with ``port=0`` the OS picks one."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self.port))
        listener.listen(16)
        listener.settimeout(0.25)  # so the accept loop notices stop()
        self.port = listener.getsockname()[1]
        self._listener = listener
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"repro-worker-accept-{self.port}")
        t.start()
        self._threads.append(t)
        return self.host, self.port

    def serve_forever(self) -> None:
        """CLI entry: start (if needed) and block until stopped.  The wait
        wakes ten times a second: a signal sent to the process may land on
        any of its threads (torch and CUDA start several), and Python runs
        the handler only when the main thread next runs, which an unbounded
        wait on a lock would never let it do (a daemon on the card ignored
        SIGTERM for a minute that way)."""
        if self._listener is None:
            self.start()
        while not self._stopping.wait(0.1):
            pass

    def announce_shutdown(self) -> None:
        """Send a ``shutdown`` frame on every live connection so clients
        resubmit this daemon's in-flight work *immediately* instead of
        waiting out the heartbeat timeout.  Best-effort: a connection
        that cannot take the frame will be noticed the slow way."""
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.send("shutdown", {"worker": self.worker_id})
            except TransportError:
                pass

    def stop(self) -> None:
        self._stopping.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            conn.close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    # -- serving ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by stop()
            conn = Connection(sock)
            with self._lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_client, args=(conn,),
                                 daemon=True, name="repro-worker-client")
            t.start()
            self._threads.append(t)

    def _heartbeat_loop(self, conn: Connection) -> None:
        while not self._stopping.is_set() and not conn.closed:
            # ±20% jitter: a pool of daemons started by one job script
            # would otherwise heartbeat in lockstep and burst the
            # client's receive loops at the same instant
            if self._stopping.wait(self.heartbeat_s * random.uniform(0.8, 1.2)):
                return
            try:
                conn.send("heartbeat", {"worker": self.worker_id,
                                        "tasks_done": self.tasks_done})
            except TransportError:
                return

    def _admit_numerics(self, conn: Connection, flags: Any) -> Optional[str]:
        """The client's fp32 numerics flags become this process's, unless
        a live connection runs under other flags; returns the reason to
        reject, or ``None``."""
        if not isinstance(flags, dict):
            return (f"numerics flags missing from the hello ({flags!r}): this "
                    f"worker runs fp32 products under its clients' flags")
        from repro_torch.search.executors import apply_numerics_flags, numerics_flags

        with self._lock:
            others = [f for c, f in self._flags.items() if c is not conn]
            if others and others[0] != flags:
                return (f"numerics flags mismatch: client {flags!r}, worker "
                        f"{others[0]!r} (set by a live connection) — the flags "
                        f"are global to the worker process")
            if numerics_flags() != flags:
                apply_numerics_flags(flags)
            self._flags[conn] = dict(flags)
        return None

    def _serve_client(self, conn: Connection) -> None:
        cancelled: Set[str] = set()
        try:
            if not transport.server_hello(
                    conn, self.worker_id, toolchain=self._toolchain,
                    admit_numerics=lambda flags: self._admit_numerics(conn, flags)):
                return
            if self.heartbeat_s > 0:
                hb = threading.Thread(target=self._heartbeat_loop, args=(conn,),
                                      daemon=True, name="repro-worker-heartbeat")
                hb.start()
                self._threads.append(hb)
            while not self._stopping.is_set():
                msg = conn.recv(timeout=0.25)
                if msg is None:
                    continue
                if msg.kind == "submit":
                    task_id = str(msg.meta.get("task", ""))
                    conn.send("ack", {"task": task_id})
                    t = threading.Thread(
                        target=self._run_task,
                        args=(conn, task_id, msg.payload, cancelled),
                        daemon=True, name=f"repro-worker-task-{task_id[:8]}")
                    t.start()
                    self._threads.append(t)
                elif msg.kind == "pruner_refresh":
                    applied = apply_pruner_deltas(
                        str(msg.meta.get("context")), int(msg.meta.get("base", 0)),
                        pickle.loads(msg.payload) if msg.payload else [])
                    conn.send("refresh_ack", {"context": msg.meta.get("context"),
                                              "applied": int(applied)})
                elif msg.kind == "cancel":
                    cancelled.add(str(msg.meta.get("task", "")))
                elif msg.kind == "bye":
                    return
                # unknown kinds are ignored: forward compatibility within
                # one protocol version
        except (ConnectionClosed, TransportError):
            pass  # client went away; nothing to tell it
        finally:
            conn.close()
            with self._lock:
                self._conns.discard(conn)
                self._flags.pop(conn, None)

    def _run_task(self, conn: Connection, task_id: str, payload: bytes,
                  cancelled: Set[str]) -> None:
        try:
            kind, task = pickle.loads(payload)
            if self._task_hook is not None:
                self._task_hook(task_id, task)
            if kind == "trial":
                result = run_detached_trial(
                    task["objective"], task["number"], task["plan"],
                    tuple(task.get("catch") or ()),
                    pruner=task.get("pruner"),
                    report_queue=_WireReportQueue(conn, task_id),
                    params=task.get("params"))
            elif kind == "call":
                fn, args, kwargs = task
                result = fn(*args, **(kwargs or {}))
            else:
                raise ValueError(f"unknown task kind {kind!r}")
            body = pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL)
            reply = ("result", {"task": task_id})
        except DropConnection:
            conn.close()  # simulate sudden worker death (test seam)
            return
        except (ConnectionClosed, TransportError):
            return  # client went away mid-trial; result has no recipient
        except BaseException as e:
            body = pickle.dumps(_portable_exception(e),
                                protocol=pickle.HIGHEST_PROTOCOL)
            reply = ("error", {"task": task_id})
        self.tasks_done += 1
        if task_id in cancelled:
            return  # the client moved on; a late result would be ignored anyway
        try:
            conn.send(reply[0], reply[1], body)
        except TransportError:
            pass  # connection died after the work: the client's retry logic owns it


def warmup(device: str = "cuda") -> Dict[str, Any]:
    """Pay the one-time costs of a fresh process before the first trial
    arrives, in turn, and return the seconds of each part with what this
    worker runs on: ``import_s`` (``import torch``), ``cuda_context_s``
    (the card's context), ``kernel_libraries_s`` (the kernels' ops and
    their three libraries, built first where the checkout has none),
    ``cublas_s`` (cuBLAS's handles and workspace, made before the first
    measurement as the generator does) and ``meta_forward_s`` (the first
    forward on ``meta``, whose ``torch.func.functional_call`` imports the
    distributed-tensor and symbolic-shape modules).  On the CPU the three
    CUDA parts are ``None`` and CUDA is not started.  Raises
    :class:`~repro_torch.device.NoCudaCardError` when ``device`` is CUDA
    and the machine has no card."""
    parts: Dict[str, Any] = {}
    t0 = time.perf_counter()
    import torch

    parts["import_s"] = time.perf_counter() - t0
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    info: Dict[str, Any] = {"torch": torch.__version__, "device": dev.type}
    if dev.type == "cuda":
        t0 = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        parts["cuda_context_s"] = time.perf_counter() - t0
        info["card"] = torch.cuda.get_device_name(dev)
        t0 = time.perf_counter()
        from repro_torch.kernels import ops

        ops._flash_fn(), ops._ssm_fns(), ops._mlstm_fns()
        parts["kernel_libraries_s"] = time.perf_counter() - t0
        from repro_torch.hwgen.generator import _start_blas

        t0 = time.perf_counter()
        _start_blas(torch.device("cuda", torch.cuda.current_device()))
        parts["cublas_s"] = time.perf_counter() - t0
    else:
        parts.update(cuda_context_s=None, kernel_libraries_s=None, cublas_s=None)
    from repro_torch.hwgen.generator import meta_forward

    t0 = time.perf_counter()
    meta_forward(torch.nn.Linear(8, 8), (torch.zeros(2, 8),))
    parts["meta_forward_s"] = time.perf_counter() - t0
    return {**info, "parts": parts}


def _warmed_up_line(info: Dict[str, Any]) -> str:
    parts = " ".join(f"{k}={'-' if v is None else f'{v:.3f}'}"
                     for k, v in info["parts"].items())
    return f"warmed up: torch {info['torch']} on {info['device']} {parts}"


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.worker",
        description="Run a repro_torch evaluation worker daemon.")
    parser.add_argument("--host", default="127.0.0.1",
                        help="interface to bind (default loopback; daemons "
                             "execute arbitrary pickled code — only expose "
                             "them on trusted networks)")
    parser.add_argument("--port", type=int, default=0,
                        help="port to bind (0 = OS-assigned, printed on stdout)")
    parser.add_argument("--cache-dir", default=None,
                        help="redirect every disk evaluation cache this worker "
                             "opens into one store (sets REPRO_CACHE_DIR); "
                             "point same-toolchain workers at one shared "
                             "directory to share measured values")
    parser.add_argument("--heartbeat", type=float, default=None,
                        help="seconds between heartbeat frames (default "
                             "REPRO_REMOTE_HEARTBEAT_S or 2.0)")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the torch/CUDA/kernel-library warmup at startup")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where this worker runs candidates (default cuda, "
                             "which needs a card; cpu never starts CUDA)")
    args = parser.parse_args(argv)

    if args.cache_dir:
        os.environ["REPRO_CACHE_DIR"] = args.cache_dir
    if args.device == "cpu":
        # before torch starts: no CUDA device is visible to this process
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if args.no_warmup:
        from repro_torch.device import resolve_device

        resolve_device(args.device)
    else:
        print(_warmed_up_line(warmup(args.device)), flush=True)
    server = WorkerServer(host=args.host, port=args.port,
                          heartbeat_s=args.heartbeat)
    host, port = server.start()
    # the one line launchers parse: the bound address (meaningful with --port 0)
    print(f"listening on {host}:{port}", flush=True)

    def _graceful(signum, frame):  # noqa: ARG001 — signal handler signature
        # Announce before tearing down: the client resubmits this
        # daemon's in-flight trials immediately instead of waiting out
        # the heartbeat timeout.
        print(f"received {signal.Signals(signum).name}, shutting down",
              flush=True)
        server.announce_shutdown()
        server.stop()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        # race: SIGINT delivered between handler install and the
        # interruptible wait inside serve_forever
        server.announce_shutdown()
    finally:
        server.stop()
    return 0
