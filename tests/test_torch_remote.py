"""The port's remote transport, daemon and client (``repro_torch.search.
remote``) on the CPU: frames byte for byte the JAX package's, read by either
package's connection; the handshake (protocol, toolchain, fp32 numerics
flags), with each package's daemon refusing the other's client by
toolchain; the reference's client cases on the port (generic calls, a
worker's death resubmitted to a sibling, retries exhausted, heartbeat
timeout, a dead pool, the ``shutdown`` frame, rejoin); the CRC and the
transport fault points; mid-trial pruner refreshes; the daemon's warm-up
and its command line in a subprocess.  Daemons are in-process loopback
``WorkerServer`` instances (ephemeral ports) unless the test starts the
CLI; callables are module-level so they pickle by reference."""
import operator
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny work: leave the CPU to the other test workers

from repro_torch import faults  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.search.executors import numerics_flags  # noqa: E402
from repro_torch.search.remote import transport  # noqa: E402
from repro_torch.search.remote.client import RemoteClient  # noqa: E402
from repro_torch.search.remote.worker import DropConnection, WorkerServer, warmup  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
# what a subprocess daemon gets to print its address and answer: generous,
# since the tier-1 run shares the CPU among its test workers
CLI_TIMEOUT_S = 120.0


def _start_servers(n, cls=WorkerServer, **kwargs):
    servers = [cls(**kwargs) for _ in range(n)]
    addrs = []
    for s in servers:
        host, port = s.start()
        addrs.append(f"{host}:{port}")
    return servers, addrs


@pytest.fixture
def pool():
    servers, addrs = _start_servers(2)
    yield addrs
    for s in servers:
        s.stop()


def _call_payload(fn, *args):
    blob = pickle.dumps(("call", (fn, args, {})), protocol=pickle.HIGHEST_PROTOCOL)
    return lambda: blob


class _Done:
    def __init__(self):
        self.event = threading.Event()
        self.value = self.error = self.worker = None

    def __call__(self, key, value, error, worker_addr):
        self.value, self.error, self.worker = value, error, worker_addr
        self.event.set()


class _DieOnce:
    def __init__(self):
        self.dropped = False

    def __call__(self, task_id, task):
        if not self.dropped:
            self.dropped = True
            raise DropConnection()


# ---------------------------------------------------------------------------
# framing: the JAX package's, byte for byte
# ---------------------------------------------------------------------------

def _jax_transport():
    pytest.importorskip("jax")
    from repro.search.remote import transport as jtransport

    return jtransport


def _wire_bytes(connection_cls, kind, meta, payload):
    """The bytes one ``send`` puts on the socket."""
    a, b = socket.socketpair()
    try:
        connection_cls(a).send(kind, meta, payload)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


FRAMES = [
    ("submit", {"task": "t1"}, b"\x00payload\xff"),
    ("heartbeat", {"worker": "worker-0a1b2c3d", "tasks_done": 7}, b""),
    ("report", {"task": "ab" * 16, "number": 3, "step": 2, "value": 0.125}, b""),
    ("result", {"task": "t2"}, pickle.dumps({"x": [1.5, -2.0]}, protocol=5)),
    ("hello", {"protocol": 1, "toolchain": {"framework": "torch", "torch": "2.x"},
               "numerics": {"matmul_allow_tf32": False}}, b""),
]


@pytest.mark.parametrize("kind, meta, payload", FRAMES, ids=[f[0] for f in FRAMES])
def test_frames_are_the_jax_packages_byte_for_byte(kind, meta, payload):
    """The same (kind, meta, payload) puts the same bytes on the wire
    through either package's connection, and each reads the other's."""
    jtransport = _jax_transport()
    ours = _wire_bytes(transport.Connection, kind, meta, payload)
    assert ours == _wire_bytes(jtransport.Connection, kind, meta, payload)
    for sender, receiver in ((transport.Connection, jtransport.Connection),
                             (jtransport.Connection, transport.Connection)):
        a, b = socket.socketpair()
        left, right = sender(a), receiver(b)
        try:
            left.send(kind, meta, payload)
            msg = right.recv(timeout=5.0)
            assert (msg.kind, msg.meta, msg.payload) == (kind, meta, payload)
        finally:
            left.close()
            right.close()
    assert (transport.PROTOCOL_VERSION, transport.MAX_PART_BYTES,
            transport.FRAME_REMAINDER_TIMEOUT_S) == (
        jtransport.PROTOCOL_VERSION, jtransport.MAX_PART_BYTES,
        jtransport.FRAME_REMAINDER_TIMEOUT_S)


def test_frame_roundtrip_timeout_and_eof_over_socketpair():
    a, b = socket.socketpair()
    left, right = transport.Connection(a), transport.Connection(b)
    try:
        left.send("submit", {"task": "t1"}, b"\x00payload\xff")
        msg = right.recv(timeout=2.0)
        assert (msg.kind, msg.meta, msg.payload) == ("submit", {"task": "t1"},
                                                     b"\x00payload\xff")
        right.send("heartbeat", {"n": 3})
        msg = left.recv(timeout=2.0)
        assert msg.kind == "heartbeat" and msg.meta == {"n": 3} and msg.payload == b""
        # no frame pending: the timeout yields None, the stream stays usable
        assert left.recv(timeout=0.05) is None
        right.send("bye")
        assert left.recv(timeout=2.0).kind == "bye"
        right.close()
        with pytest.raises(transport.ConnectionClosed):
            left.recv(timeout=2.0)
    finally:
        left.close()
        right.close()


def test_parse_addr():
    assert transport.parse_addr("10.0.0.2:7471") == ("10.0.0.2", 7471)
    for bad in ("nope", ":7471", "host:", "host:port"):
        with pytest.raises(ValueError, match="host:port"):
            transport.parse_addr(bad)


@pytest.mark.parametrize("plan, match", [
    ("seed=4;transport.send:corrupt@times=1", "checksum"),
    ("transport.recv:drop@times=1", None),
])
def test_transport_fault_points(plan, match):
    """A corrupted payload fails the receiver's CRC; a dropped frame is
    skipped and the next one delivered."""
    a, b = socket.socketpair()
    left, right = transport.Connection(a), transport.Connection(b)
    try:
        faults.install(FaultPlan.from_string(plan))
        left.send("result", {"n": 1}, b"A" * 64)
        left.send("result", {"n": 2}, b"second")
        if match is not None:
            with pytest.raises(transport.TransportError, match=match):
                right.recv(timeout=2.0)
        else:
            msg = right.recv(timeout=2.0)
            assert (msg.meta["n"], msg.payload) == (2, b"second")
    finally:
        faults.uninstall()
        left.close()
        right.close()


# ---------------------------------------------------------------------------
# handshake: protocol, toolchain, numerics flags
# ---------------------------------------------------------------------------

def test_handshake_protocol_mismatch_rejected(pool):
    conn = transport.connect(pool[0])
    try:
        with pytest.raises(transport.HandshakeError, match="protocol mismatch"):
            transport.client_hello(conn, hello_meta={"protocol": 999})
    finally:
        conn.close()


def test_handshake_toolchain_mismatch_rejected():
    servers, addrs = _start_servers(1, toolchain={"framework": "torch",
                                                  "torch": "not-what-you-have"})
    try:
        conn = transport.connect(addrs[0])
        try:
            with pytest.raises(transport.HandshakeError, match="toolchain mismatch"):
                transport.client_hello(conn)
        finally:
            conn.close()
        # the pool client treats a rejecting worker as absent, with a warning
        client = RemoteClient(addrs)
        with pytest.warns(RuntimeWarning, match="rejected the handshake"):
            assert client.connect() == []
        client.close()
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("client_side", ["port", "jax"])
def test_each_packages_daemon_refuses_the_others_client(client_side):
    """A port client against a JAX daemon, and a JAX client against a port
    daemon: the salts name different frameworks, so each daemon answers
    ``hello_reject`` with a toolchain mismatch naming both."""
    jtransport = _jax_transport()
    from repro.search.remote.worker import WorkerServer as JWorkerServer

    server_cls = JWorkerServer if client_side == "port" else WorkerServer
    client_transport = transport if client_side == "port" else jtransport
    servers, addrs = _start_servers(1, cls=server_cls)
    try:
        conn = client_transport.connect(addrs[0])
        try:
            with pytest.raises(client_transport.HandshakeError,
                               match="toolchain mismatch") as err:
                client_transport.client_hello(conn)
        finally:
            conn.close()
        assert "'framework': 'torch'" in str(err.value) and "jax" in str(err.value)
    finally:
        for s in servers:
            s.stop()


def test_numerics_flags_are_applied_and_a_conflicting_client_refused(pool):
    """The daemon takes the flags of a client that connects alone, refuses
    one with other flags while that connection lives (naming both), and
    takes the new flags once it is gone.  A hello without flags is
    refused."""
    mine = numerics_flags()
    other = dict(mine, cudnn_allow_tf32=not mine["cudnn_allow_tf32"])
    first = transport.connect(pool[0])
    try:
        assert transport.client_hello(first)["worker"]
        second = transport.connect(pool[0])
        try:
            with pytest.raises(transport.HandshakeError,
                               match="numerics flags mismatch") as err:
                transport.client_hello(second, hello_meta={"numerics": other})
            assert repr(other) in str(err.value) and repr(mine) in str(err.value)
        finally:
            second.close()
        conn = transport.connect(pool[0])
        try:
            with pytest.raises(transport.HandshakeError, match="numerics flags missing"):
                transport.client_hello(conn, hello_meta={"numerics": None})
        finally:
            conn.close()
    finally:
        first.send("bye")
        first.close()
    deadline = time.monotonic() + 10.0
    try:
        while True:  # the daemon drops the first connection's flags on close
            conn = transport.connect(pool[0])
            try:
                transport.client_hello(conn, hello_meta={"numerics": other})
                break
            except transport.HandshakeError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
            finally:
                conn.close()
        assert numerics_flags() == other  # the daemon shares this process
    finally:
        from repro_torch.search.executors import apply_numerics_flags

        apply_numerics_flags(mine)


# ---------------------------------------------------------------------------
# RemoteClient: dispatch + fault tolerance
# ---------------------------------------------------------------------------

def test_client_runs_generic_calls_and_returns_their_errors(pool):
    client = RemoteClient(pool)
    assert sorted(client.connect()) == sorted(pool)
    try:
        done = _Done()
        client.submit("k", _call_payload(operator.add, 2, 3), done)
        assert done.event.wait(10.0)
        assert done.error is None and done.value == 5 and done.worker in pool
        # a failing call surfaces as the task's error, from the worker
        done = _Done()
        client.submit("k", _call_payload(int, "not a number"), done)
        assert done.event.wait(10.0)
        assert isinstance(done.error, ValueError) and done.worker in pool
    finally:
        client.close()


def test_worker_death_resubmits_to_sibling():
    hook = _DieOnce()
    flaky, flaky_addrs = _start_servers(1, task_hook=hook)
    steady, steady_addrs = _start_servers(1)
    client = RemoteClient(flaky_addrs + steady_addrs, retries=2)
    try:
        client.connect()
        done = _Done()
        with pytest.warns(RuntimeWarning, match="lost"):
            # dispatch follows connect order: the flaky worker takes the
            # task and severs the connection
            client.submit("k", _call_payload(operator.mul, 6, 7), done)
            assert done.event.wait(10.0)
        assert hook.dropped
        assert done.error is None and done.value == 42
        assert done.worker == steady_addrs[0]
    finally:
        client.close()
        for s in flaky + steady:
            s.stop()


def test_retries_exhausted_surfaces_error():
    def die(task_id, task):
        raise DropConnection()

    servers, addrs = _start_servers(2, task_hook=die)
    client = RemoteClient(addrs, retries=0)
    try:
        client.connect()
        done = _Done()
        with pytest.warns(RuntimeWarning, match="lost"):
            client.submit("k", _call_payload(operator.add, 1, 1), done)
            assert done.event.wait(10.0)
        assert done.value is None and "attempts" in str(done.error)
    finally:
        client.close()
        for s in servers:
            s.stop()


def test_heartbeat_timeout_declares_worker_lost():
    hang = threading.Event()
    # heartbeat_s=0: the daemon never heartbeats; the hook wedges the task,
    # so the client sees the ack and then silence
    servers, addrs = _start_servers(
        1, heartbeat_s=0, task_hook=lambda tid, task: hang.wait(30.0))
    client = RemoteClient(addrs, retries=0, heartbeat_timeout_s=0.5)
    try:
        client.connect()
        done = _Done()
        with pytest.warns(RuntimeWarning, match="lost"):
            client.submit("k", _call_payload(operator.add, 1, 1), done)
            assert done.event.wait(10.0)
        assert done.value is None and "silent" in str(done.error)
        assert client.live_workers() == []
    finally:
        hang.set()
        client.close()
        for s in servers:
            s.stop()


def test_submit_with_dead_pool_fails_inline():
    client = RemoteClient(["127.0.0.1:9"], connect_timeout_s=0.2)
    with pytest.warns(RuntimeWarning, match="unreachable"):
        assert client.connect() == []
    done = _Done()
    client.submit("k", _call_payload(operator.add, 1, 1), done)
    assert done.event.is_set() and "no live remote workers" in str(done.error)
    client.close()


def test_shutdown_frame_resubmits_without_heartbeat_wait():
    """A daemon announcing shutdown mid-task makes the client resubmit at
    once; the heartbeat timeout is set far beyond the test's wait so the
    slow path cannot be the explanation."""
    flaky, flaky_addrs = _start_servers(1)
    steady, steady_addrs = _start_servers(1)
    release = threading.Event()

    def announce_and_wedge(task_id, task):
        flaky[0].announce_shutdown()
        release.wait(60.0)  # never returns a result in time

    flaky[0]._task_hook = announce_and_wedge
    client = RemoteClient(flaky_addrs + steady_addrs, retries=2,
                          heartbeat_timeout_s=300.0)
    try:
        client.connect()
        done = _Done()
        t0 = time.perf_counter()
        with pytest.warns(RuntimeWarning, match="announced shutdown"):
            client.submit("k", _call_payload(operator.mul, 6, 7), done)
            assert done.event.wait(30.0)
        assert time.perf_counter() - t0 < 25.0
        assert done.error is None and done.value == 42
        assert done.worker == steady_addrs[0]
    finally:
        release.set()
        client.close()
        for srv in flaky + steady:
            srv.stop()


def test_lost_worker_rejoins_the_pool():
    """Stop the only daemon, bring a new one up on its port: a
    rejoin-enabled client redials with backoff and the pool heals."""
    servers, addrs = _start_servers(1)
    host, port = addrs[0].split(":")
    client = RemoteClient(addrs, retries=0, heartbeat_timeout_s=1.0, rejoin=True)
    try:
        assert client.connect() == addrs
        with pytest.warns(RuntimeWarning, match="lost|rejoin"):
            servers[0].stop()
            deadline = time.monotonic() + 20.0
            while client.live_workers() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert client.live_workers() == []
            replacement = WorkerServer(host=host, port=int(port))
            replacement.start()
            servers.append(replacement)
            while not client.live_workers() and time.monotonic() < deadline:
                time.sleep(0.05)
        assert client.live_workers() == addrs
        done = _Done()
        client.submit("k", _call_payload(operator.add, 20, 22), done)
        assert done.event.wait(10.0)
        assert done.error is None and done.value == 42
    finally:
        client.close()
        for srv in servers:
            srv.stop()


def test_tasks_run_on_a_fresh_thread_with_grad_mode_on(pool):
    """Each task runs on a thread of its own, where torch's grad mode is
    on whatever the caller set: the generator and timings take
    ``inference_mode`` themselves (the CUDA kernels refuse an input that
    needs a gradient)."""
    client = RemoteClient(pool)
    client.connect()
    try:
        with torch.no_grad():
            done = _Done()
            client.submit("k", _call_payload(torch.is_grad_enabled), done)
            assert done.event.wait(10.0)
        assert done.error is None and done.value is True
    finally:
        client.close()


# ---------------------------------------------------------------------------
# mid-trial pruner refresh: the delta fold is shared and in-place
# ---------------------------------------------------------------------------

def test_apply_pruner_deltas_refreshes_live_contexts():
    from repro_torch.search.detached import (
        _DELTA_HISTORY,
        PrunerContext,
        apply_pruner_deltas,
    )
    from repro_torch.search.pruners import MedianPruner
    from repro_torch.search.trial import TrialState

    cid = "ctx-refresh-test"
    try:
        ctx = PrunerContext(MedianPruner(n_startup_trials=0), ("minimize",),
                            deltas=[("report", 0, 0, 1.0)], base=0, context_id=cid)
        ctx.apply()
        assert _DELTA_HISTORY[cid][0] == 1
        # a refresh while ctx's trial runs: the same records dict, so the
        # running trial's next should_prune sees trial 1
        assert apply_pruner_deltas(cid, 1, [("report", 1, 0, 5.0)]) == 2
        assert ctx._applied[1][1].intermediate == {0: 5.0}
        # an idempotent replay of an already-applied slice
        assert apply_pruner_deltas(
            cid, 0, [("report", 0, 0, 1.0), ("report", 1, 0, 5.0)]) == 2
        # a tail starting past what is held is unusable: ack what is held
        assert apply_pruner_deltas(cid, 10, [("report", 9, 0, 1.0)]) == 2
        apply_pruner_deltas(cid, 2, [("final", 0, TrialState.COMPLETE, (1.5,), {0: 1.0})])
        assert ctx._applied[1][0].state == TrialState.COMPLETE
    finally:
        _DELTA_HISTORY.pop(cid, None)


# ---------------------------------------------------------------------------
# the daemon: warm-up, device, command line
# ---------------------------------------------------------------------------

def test_warmup_on_the_cpu_reports_its_parts_and_starts_no_cuda():
    info = warmup("cpu")
    assert info["device"] == "cpu" and info["torch"] == torch.__version__
    parts = info["parts"]
    assert list(parts) == ["import_s", "cuda_context_s", "kernel_libraries_s",
                           "cublas_s", "meta_forward_s"]
    assert parts["cuda_context_s"] is parts["kernel_libraries_s"] is parts["cublas_s"] is None
    assert parts["import_s"] >= 0.0 and parts["meta_forward_s"] > 0.0
    assert not torch.cuda.is_initialized()


def test_daemon_without_a_card_refuses_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.device import NoCudaCardError
    from repro_torch.search.remote.worker import main

    for argv in (["--no-warmup", "--port", "0"], ["--port", "0"]):
        with pytest.raises(NoCudaCardError, match="--device cpu"):
            main(argv)


def test_worker_cli_subprocess_roundtrip(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.worker", "--no-warmup", "--device", "cpu",
         "--port", "0", "--cache-dir", str(tmp_path / "cache")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        addr, seen = None, []
        reader = threading.Thread(target=lambda: seen.extend(iter(proc.stdout.readline, "")),
                                  daemon=True)
        reader.start()
        deadline = time.monotonic() + CLI_TIMEOUT_S
        while addr is None and time.monotonic() < deadline and proc.poll() is None:
            addr = next((line.split()[-1] for line in list(seen)
                         if line.startswith("listening on ")), None)
            time.sleep(0.05)
        assert addr, f"the daemon printed no address: {seen}"
        conn = transport.connect(addr, timeout=CLI_TIMEOUT_S)
        try:
            assert transport.client_hello(conn, timeout=CLI_TIMEOUT_S).get("worker")
            conn.send("submit", {"task": "t1"},
                      pickle.dumps(("call", (operator.add, (2, 3), {})),
                                   protocol=pickle.HIGHEST_PROTOCOL))
            result = None
            while time.monotonic() < deadline:
                msg = conn.recv(timeout=1.0)
                if msg is None or msg.kind in ("ack", "heartbeat"):
                    continue
                result = msg
                break
            assert result is not None and result.kind == "result"
            assert pickle.loads(result.payload) == 5
            conn.send("bye")
        finally:
            conn.close()
        proc.terminate()
        assert proc.wait(timeout=CLI_TIMEOUT_S) == 0
        reader.join(timeout=10.0)
        assert any("received SIGTERM, shutting down" in line for line in seen)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
