"""Length-prefixed TCP framing + handshake for the remote backend (the
JAX package's ``search/remote/transport.py`` on the port, frame for frame).

Wire format — one frame per message, two length-prefixed parts::

    uint32 BE header_len | header JSON (utf-8) | uint32 BE payload_len | payload

The header is small JSON — ``{"kind": ..., "meta": {...}}`` — carrying
routing and bookkeeping (task ids, ack counters); the payload is an
opaque byte string, pickled Python for trial submissions and results,
empty for control frames (heartbeats, acks).  JSON for the envelope
keeps control traffic inspectable on the wire; pickle for the body is
what lets detached plans, pruner snapshots, and arbitrary objective
callables cross hosts unchanged.  The framing is the JAX package's byte
for byte, so either package's :class:`Connection` reads the other's
frames.

**Trust model: pickle means code execution.**  A worker daemon
unpickles (and calls) whatever a connected client sends, which is the
entire point — objectives are arbitrary callables — so daemons must
only listen on trusted networks (loopback, a private cluster fabric, an
SSH tunnel).  The handshake is a compatibility check, not
authentication.

Handshake — first frame each way, before anything else:

* client → ``hello`` with ``{"protocol": PROTOCOL_VERSION, "toolchain":
  {...}, "numerics": {...}}``: the framework tag and the torch, CUDA and
  Triton versions from
  :func:`repro_torch.evaluation.disk_cache.toolchain_versions` (the same
  salt the disk cache keys by), and the client's fp32 numerics flags
  (:func:`repro_torch.search.executors.numerics_flags`: TF32 for matmuls
  and cuDNN, the float32 matmul precision);
* worker → ``hello_ok`` with its worker id, or ``hello_reject`` with a
  reason.  A protocol mismatch means incompatible framing/semantics; a
  toolchain mismatch means the worker would measure latency/memory
  values under another toolchain than the submitting host expects (a
  port client and a JAX daemon refuse each other here: the salts name
  different frameworks), so both reject.  The numerics flags decide how
  fp32 products round on the card, so they are part of the same rule:
  the daemon takes the client's flags (they are global to its process),
  or rejects the client when a live connection already runs under other
  flags (``admit_numerics`` of :func:`server_hello`).

Framing integrity vs. timeouts: :meth:`Connection.recv` only times out
*between* frames — once the first length byte of a frame has been read,
the rest is read under a generous fixed cap so a slow sender cannot
leave the stream desynchronized at a partial frame.  Sends take an
internal lock: a worker's heartbeat thread and its trial thread share
one socket.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch import faults

PROTOCOL_VERSION = 1

# cap on reading the remainder of a frame whose first bytes arrived —
# past this the peer is wedged mid-send and the stream is unrecoverable
FRAME_REMAINDER_TIMEOUT_S = 30.0

# sanity bound on declared lengths: a desynchronized or hostile stream
# must not make us allocate gigabytes from four garbage bytes
MAX_PART_BYTES = 1 << 30

_U32 = struct.Struct(">I")


class TransportError(Exception):
    """The connection is unusable (EOF, reset, corrupt frame)."""


class ConnectionClosed(TransportError):
    """The peer closed the socket (clean EOF between frames)."""


class HandshakeError(TransportError):
    """The peer rejected or botched the hello exchange."""


class Message:
    """One decoded frame."""

    __slots__ = ("kind", "meta", "payload")

    def __init__(self, kind: str, meta: Dict[str, Any], payload: bytes):
        self.kind = kind
        self.meta = meta
        self.payload = payload

    def __repr__(self):  # pragma: no cover — debugging aid
        return f"Message({self.kind!r}, {self.meta!r}, {len(self.payload)}B)"


class Connection:
    """A framed, thread-safe-for-send wrapper over one TCP socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover — non-TCP test doubles
            pass

    @property
    def closed(self) -> bool:
        return self._closed

    def send(self, kind: str, meta: Optional[Dict[str, Any]] = None,
             payload: bytes = b"") -> None:
        """Write one frame atomically w.r.t. sibling sender threads.  The
        header carries a CRC32 of the payload so a mangled body is
        detected at recv as a :class:`TransportError` (worker-lost path)
        instead of surfacing as an unpickling error deep in a worker."""
        envelope: Dict[str, Any] = {"kind": kind, "meta": meta or {}}
        if payload:
            envelope["crc"] = zlib.crc32(payload)
        try:
            # fault injection models the wire, not the sender: the CRC is
            # computed over the intact payload, so injected corruption is
            # caught by the receiver's checksum
            payload = faults.fault_point("transport.send", payload)
        except faults.InjectedFault as e:
            self._closed = True
            raise TransportError(f"send failed: {e}") from e
        if payload is faults.DROP:
            return  # injected frame loss: the bytes never hit the socket
        header = json.dumps(envelope, separators=(",", ":")).encode("utf-8")
        frame = _U32.pack(len(header)) + header + _U32.pack(len(payload)) + payload
        with self._send_lock:
            if self._closed:
                raise ConnectionClosed("send on closed connection")
            try:
                self._sock.sendall(frame)
            except OSError as e:
                self._closed = True
                raise TransportError(f"send failed: {e}") from e

    def _recv_exact(self, n: int, deadline_error: str) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout:
                raise TransportError(deadline_error) from None
            except OSError as e:
                raise TransportError(f"recv failed: {e}") from e
            if not chunk:
                raise ConnectionClosed("peer closed connection")
            buf += chunk
        return bytes(buf)

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Read one frame.  ``None`` means the timeout elapsed with no
        frame *started* — safe to call again.  Once a frame begins, the
        remainder is read under :data:`FRAME_REMAINDER_TIMEOUT_S` so a
        timeout can never strand the stream mid-frame."""
        while True:
            msg = self._recv_one(timeout)
            if msg is not None and msg.payload is faults.DROP:
                continue  # injected inbound frame loss: read the next one
            return msg

    def _recv_one(self, timeout: Optional[float]) -> Optional[Message]:
        try:
            self._sock.settimeout(timeout)
            first = self._sock.recv(1)
        except socket.timeout:
            return None
        except OSError as e:
            raise TransportError(f"recv failed: {e}") from e
        if not first:
            raise ConnectionClosed("peer closed connection")
        try:
            self._sock.settimeout(FRAME_REMAINDER_TIMEOUT_S)
        except OSError as e:
            raise TransportError(f"recv failed: {e}") from e
        wedged = "peer stalled mid-frame"
        header_len = _U32.unpack(first + self._recv_exact(3, wedged))[0]
        if header_len > MAX_PART_BYTES:
            raise TransportError(f"implausible header length {header_len}")
        try:
            header = json.loads(self._recv_exact(header_len, wedged).decode("utf-8"))
            kind = header["kind"]
            meta = header.get("meta") or {}
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            raise TransportError(f"corrupt frame header: {e}") from e
        payload_len = _U32.unpack(self._recv_exact(4, wedged))[0]
        if payload_len > MAX_PART_BYTES:
            raise TransportError(f"implausible payload length {payload_len}")
        payload = self._recv_exact(payload_len, wedged) if payload_len else b""
        try:
            payload = faults.fault_point("transport.recv", payload)
        except faults.InjectedFault as e:
            raise TransportError(f"recv failed: {e}") from e
        if payload is faults.DROP:
            return Message(str(kind), meta, payload)  # recv() skips it
        crc = header.get("crc")
        if crc is not None and crc != zlib.crc32(payload):
            raise TransportError(
                f"corrupt frame payload: checksum mismatch on {kind!r}")
        return Message(str(kind), meta, payload)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def parse_addr(addr: str) -> Tuple[str, int]:
    """``"host:port"`` → ``(host, port)`` (the one address syntax the
    spec layer and REPRO_REMOTE_WORKERS accept)."""
    host, _, port = str(addr).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"worker address {addr!r} is not host:port")
    return host, int(port)


def connect(addr: str, timeout: float = 5.0) -> Connection:
    """Open a TCP connection to ``host:port`` (no handshake yet)."""
    host, port = parse_addr(addr)
    sock = socket.create_connection((host, port), timeout=timeout)
    return Connection(sock)


def local_toolchain() -> Dict[str, str]:
    """The framework/torch/CUDA/Triton salt both handshake sides compare —
    identical to the disk cache's key salt, so two hosts that shake hands
    also agree on cache-entry compatibility."""
    from repro_torch.evaluation.disk_cache import toolchain_versions

    return toolchain_versions()


def local_numerics() -> Dict[str, Any]:
    """This process's fp32 numerics flags, as the client's ``hello``
    carries them."""
    from repro_torch.search.executors import numerics_flags

    return numerics_flags()


def client_hello(conn: Connection, timeout: float = 5.0,
                 hello_meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run the client side of the handshake; returns the worker's
    ``hello_ok`` meta (worker id etc.).  Raises :class:`HandshakeError`
    on rejection.  ``hello_meta`` overrides outgoing fields (tests use
    it to provoke rejections)."""
    meta = {"protocol": PROTOCOL_VERSION, "toolchain": local_toolchain(),
            "numerics": local_numerics()}
    meta.update(hello_meta or {})
    conn.send("hello", meta)
    reply = conn.recv(timeout=timeout)
    if reply is None:
        raise HandshakeError("worker did not answer the hello in time")
    if reply.kind == "hello_reject":
        raise HandshakeError(str(reply.meta.get("reason", "rejected")))
    if reply.kind != "hello_ok":
        raise HandshakeError(f"unexpected handshake reply {reply.kind!r}")
    return reply.meta


def server_hello(conn: Connection, worker_id: str, timeout: float = 5.0,
                 toolchain: Optional[Dict[str, str]] = None,
                 admit_numerics: Optional[Callable[[Any], Optional[str]]] = None
                 ) -> bool:
    """Run the worker side of the handshake; returns True when the
    client is accepted.  ``toolchain`` overrides the local salt (tests
    use it to provoke mismatches).  ``admit_numerics(flags)`` takes the
    client's numerics flags (``None`` when its hello carries none) and
    returns the reason to reject it, or ``None`` once it has made them
    this process's; without it the flags are not checked."""
    msg = conn.recv(timeout=timeout)
    if msg is None or msg.kind != "hello":
        conn.send("hello_reject", {"reason": "expected hello frame first"})
        return False
    mine = toolchain if toolchain is not None else local_toolchain()
    theirs = msg.meta.get("toolchain")
    if msg.meta.get("protocol") != PROTOCOL_VERSION:
        conn.send("hello_reject", {
            "reason": (f"protocol mismatch: client {msg.meta.get('protocol')!r}, "
                       f"worker {PROTOCOL_VERSION!r}")})
        return False
    if theirs != mine:
        conn.send("hello_reject", {
            "reason": (f"toolchain mismatch: client {theirs!r}, worker {mine!r} "
                       f"— measured values would not be comparable")})
        return False
    if admit_numerics is not None:
        reason = admit_numerics(msg.meta.get("numerics"))
        if reason is not None:
            conn.send("hello_reject", {"reason": reason})
            return False
    conn.send("hello_ok", {"worker": worker_id, "protocol": PROTOCOL_VERSION})
    return True
