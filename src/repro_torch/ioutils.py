"""Small shared I/O helpers for crash-tolerant append-only JSONL stores.

Locking: POSIX ``flock`` is the first choice (whole-file advisory lock,
released on close, survives fork sanely).  On NFS-style mounts — which
remote workers sharing a cache directory over a network filesystem will
hit — ``flock`` may be unsupported (``ENOLCK``/``EOPNOTSUPP``) or, on
old NFSv2/v3 setups, silently **non-exclusive** between hosts.  When
``flock`` raises, :func:`lock_file` falls back to ``fcntl.lockf`` range
locks (which NFS implements through the NLM/NFSv4 locking protocol) and
warns once per store path.  The fallback caveat: POSIX range locks are
per-process, so they serialize *processes*, not threads — callers here
already serialize sibling threads themselves — and closing *any*
descriptor of the file drops the lock, so helpers keep exactly one
descriptor open for the locked region's lifetime.
"""
from __future__ import annotations

import os
import warnings
from typing import Set

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX hosts
    fcntl = None

# store paths whose filesystem rejected flock: subsequent locks go
# straight to the lockf fallback without re-probing (and re-warning)
_FLOCK_UNSUPPORTED: Set[str] = set()


def lock_file(f, path: str = "") -> str:
    """Take an exclusive lock on open file object ``f``; returns the
    mechanism used (``"flock"`` | ``"lockf"`` | ``"none"``) for
    :func:`unlock_file`.  Falls back from ``flock`` to ``fcntl.lockf``
    range locks when the filesystem refuses whole-file locks (NFS-style
    mounts), warning once per ``path``."""
    if fcntl is None:  # pragma: no cover — non-POSIX hosts
        return "none"
    key = path or getattr(f, "name", "")
    if key not in _FLOCK_UNSUPPORTED:
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            return "flock"
        except OSError:
            _FLOCK_UNSUPPORTED.add(key)
            warnings.warn(
                f"flock unsupported for {key!r} (NFS-style mount?); falling "
                f"back to fcntl range locks — cross-host exclusion now relies "
                f"on the filesystem's POSIX-lock support",
                RuntimeWarning, stacklevel=3)
    fcntl.lockf(f.fileno(), fcntl.LOCK_EX)
    return "lockf"


def unlock_file(f, how: str) -> None:
    """Release a lock taken by :func:`lock_file`."""
    if fcntl is None or how == "none":  # pragma: no cover — non-POSIX hosts
        return
    if how == "flock":
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)
    else:
        fcntl.lockf(f.fileno(), fcntl.LOCK_UN)


def locked_append(path: str, line: str) -> None:
    """Append one record to ``path`` durably and atomically w.r.t. other
    processes: an OS advisory lock around a single ``write`` + flush +
    fsync, so concurrent appenders sharing the file never tear records.
    Serialization against sibling *threads* is the caller's job.

    Crash hardening: a writer killed mid-append leaves a torn tail with
    no trailing newline; appending straight onto it would concatenate
    the new record into the garbage and lose *both*.  Under the lock we
    check the last byte and seal a torn tail with a newline first, so
    corruption stays confined to the one record that was actually torn.
    """
    data = line.encode("utf-8")
    with open(path, "ab+") as f:
        how = lock_file(f, path)
        try:
            f.seek(0, os.SEEK_END)
            end = f.tell()
            if end > 0:
                f.seek(end - 1)
                if f.read(1) != b"\n":
                    data = b"\n" + data
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        finally:
            unlock_file(f, how)
