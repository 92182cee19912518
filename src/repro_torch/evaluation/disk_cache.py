"""Disk-persistent tier for :class:`~repro_torch.evaluation.cache.EvaluationCache`.

A copy of the JAX package's disk tier with the port's own toolchain
salt.  Measuring a candidate on the card dominates hardware-in-the-loop
NAS, and the in-memory cache dies with the process: every resumed study
— and every process worker — would measure again architectures the host
had already paid for.  This module persists the *scalar* estimator
values (latency, peak bytes, roofline bounds, tuned kernel schedules) so
a restarted or process-parallel study measures each architecture at most
once per host:

  * layout: one append-only JSONL file, ``entries.jsonl``, inside the
    store directory (default ``results/cache/``), one record per value:
    ``{"key": <canonical key>, "value": <scalar>, "crc": <crc32>}`` —
    the CRC32 covers key+value, so bit rot that still parses as JSON
    reads back as a miss (and is dropped at compaction), never as a
    wrong measured value; pre-CRC records (no ``crc`` field)
    are accepted and re-checksummed by the next compaction;
  * keys are the cache's own tuples — estimator name, target, batch,
    full architecture signature (layers AND pre-processing) — wrapped
    together with a **toolchain salt** (the framework tag ``torch`` and
    the torch, CUDA and Triton versions, see :func:`toolchain_versions`)
    and canonicalized to a JSON string, so a changed architecture,
    target, batch size, or toolchain can never alias an old entry.  The
    JAX package salts its keys with jax/jaxlib versions and no tag, so a
    value it wrote and one the port wrote under the same estimator key
    in a shared directory are never read back as each other.
    **Invalidation** is therefore structural: entries never go stale as
    long as signatures capture the program, and a torch or CUDA upgrade
    (which can change measured latency and memory) simply stops matching
    the old records instead of serving them;
  * artifacts (placed modules) are not persistable — non-JSON values are
    silently skipped and live only in the memory tier;
  * concurrency: appends take an ``flock`` around a single ``write`` (the
    same discipline as study JSONL storage), so sibling *processes*
    sharing the store never tear records; readers only consume complete
    lines and re-scan the tail on miss, so a value computed by one
    worker is found by the others without recompiling.

**Shared-filesystem caveat (remote workers):** worker daemons pointed at
one store directory over NFS share measured values across hosts, but
``flock`` on NFS is only reliable on NFSv4-era mounts; older setups
reject it (``ENOLCK``/``EOPNOTSUPP``) or grant it without cross-host
exclusion.  When ``flock`` raises, :mod:`repro_torch.ioutils` falls back to
``fcntl.lockf`` range locks (NFS's native locking protocol) with a
one-line ``RuntimeWarning`` per store.  If a mount grants ``flock``
*non-exclusively* (silent NFSv2/v3 emulation), no error is observable —
worst case is a torn JSONL line, which readers already skip as corrupt
and rewrite on the next store; the cache degrades to extra recomputes,
never to wrong values.  ``REPRO_CACHE_DIR`` overrides the store
directory for every cache opened in the process (worker daemons,
``python -m repro_torch.worker --cache-dir``, set it).

The store is warm-loaded at construction (study/estimator setup time)
and refreshed incrementally on miss, so a restarted study starts with
every previously measured value already resident.

**Migration note (toolchain salt):** keys written before the salt was
introduced (records whose ``key`` field is a bare JSON list rather than
a ``{"key": ..., "toolchain": ...}`` object) are still parsed but can no
longer match a lookup, so the first run on the new format recomputes and
appends fresh records — no manual migration is needed.  The same applies
after any torch, CUDA or Triton upgrade.

**Compaction (size hygiene at scale):** the store is append-only, so
superseded-toolchain records and evicted duplicates accumulate.  When
the file holds more than ``REPRO_CACHE_MAX_ENTRIES`` records (or the
``max_entries`` constructor argument; unset = unbounded), the next
append rewrites ``entries.jsonl`` in place under the same ``flock`` the
appends take: records whose toolchain salt no longer matches the running
toolchain (the JAX package's among them) are dropped first, then least-recently-used current-salt
records down to ~75% of the cap — the slack means a steady stream of
new keys doesn't rewrite the file on every append (recency = this
process's lookup/store order; records only ever seen in the file rank
oldest, in file order).
Sibling processes notice the shrink through the existing
truncation-detection path and re-read.  Dropping a live record only
costs a recompute — the store is a cache, never the source of truth.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
import zlib
from typing import Any, Dict, Hashable, List, Optional, Tuple

from repro_torch import faults
from repro_torch.envvars import read_env
from repro_torch.ioutils import lock_file, locked_append, unlock_file

DEFAULT_DIR = os.path.join("results", "cache")

MAX_ENTRIES_ENV = "REPRO_CACHE_MAX_ENTRIES"
CACHE_DIR_ENV = "REPRO_CACHE_DIR"


def _max_entries_from_env() -> Optional[int]:
    # declared in repro_torch.envvars (the shared REPRO_* registry): malformed
    # values warn and leave the store unbounded
    return read_env(MAX_ENTRIES_ENV, None)

_JSON_SCALARS = (str, int, float, bool, type(None))


def jsonable(value: Any) -> bool:
    """True if ``value`` round-trips through JSON (tuples become lists)."""
    if isinstance(value, _JSON_SCALARS):
        return True
    if isinstance(value, (list, tuple)):
        return all(jsonable(v) for v in value)
    if isinstance(value, dict):
        return all(isinstance(k, str) and jsonable(v) for k, v in value.items())
    return False


FRAMEWORK = "torch"


def toolchain_versions() -> Dict[str, str]:
    """The framework tag and the torch, CUDA and Triton versions ("unavailable"
    where there is none: CUDA in a CPU build of torch, Triton where it is
    not installed) — the measured-value salt: two toolchains may run the
    same candidate at different latency/memory, so their values must never
    alias.  Triton's version is read from its package metadata, without
    importing it."""
    import importlib.metadata

    import torch

    try:
        triton_version = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_version = "unavailable"
    return {"framework": FRAMEWORK, "torch": str(torch.__version__),
            "cuda": str(torch.version.cuda or "unavailable"),
            "triton": triton_version}


_TOOLCHAIN: Optional[Dict[str, str]] = None


def _toolchain_salt() -> Dict[str, str]:
    global _TOOLCHAIN
    if _TOOLCHAIN is None:
        _TOOLCHAIN = toolchain_versions()
    return _TOOLCHAIN


def canonical_key(key: Hashable) -> Optional[str]:
    """Stable string form of a cache key salted with the toolchain (an
    upgrade invalidates structurally instead of serving stale measured
    values), or None when the key contains non-JSON parts (those entries
    stay memory-only)."""
    if not jsonable(key):
        return None
    return json.dumps({"key": key, "toolchain": _toolchain_salt()},
                      sort_keys=True, separators=(",", ":"))


def _record_crc(key: str, value: Any) -> int:
    """CRC32 integrity checksum over the record's canonical content.
    Bit rot or a mangled write that still parses as JSON must read back
    as a *miss*, never as a wrong measured value."""
    return zlib.crc32(json.dumps([key, value], sort_keys=True,
                                 separators=(",", ":")).encode("utf-8"))


def _record_line(key: str, value: Any) -> str:
    return json.dumps({"key": key, "value": value,
                       "crc": _record_crc(key, value)}) + "\n"


def _record_value(rec: Any) -> Tuple[Optional[str], Any, str]:
    """Validate one parsed record -> (key, value, status), status one of
    ``"ok"`` | ``"skip"`` (not a value record) | ``"corrupt"`` (checksum
    mismatch).  Records written before checksums (no ``crc`` field) are
    accepted as-is; a present checksum must match or the record is
    dropped — a miss and a recompute, never a wrong value."""
    if not isinstance(rec, dict):
        return None, None, "skip"
    key = rec.get("key")
    if not isinstance(key, str) or "value" not in rec:
        return None, None, "skip"
    if "crc" in rec and rec["crc"] != _record_crc(key, rec["value"]):
        return None, None, "corrupt"
    return key, rec["value"], "ok"


class DiskEvaluationCache:
    """Append-only JSONL value store, safe across threads and processes,
    with optional size-capped LRU compaction (see module docstring)."""

    FILENAME = "entries.jsonl"
    EPOCH_FILENAME = "compaction.epoch"

    def __init__(self, path: str = DEFAULT_DIR, max_entries: Optional[int] = None):
        # REPRO_CACHE_DIR redirects every store opened in this process —
        # worker daemons use it to keep shipped specs (whose cache.dir is
        # a path on the submitting host) inside their own store
        override = read_env(CACHE_DIR_ENV, None)
        self.path = str(override) if override else str(path)
        self._file = os.path.join(self.path, self.FILENAME)
        self._epoch_file = os.path.join(self.path, self.EPOCH_FILENAME)
        self._epoch: Optional[str] = None  # last-seen compaction token
        self._lock = threading.Lock()
        # insertion order doubles as recency: lookup hits and stores
        # re-insert their key at the end, so iteration runs LRU-first
        self._mem: Dict[str, Any] = {}
        self._offset = 0  # byte offset of the next unread record
        self._file_records = 0  # records this process believes are on disk
        self.max_entries = max_entries if max_entries is not None else _max_entries_from_env()
        if self.max_entries is not None:
            self.max_entries = max(1, int(self.max_entries))
        self.compactions = 0
        self.dropped_superseded = 0
        self.dropped_lru = 0
        self.corrupt_records = 0  # checksum/parse failures seen on read
        self.dropped_corrupt = 0  # corrupt records removed by compaction
        os.makedirs(self.path, exist_ok=True)
        self.refresh()  # warm load at construction

    # -- reading ---------------------------------------------------------------

    def refresh(self) -> int:
        """Consume records appended since the last read (by this process
        or siblings sharing the store); returns how many were new."""
        with self._lock:
            return self._read_new()

    def _read_epoch(self) -> Optional[str]:
        try:
            with open(self._epoch_file) as f:
                return f.read()
        except OSError:
            return None

    def _read_new(self) -> int:
        if not os.path.exists(self._file):
            return 0
        epoch = self._read_epoch()
        if epoch != self._epoch:
            # a sibling compacted the store: our byte offset no longer
            # aligns with record boundaries (the rewrite may even leave
            # the file the same length) — drop the view and re-read
            self._epoch = epoch
            self._mem.clear()
            self._offset = 0
            self._file_records = 0
        if os.path.getsize(self._file) < self._offset:
            # the store was truncated (a sibling's clear()): our offset
            # points past EOF and our memory view predates the wipe —
            # drop both and re-read whatever the siblings rebuilt.  (If
            # the file regrew past our offset before we noticed, stale
            # entries can linger: cross-process invalidation is
            # best-effort; delete the store directory between runs for a
            # guaranteed rebuild.)
            self._mem.clear()
            self._offset = 0
            self._file_records = 0
        try:
            with open(self._file, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return 0  # store vanished / unreadable: degrade to misses
        lines = data.split(b"\n")
        # the final element is b"" after a complete record, or the torn
        # tail of an append in progress — leave it for the next refresh
        self._offset += len(data) - len(lines[-1])
        n = 0
        for raw in lines[:-1]:
            if not raw.strip():
                continue
            self._file_records += 1
            try:
                raw = faults.fault_point("disk_cache.read", raw)
            except faults.InjectedFault:
                self.corrupt_records += 1
                continue
            if raw is faults.DROP:
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                # corrupt line: skip rather than poison the run
                self.corrupt_records += 1
                continue
            key, value, status = _record_value(rec)
            if status == "corrupt":
                self.corrupt_records += 1
                continue
            if status == "ok":
                # re-insert so a key re-appended by a sibling ranks recent
                self._mem.pop(key, None)
                self._mem[key] = value
                n += 1
        return n

    def lookup(self, key: Hashable) -> Tuple[bool, Any]:
        """(found, value).  Re-scans the file tail first, so entries
        appended by sibling processes are found before the caller pays a
        compile — and a sibling's truncation is noticed before a stale
        memory entry is served.  Callers (the memory tier) only reach
        this once per key per process, so the extra stat+read is cheap."""
        ck = canonical_key(key)
        if ck is None:
            return False, None
        with self._lock:
            self._read_new()
            if ck in self._mem:
                value = self._mem.pop(ck)  # re-insert: hits rank recent
                self._mem[ck] = value
                return True, value
        return False, None

    # -- writing ---------------------------------------------------------------

    def store(self, key: Hashable, value: Any) -> bool:
        """Write-through one value; returns False (and skips the disk) for
        non-canonical keys or non-JSON values (e.g. artifacts)."""
        ck = canonical_key(key)
        if ck is None or not jsonable(value):
            return False
        with self._lock:
            if ck in self._mem:  # already persisted (possibly by a sibling)
                self._mem.pop(ck)
                self._mem[ck] = value
                return True
            line = faults.fault_point("disk_cache.write", _record_line(ck, value))
            if line is not faults.DROP:
                try:
                    locked_append(self._file, line)
                except (OSError, faults.InjectedFault) as e:
                    # a full/unwritable/faulted store must not fail the
                    # study — the value stays resident in memory and the
                    # cache degrades to recomputes in other processes
                    warnings.warn(
                        f"disk cache append to {self._file!r} failed "
                        f"({e!r}); keeping the value in memory only",
                        RuntimeWarning, stacklevel=3)
            self._mem[ck] = value
            # consume the tail (our own append + anything siblings added)
            # instead of bumping a counter: the next _read_new would
            # re-read our record from the old offset and double-count it
            self._read_new()
            if self.max_entries is not None and self._file_records > self.max_entries:
                self._compact()
        return True

    # -- compaction ------------------------------------------------------------

    def _compact(self) -> None:
        """Rewrite ``entries.jsonl`` in place under flock, dropping
        superseded-toolchain records first, then LRU current-salt records
        down to ~75% of ``max_entries`` (headroom so the next appends
        don't immediately re-trigger).  Caller holds ``self._lock``."""
        try:
            f = open(self._file, "r+b")
        except OSError:
            return  # store vanished under us: nothing to compact
        with f:
            how = lock_file(f, self._file)
            try:
                # re-read the WHOLE file under the lock: siblings may have
                # appended records this process has never seen, and the
                # cap applies to the union
                entries: Dict[str, Any] = {}
                corrupt = 0
                for raw in f.read().split(b"\n"):
                    if not raw.strip():
                        continue
                    try:
                        rec = json.loads(raw.decode("utf-8"))
                    except (UnicodeDecodeError, json.JSONDecodeError):
                        corrupt += 1
                        continue  # corrupt line: compacted away
                    key, value, status = _record_value(rec)
                    if status == "corrupt":
                        corrupt += 1
                        continue
                    if status == "ok":
                        entries.pop(key, None)  # keep-last, ranked by file order
                        entries[key] = value
                current = _toolchain_salt()
                live: Dict[str, Any] = {}
                for key, value in entries.items():
                    try:
                        salt = json.loads(key).get("toolchain")
                    except (ValueError, AttributeError):
                        salt = None  # pre-salt legacy key: superseded
                    if salt == current:
                        live[key] = value
                superseded = len(entries) - len(live)
                # promote this process's access order (oldest..newest), so
                # iteration order over `live` is LRU-first; keys only ever
                # seen in the file keep file order and rank oldest
                for key in list(self._mem):
                    if key in live:
                        live[key] = live.pop(key)
                # hysteresis: compact down to ~75% of the cap, so a
                # steady state of all-new keys doesn't rewrite the whole
                # file on every single append past the cap
                keep = max(1, self.max_entries - self.max_entries // 4)
                lru = max(0, len(live) - keep)
                for key in list(live)[:lru]:
                    del live[key]
                f.seek(0)
                f.truncate()
                # the rewrite re-checksums every surviving record, which
                # also upgrades pre-CRC legacy records in place
                for key, value in live.items():
                    f.write(_record_line(key, value).encode("utf-8"))
                f.flush()
                os.fsync(f.fileno())
                end = f.tell()
                # bump the epoch (still under the store flock) so sibling
                # processes drop their now-misaligned byte offsets
                epoch = f"{os.getpid()}:{os.urandom(8).hex()}"
                with open(self._epoch_file, "w") as ef:
                    ef.write(epoch)
                self._epoch = epoch
            finally:
                unlock_file(f, how)
        self._mem = dict(live)
        self._offset = end
        self._file_records = len(live)
        self.compactions += 1
        self.dropped_superseded += superseded
        self.dropped_lru += lru
        self.dropped_corrupt += corrupt

    def stats(self) -> Dict[str, int]:
        """Hygiene counters for reports: resident entries + what
        compaction has dropped so far in this process."""
        with self._lock:
            return {
                "disk_entries": len(self._mem),
                "compactions": self.compactions,
                "dropped_superseded": self.dropped_superseded,
                "dropped_lru": self.dropped_lru,
                "corrupt_records": self.corrupt_records,
                "dropped_corrupt": self.dropped_corrupt,
            }

    def clear(self) -> None:
        """Drop every persisted entry (truncates the store file)."""
        with self._lock:
            with open(self._file, "w"):
                pass
            self._mem.clear()
            self._offset = 0
            self._file_records = 0

    def entries(self) -> List[Tuple[Any, Any]]:
        """(key, value) of every record under this process's toolchain
        salt, the file's newest state, keys as their JSON form (tuples as
        lists)."""
        salt = _toolchain_salt()
        out = []
        with self._lock:
            self._read_new()
            for ck, value in self._mem.items():
                try:
                    rec = json.loads(ck)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("toolchain") == salt:
                    out.append((rec.get("key"), value))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)
