"""Shared, thread-safe evaluation cache for NAS candidate costs.

Hardware-in-the-loop NAS is dominated by repeated compilation of
identical architectures: samplers revisit points (grid wrap-around,
evolution inheriting whole configurations, TPE exploitation), and every
compiled-cost estimator used to re-generate its own artifact.  This
module centralizes the memoization:

  * keys are built from the candidate's *full* architecture signature
    (layers AND pre-processing — see ``ArchitectureIR.signature``) plus
    the estimator-specific context (target, batch), so distinct programs
    never collide;
  * one :class:`EvaluationCache` can be shared by several estimators —
    ``CompiledLatencyEstimator`` and ``CompiledMemoryEstimator`` reuse
    the same generated ``Artifact`` instead of compiling twice;
  * lookups are single-flight: when several ``ParallelStudy`` workers
    race on the same key, exactly one computes while the rest wait for
    the result instead of duplicating an XLA compile;
  * an optional **disk tier** (:class:`DiskEvaluationCache`) persists the
    JSON-serializable values (estimator scalars, not compiled
    executables) across process restarts and between process-pool
    workers sharing the store directory, so a warm-restarted study
    performs zero XLA compiles for architectures the host has already
    paid for.  Owners check the disk tier before computing and write
    computed values through to it.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, Hashable, Optional, Union

from repro_torch.evaluation.disk_cache import DiskEvaluationCache


@dataclasses.dataclass
class CacheStats:
    hits: int = 0        # served from the in-memory tier
    disk_hits: int = 0   # served from the disk tier (no compute, no compile)
    misses: int = 0      # actually computed

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.disk_hits + self.misses
        return (self.hits + self.disk_hits) / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "disk_hits": self.disk_hits,
                "misses": self.misses, "hit_rate": self.hit_rate}


class EvaluationCache:
    """Thread-safe, single-flight memoization keyed by hashable tuples.

    ``disk`` may be a :class:`DiskEvaluationCache`, a path (store
    directory, created if needed), or ``True`` for the default
    ``results/cache/`` store.  Without it the cache is memory-only.
    """

    def __init__(self, disk: Union[DiskEvaluationCache, str, os.PathLike, bool, None] = None):
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, Any] = {}
        self._inflight: Dict[Hashable, threading.Event] = {}
        # bumped by clear(); an owner whose computation started before a
        # clear() must not resurrect its (now stale) entry afterwards
        self._generation = 0
        self.stats = CacheStats()
        # identity/type checks, NOT truthiness: an empty DiskEvaluationCache
        # is falsy via __len__ but is still a live tier
        if isinstance(disk, DiskEvaluationCache):
            pass
        elif disk is True:
            disk = DiskEvaluationCache()
        elif isinstance(disk, (str, os.PathLike)) and str(disk):
            disk = DiskEvaluationCache(str(disk))
        else:  # None / False / "": memory-only
            disk = None
        self.disk: Optional[DiskEvaluationCache] = disk

    # -- key construction ------------------------------------------------------

    @staticmethod
    def candidate_key(candidate: Any) -> Optional[str]:
        """Identity of a candidate: the full architecture signature, or
        None when the candidate has no arch.  None means "don't cache":
        an object-id fallback would be unsound in a long-lived shared
        cache (a freed candidate's address can be reused by a different
        model, silently returning the wrong cost)."""
        arch = getattr(candidate, "arch", None)
        if arch is not None:
            return arch.signature()
        return None

    # -- core ------------------------------------------------------------------

    def get_or_compute(self, key: Hashable, compute: Callable[[], Any]) -> Any:
        """Return the cached value for ``key``, computing it at most once
        across concurrent callers (single-flight).  A key of None (or a
        tuple containing None, as produced for uncacheable candidates)
        bypasses the cache entirely.  Owners consult the disk tier before
        computing and write computed values through to it."""
        if key is None or (isinstance(key, tuple) and any(k is None for k in key)):
            return compute()
        while True:
            with self._lock:
                if key in self._entries:
                    self.stats.hits += 1
                    return self._entries[key]
                event = self._inflight.get(key)
                if event is None:
                    event = threading.Event()
                    self._inflight[key] = event
                    generation = self._generation
                    break  # we own the computation
            # another worker is computing this key: wait, then re-check
            # (re-loop handles the owner failing with an exception)
            event.wait()
        # We own the key.  Whatever happens below — disk I/O error,
        # compute failure, success — the finally releases ownership and
        # wakes waiters, so a failure can never strand them in wait().
        try:
            # disk read-through (file I/O outside the lock): a value
            # persisted by an earlier run — or a sibling process — costs
            # no compute
            if self.disk is not None:
                found, value = self.disk.lookup(key)
                if found:
                    with self._lock:
                        if generation == self._generation:
                            self._entries[key] = value
                            self.stats.disk_hits += 1
                    return value
            with self._lock:
                self.stats.misses += 1
            value = compute()
            with self._lock:
                persist = generation == self._generation
                if persist:
                    self._entries[key] = value
            # Write-through outside the cache lock: the flock+fsync must
            # not stall sibling memory hits.  The persist *decision* is
            # generation-checked above, so a completed clear() is always
            # respected; only a clear(disk=True) racing this very append
            # can leave one stale record on disk — the same exposure as a
            # sibling process appending after the truncate.  Cross-process
            # invalidation is best-effort by design: delete the store
            # directory for a guaranteed rebuild.
            if persist and self.disk is not None:
                self.disk.store(key, value)
            return value
        finally:
            with self._lock:
                if self._inflight.get(key) is event:
                    del self._inflight[key]
            event.set()

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            return self._entries.get(key, default)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self, disk: bool = False) -> None:
        """Drop every entry and reset stats.  In-flight computations lose
        ownership atomically: their callers still receive the value they
        computed, but it is neither cached nor written to disk, so a
        compute finishing after ``clear()`` can never resurrect a stale
        entry.  Waiters are woken and recompute fresh.  The disk tier is
        kept unless ``disk=True``."""
        with self._lock:
            self._generation += 1
            self._entries.clear()
            inflight, self._inflight = self._inflight, {}
            self.stats = CacheStats()
            if disk and self.disk is not None:
                # truncate under the cache lock: an owner doing a disk
                # read-through after the generation bump must find the
                # store already wiped, or it would cache the stale value
                # under the new generation (lock order cache -> disk
                # matches the store path)
                self.disk.clear()
        for event in inflight.values():
            event.set()
