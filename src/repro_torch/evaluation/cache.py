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
  * the port keeps the in-memory tier only: the disk tier, whose keys
    need the port's own toolchain salt (torch, CUDA and a framework
    tag), comes with the next slice (ROADMAP.md, Queue 1 item 2).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable


@dataclasses.dataclass
class CacheStats:
    hits: int = 0        # served from memory
    misses: int = 0      # actually computed

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate}


class EvaluationCache:
    """Thread-safe, single-flight memoization keyed by hashable tuples,
    in memory.  ``disk`` must be left unset: the disk tier waits for the
    port's toolchain salt (ROADMAP.md, Queue 1 item 2)."""

    def __init__(self, disk=None):
        if disk not in (None, False, ""):
            raise NotImplementedError(
                "the port's EvaluationCache is memory-only: the disk tier "
                "needs the port's toolchain salt (torch, CUDA and a framework "
                "tag) and is ROADMAP.md Queue 1 item 2 (the disk tier)")
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, Any] = {}
        self._inflight: Dict[Hashable, threading.Event] = {}
        # bumped by clear(); an owner whose computation started before a
        # clear() must not resurrect its (now stale) entry afterwards
        self._generation = 0
        self.stats = CacheStats()

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
        bypasses the cache entirely."""
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
        # We own the key.  Whatever happens below, the finally releases
        # ownership and wakes waiters, so a failure can never strand them
        # in wait().
        try:
            with self._lock:
                self.stats.misses += 1
            value = compute()
            with self._lock:
                if generation == self._generation:
                    self._entries[key] = value
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

    def clear(self) -> None:
        """Drop every entry and reset stats.  In-flight computations lose
        ownership atomically: their callers still receive the value they
        computed, but it is not cached, so a compute finishing after
        ``clear()`` can never resurrect a stale entry.  Waiters are woken
        and recompute fresh."""
        with self._lock:
            self._generation += 1
            self._entries.clear()
            inflight, self._inflight = self._inflight, {}
            self.stats = CacheStats()
        for event in inflight.values():
            event.set()
