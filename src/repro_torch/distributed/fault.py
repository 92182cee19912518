"""Fault-tolerance utilities: preemption handling and straggler
detection, the JAX package's ``distributed/fault.py`` on the port.

The mechanisms (atomic checkpoints, deterministic step-indexed data,
resume from the newest complete checkpoint) are exercised on one device.
The reference's ``elastic_remesh`` builds the largest mesh the device
population supports; it waits for the port's meshes (ROADMAP Queue 1 item
13), as does restoring a checkpoint onto another sharding.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, List, Optional


class PreemptionHandler:
    """SIGTERM/SIGINT -> set a flag the training loop polls; the loop then
    flushes a final checkpoint and exits cleanly."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except ValueError:  # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def restore(self):
        for s, h in self._old.items():
            signal.signal(s, h)


class StragglerMonitor:
    """Tracks per-step wall time; flags steps slower than ``threshold`` x
    the trailing median.  On multi-host pods the flagged host triggers
    data-shard reassignment (the deterministic pipeline makes that free).
    """

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.durations: List[float] = []
        self.flags = 0

    def record(self, seconds: float) -> bool:
        self.durations.append(seconds)
        hist = self.durations[-self.window:]
        if len(hist) < 5:
            return False
        med = sorted(hist)[len(hist) // 2]
        slow = seconds > self.threshold * med
        if slow:
            self.flags += 1
        return slow


def with_retries(fn: Callable, retries: int = 3, backoff: float = 1.0,
                 on_error: Optional[Callable] = None):
    """Retry wrapper for transient runtime failures (collective timeouts,
    flaky hosts)."""

    def wrapped(*args, **kwargs):
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if attempt == retries:
                    raise
                if on_error:
                    on_error(e, attempt)
                time.sleep(backoff * (2 ** attempt))

    return wrapped
