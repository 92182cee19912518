"""Fault-tolerance utilities: preemption handling, elastic re-meshing and
straggler detection, the JAX package's ``distributed/fault.py`` on the
port.

The mechanisms (atomic checkpoints, restore onto another mesh's
placements, deterministic step-indexed data, resume from the newest
complete checkpoint) pair with the cluster scheduler: SIGTERM before
preemption, and the process group's world for membership.
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


def elastic_remesh(preferred_shape, axes, min_model: int = 1):
    """Build the largest mesh the *current* process group supports.

    After a failure shrinks the pool (or a restart grows it), training
    resumes on the new mesh: checkpoints restore onto its placements, so
    no state is lost.  The model axis is the preferred one, capped at the
    world and halved until it divides it (not below ``min_model``); the
    data axis takes the rest."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    data, model = preferred_shape[-2], preferred_shape[-1]
    model = min(model, n)
    while model > min_model and n % model:
        model //= 2
    data = n // model
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((data, model), axes[-2:])


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
