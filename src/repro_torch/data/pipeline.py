"""Deterministic synthetic data pipeline with host sharding + prefetch,
the JAX package's ``data/pipeline.py``, copied: it is numpy only, and the
port keeps its own copy, which gives the reference's arrays bit for bit.

Pod-scale properties:
  * deterministic by (seed, step, host): any host can regenerate any
    shard — restarts and *elastic re-assignment* (a host taking over a
    failed peer's shard) need no data-state checkpoint beyond the step
    counter;
  * straggler-tolerant: batches are indexed by step, so a host that
    skips/repeats work cannot desynchronize the global batch contents;
  * double-buffered prefetch thread overlaps host data generation with
    device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLMData:
    """Zipf-ish token stream with a fixed structure so loss decreases
    measurably when models train (markov-flavored transitions)."""

    def __init__(self, vocab: int, seq: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.seq = seq
        self.host_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.host_id, step))
        b, s, v = self.host_batch, self.seq, self.vocab
        # second-order structure: x[t+1] = (a*x[t] + noise) % v
        base = rng.integers(0, v, (b, 1))
        mult = rng.integers(2, 8, (b, 1))
        noise = rng.integers(0, max(2, v // 64), (b, s))
        tokens = np.zeros((b, s), np.int64)
        tokens[:, 0:1] = base
        for t in range(1, s):
            tokens[:, t] = (tokens[:, t - 1] * mult[:, 0] + noise[:, t]) % v
        labels = np.roll(tokens, -1, axis=1)
        return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch over a step-indexed source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            self._q.put((step, batch))
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break


class SyntheticClassificationData:
    """(B, L, C) sensor-like streams for the NAS example spaces."""

    def __init__(self, n: int, length: int, channels: int, classes: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        t = np.linspace(0, 1, length)[None, :, None]
        self.y = rng.integers(0, classes, n)
        # Two class signals so the label survives any searched pre-processing:
        # amplitude (destroyed by per-sample normalization) AND a disjoint
        # frequency band per class (normalization-invariant).
        band = 28.0 / classes
        lo = 2.0 + self.y[:, None, None] * band
        freqs = lo + rng.uniform(0, 1, (n, 1, channels)) * band
        phase = rng.uniform(0, 2 * np.pi, (n, 1, channels))
        amp = 1.0 + self.y[:, None, None] * 0.35
        self.x = (amp * np.sin(2 * np.pi * freqs * t + phase)
                  + 0.3 * rng.standard_normal((n, length, channels))).astype(np.float32)
        self.y = self.y.astype(np.int32)

    def split(self, frac: float = 0.8):
        k = int(len(self.y) * frac)
        return {
            "x_train": self.x[:k], "y_train": self.y[:k],
            "x_val": self.x[k:], "y_val": self.y[k:],
        }
