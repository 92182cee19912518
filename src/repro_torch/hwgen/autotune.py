"""Per-target kernel schedule autotuning (the JAX package's
``hwgen/autotune.py``, on the port's CUDA kernels).

The same candidate architecture gets its kernels' block/chunk parameters
tuned per target and cached next to its measured values.
:class:`ScheduleTuner` sweeps the small candidate grid in
:data:`repro_torch.kernels.schedule.CANDIDATE_SCHEDULES` on synthetic
inputs at the call's real shapes (drawn from a ``torch.Generator`` seeded
0 on the target's device), times each candidate — CUDA events around
``iters`` calls after ``warmup`` on the card, the host clock on the CPU —
under the shared measurement gate, and memoizes the winner in the
(optionally disk-backed) evaluation cache keyed by
``(kernel, shape_bucket, mesh_scope)`` — so a warm restart re-tunes
nothing, and same-topology targets share tuned schedules exactly like
they share artifacts.  Each timed candidate's record carries the tiles
the CUDA kernel launched for it (``launched``) beside its requested and
effective schedules.

Shape buckets round every dimension up to the next power of two and fold
in the masking flags, so nearby shapes (which want the same blocking)
share one sweep instead of each paying their own.

Records are plain JSON dicts on purpose: the flock-safe disk cache
persists JSON-able values only, and the ``schedule`` field holds the
*requested* (validated, power-of-two) winner — re-loadable via
``as_schedule`` — while ``effective`` documents what that request
clamped to at the swept shapes.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.envvars import read_env
from repro_torch.hwgen.generator import collector_off, measurement_gate, meta_forward
from repro_torch.kernels import ops as kops
from repro_torch.kernels import schedule as ksched
from repro_torch.kernels.schedule import KernelSchedule

# the documented default of REPRO_TUNE_BUDGET (covers every built-in grid)
DEFAULT_BUDGET = 8

KernelCalls = Dict[Tuple[str, str], Dict[str, Any]]


def discover_kernel_calls(fn: Callable, example_args: Tuple) -> KernelCalls:
    """Which schedulable kernels does ``fn`` reach, at what shapes?

    Runs ``fn`` on the ``meta`` device under the call recorder (the
    reference traces it with ``jax.eval_shape``): the kernel wrappers
    record the call and return empty outputs, so discovery costs
    milliseconds and never copies a weight to the card."""
    sink: KernelCalls = {}
    with ksched.record_kernel_calls(sink):
        meta_forward(fn, example_args)
    return sink


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class ScheduleTuner:
    """Sweeps schedule candidates per (kernel, shape-bucket, target).

    ``budget`` (explicit spec value, else ``REPRO_TUNE_BUDGET``) caps how
    many candidates each sweep times; grids are default-first, so budget
    1 degenerates to the named default.  ``overrides`` pins kernels to a
    fixed schedule — pinned kernels are never swept.  Thread-safe: the
    cache provides single-flight per key, the stats counter has its own
    lock.
    """

    def __init__(self, target, cache=None, budget: Optional[int] = None,
                 overrides: Optional[Mapping[str, Any]] = None,
                 warmup: int = 1, iters: int = 3):
        self.target = target
        self.device = resolve_device(target.device)
        self.cache = cache
        self._budget = budget
        self.overrides: Dict[str, KernelSchedule] = {
            kernel: ksched.as_schedule(kernel, value)
            for kernel, value in (overrides or {}).items()
        }
        self.warmup = warmup
        self.iters = iters
        self._lock = threading.Lock()
        self._stats = {"tunes": 0, "cache_hits": 0, "tune_time_s": 0.0}
        self._records: Dict[Tuple[str, str], Dict[str, Any]] = {}

    @property
    def budget(self) -> int:
        if self._budget is not None:
            return max(1, int(self._budget))
        return read_env("REPRO_TUNE_BUDGET", DEFAULT_BUDGET)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._stats)

    def records(self) -> list:
        """Every tuning record this tuner has seen — swept or read from the
        cache in this process, and, with a disk-backed cache, those for
        this target's mesh scope in the store (a process backend's workers
        write theirs there) — in (kernel, bucket) order."""
        with self._lock:
            found = dict(self._records)
        disk = getattr(self.cache, "disk", None)
        if disk is not None:
            for key, value in disk.entries():
                if (isinstance(key, list) and len(key) == 4 and key[0] == "kernel_schedule"
                        and key[3] == self.target.mesh_scope and isinstance(value, dict)):
                    found.setdefault((key[1], key[2]), value)
        return [found[k] for k in sorted(found)]

    # -- planning -----------------------------------------------------------

    def plan(self, calls: KernelCalls) -> Dict[str, KernelSchedule]:
        """Tuned (or pinned) schedule per kernel in a discovered call
        set; the mapping feeds straight into ``use_schedules`` /
        ``XLAGenerator.generate(schedules=...)``."""
        schedules: Dict[str, KernelSchedule] = {}
        for entry in calls.values():
            kernel = entry["kernel"]
            if kernel in schedules:
                continue
            if kernel in self.overrides:
                schedules[kernel] = self.overrides[kernel]
                continue
            record = self.tune(kernel, entry["shapes"], entry["meta"])
            schedules[kernel] = ksched.as_schedule(kernel, record["schedule"])
        return schedules

    # -- tuning -------------------------------------------------------------

    def shape_bucket(self, kernel: str, shapes: Mapping[str, Tuple[int, ...]],
                     meta: Mapping[str, Any]) -> str:
        dims = ";".join(
            f"{name}={'x'.join(str(_pow2_ceil(d)) for d in shape)}"
            for name, shape in sorted(shapes.items()))
        flags = ",".join(f"{k}={meta[k]}" for k in sorted(meta))
        return f"{dims}|{flags}"

    def tune(self, kernel: str, shapes: Mapping[str, Tuple[int, ...]],
             meta: Mapping[str, Any]) -> Dict[str, Any]:
        """Best schedule for this call site, from cache or a fresh sweep."""
        bucket = self.shape_bucket(kernel, shapes, meta)
        swept: list = []

        def sweep() -> Dict[str, Any]:
            swept.append(True)
            return self._sweep(kernel, shapes, meta, bucket)

        if self.cache is not None:
            key = ("kernel_schedule", kernel, bucket, self.target.mesh_scope)
            record = self.cache.get_or_compute(key, sweep)
        else:
            record = sweep()
        with self._lock:
            if swept:
                self._stats["tunes"] += 1
                self._stats["tune_time_s"] += float(record["tune_time_s"])
            else:
                self._stats["cache_hits"] += 1
            self._records[(kernel, bucket)] = record
        return record

    def _sweep(self, kernel: str, shapes: Mapping[str, Tuple[int, ...]],
               meta: Mapping[str, Any], bucket: str) -> Dict[str, Any]:
        # the synthetic inputs are drawn on the device: no sibling's timing
        # may run beside that either
        with measurement_gate(self.device):
            run, seq_len, kv_len = self._runner(kernel, shapes, meta)
        # dedupe by *effective* signature: two requests that clamp to the
        # same launch would time (and later measure) the same program; on
        # the card also by the tiles the CUDA flash kernel launches for
        # them (several effective block pairs map onto one built pair)
        seen: Dict[str, KernelSchedule] = {}
        launches = set()
        for cand in ksched.CANDIDATE_SCHEDULES[kernel]:
            eff = ksched.effective_schedule(kernel, cand, seq_len=seq_len,
                                            kv_len=kv_len)
            tiles = self._launched_tiles(kernel, eff, shapes, meta)
            if tiles is not None and tiles in launches:
                continue
            launches.add(tiles)
            seen.setdefault(ksched.schedule_signature(kernel, eff), cand)
            if len(seen) >= self.budget:
                break
        t_start = time.perf_counter()
        timed = []
        for eff_sig, cand in seen.items():
            # measurements must not overlap a sibling's forwards or timings
            # (same rationale as HardwareManager.benchmark)
            sink: KernelCalls = {}
            with measurement_gate(self.device), torch.inference_mode(), collector_off():
                with ksched.record_kernel_calls(sink):
                    run(cand)
                for _ in range(self.warmup - 1):
                    run(cand)
                latency = self._time(run, cand)
            (call,) = sink.values()
            timed.append((latency, cand, eff_sig, call["launched"]))
        # stable min: the default candidate is first, so a tie keeps it
        best_latency, best, best_eff_sig, best_launched = min(timed, key=lambda t: t[0])
        best_eff = ksched.effective_schedule(kernel, best, seq_len=seq_len,
                                             kv_len=kv_len)
        return {
            "kernel": kernel,
            "bucket": bucket,
            "schedule": best.to_dict(),
            "effective": best_eff.to_dict(),
            "launched": best_launched,
            "latency_s": best_latency,
            "default_latency_s": timed[0][0],
            "n_candidates": len(timed),
            "candidates": [
                {"schedule": cand.to_dict(), "effective": sig,
                 "launched": launched, "latency_s": lat}
                for lat, cand, sig, launched in timed
            ],
            "tune_time_s": time.perf_counter() - t_start,
        }

    def _launched_tiles(self, kernel: str, eff: KernelSchedule,
                        shapes: Mapping[str, Tuple[int, ...]],
                        meta: Mapping[str, Any]) -> Optional[Tuple[int, int]]:
        """The tile pair the CUDA flash kernel launches for ``eff`` on this
        tuner's device; None elsewhere (the CPU runs the plain version, and
        a scan launches its effective chunk)."""
        if kernel != "flash_attention" or self.device.type != "cuda":
            return None
        return kops.flash_launch_tiles(eff.block_q, eff.block_kv, shapes["q"][-1],
                                       getattr(torch, meta.get("dtype", "float32")))

    def _time(self, run: Callable, cand: KernelSchedule) -> float:
        """Seconds of one call of ``run(cand)``, the mean over ``iters``
        back-to-back calls: CUDA events around them on the card (the
        device's time), the host clock on the CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.iters):
                run(cand)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / self.iters
        t0 = time.perf_counter()
        for _ in range(self.iters):
            run(cand)
        return (time.perf_counter() - t0) / self.iters

    # -- synthetic inputs ---------------------------------------------------

    def _runner(self, kernel: str, shapes: Mapping[str, Tuple[int, ...]],
                meta: Mapping[str, Any]):
        """(closure timing one candidate, seq_len, kv_len) with synthetic
        inputs at the call's real shapes on the target's device, drawn
        from a generator seeded 0 (the reference's values differ: the two
        frameworks' generators differ, and only the shapes matter here)."""
        dtype = getattr(torch, meta.get("dtype", "float32"))
        gen = torch.Generator(device=self.device).manual_seed(0)

        def normal(shape):
            return torch.randn(tuple(shape), generator=gen, device=self.device,
                               dtype=torch.float32).to(dtype)

        if kernel == "flash_attention":
            q = normal(shapes["q"])
            k = normal(shapes["k"])
            v = normal(shapes["v"])

            def run(cand):
                return kops.flash_attention(
                    q, k, v, causal=bool(meta.get("causal", True)),
                    window=meta.get("window"), scale=meta.get("scale"),
                    schedule=cand)
            return run, shapes["q"][1], shapes["k"][1]

        if kernel == "ssm_scan":
            x = normal(shapes["x"])
            dt = F.softplus(normal(shapes["dt"]))
            a = -torch.exp(normal(shapes["a"]))
            b = normal(shapes["b"])
            c = normal(shapes["c"])

            def run(cand):
                return kops.ssm_scan(x, dt, a, b, c, schedule=cand)
            return run, shapes["x"][1], None

        if kernel == "mlstm_scan":
            q = normal(shapes["q"])
            k = normal(shapes["k"])
            v = normal(shapes["v"])
            i_log = normal(shapes["i_log"])
            f_log = normal(shapes["f_log"])

            def run(cand):
                return kops.mlstm_scan(q, k, v, i_log, f_log, schedule=cand)
            return run, shapes["q"][1], None

        raise ksched.ScheduleError(
            f"no tuning recipe for kernel {kernel!r}")
