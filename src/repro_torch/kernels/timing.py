"""Timing of kernel calls on the card: CUDA events around back-to-back
calls, and the kernels' own device time from ``torch.profiler``.  Used by
``chip_smoke.py`` and the variant scripts under ``scripts/``; nothing of the
port's path calls it."""
from __future__ import annotations

import statistics
import subprocess

import torch


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else \
        f"nvidia-smi failed: {proc.stderr.strip()}"


def event_ms(fn, warmup=3, runs=20, calls=10) -> float:
    """Milliseconds of one call of ``fn``: the median over ``runs`` pairs
    of CUDA events, each around ``calls`` back-to-back calls, after
    ``warmup`` calls.  That is the device time only while the device is
    the slower side; a call whose kernels are shorter than its host path
    (checks, ctypes, launch) leaves the device idle between launches, and
    the events then time the host's rate.  :func:`device_times` reads the
    kernels' own time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_times(fn, warmup=3, calls=20) -> dict:
    """Device milliseconds of one call of ``fn`` by kernel name: the time of
    the kernels it launches under ``torch.profiler``, summed over ``calls``
    calls, over ``calls``; the gaps between launches do not count."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / 1e3 / calls for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")}


def measured(ms):
    """``ms``, or "not measured" where the profiler saw no device time."""
    return ms if ms > 0 else "not measured"


def device_ms(fn, warmup=3, calls=20, name=""):
    """Device milliseconds of one call of ``fn`` (:func:`device_times`),
    summed over its kernels whose names contain ``name``."""
    times = device_times(fn, warmup, calls)
    return measured(sum(ms for key, ms in times.items() if name in key))
