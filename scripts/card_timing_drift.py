"""How much a timing on the card depends on what else goes on: the card's
recent load, the host's garbage collector, a sibling process ending.

Times a NAS candidate as the port's ``latency_s`` measures it
(``TorchGenerator.generate``, then ``HardwareManager.benchmark``: the
candidate placed, 2 warm-up forwards, 10 between two CUDA events) and a
bf16 matmul window, while ``nvidia-smi`` samples the card's SM clock,
power, temperature and throttle reasons every 50 ms and ``gc.callbacks``
logs Python's collections.  Parts, in order:

* ``nas_collector_on``: after 5 s idle, ``--windows`` benchmarks back to
  back with the collector left on during the timing (the port's timing
  before ``collector_off``);
* ``nas_sustained``: the same with ``HardwareManager.benchmark`` as it
  is;
* ``nas_collect_forced``: 8 benchmarks, each with a full collection
  (``gc.collect()``) just before the first timed forward;
* ``nas_rested_<s>``: 8 benchmarks, each after ``s`` seconds idle, for
  s = 2, 1 and 0.25;
* ``bf16_sustained``: after 5 s idle, ``--windows`` windows of 40 bf16
  steps (4 matmuls of 8192 and a 1 GiB multiply each), back to back;
* ``sibling_exit``: a child process holding 4 GiB of card memory in its
  allocator's cache is sent SIGTERM as a bf16 window opens; that window
  over the median of the 5 before it, with the child alive and idle;
* ``explore``: ``--runs`` serial runs of ``chip_smoke.py``'s explore spec,
  each on a fresh cache (so each tunes and measures anew), in turns with
  as many whose every benchmark first empties the allocator's cache
  (``explore_emptied``): each trial's ``latency_s`` over its median.

The candidate is trial 2 of ``chip_smoke.py``'s NAS space under the
random sampler at seed 0 (ssm + attention at zamba2-2.7b's widths, batch
4), fp32 with TF32 off, the kernels on their default schedules.  Each
window prints a ``DRIFT`` line (ms, over the part's first window, the
samples' mean clock, power and temperature and the throttle reasons
seen, and the collections that started in it, by generation, with the
longest's ms); each part a ``DRIFT_PART`` summary.  ``--parts`` picks
``nas``, ``bf16``, ``sibling`` and ``explore`` (default all).  Run from
the root of a checkout on a machine with a card:

    PYTHONPATH=src python scripts/card_timing_drift.py [--windows N] [--parts P,...]
"""
import argparse
import contextlib
import dataclasses
import datetime
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the NAS space and batch)
from repro_torch.core.builder import ModelBuilder  # noqa: E402
from repro_torch.core.space import parse_search_space  # noqa: E402
from repro_torch.core.translate import sample_architecture  # noqa: E402
from repro_torch.explorer.explorer import Explorer  # noqa: E402
from repro_torch.hwgen import generator  # noqa: E402
from repro_torch.hwgen.generator import (Artifact, HardwareManager,  # noqa: E402
                                         TorchGenerator, measurement_gate)
from repro_torch.kernels import build, timing  # noqa: E402
from repro_torch.search.samplers import RandomSampler  # noqa: E402
from repro_torch.search.study import Study  # noqa: E402

PARTS = ("nas", "bf16", "sibling", "explore")
QUERY = "timestamp,clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active"
CHILD = """
import signal, sys, time
import torch
x = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")
(torch.randn(4096, 4096, device="cuda") @ torch.randn(4096, 4096, device="cuda")).sum().item()
del x
signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
print("ready", flush=True)
while True:
    time.sleep(0.05)
"""


class Sampler:
    """``nvidia-smi`` sampling the card every 50 ms on a child process;
    ``window(t0, t1)`` is the samples' summary between two epoch times."""

    def __init__(self):
        self.rows = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            try:
                t = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.rows.append((t, float(parts[1]), float(parts[2]), float(parts[3]),
                                  parts[4]))
            except (ValueError, IndexError):
                continue

    def window(self, t0, t1) -> dict:
        seen = [r for r in list(self.rows) if t0 <= r[0] <= t1]
        if not seen:
            return {"samples": 0}
        return {"samples": len(seen),
                "sm_mhz": statistics.mean(r[1] for r in seen),
                "power_w": statistics.mean(r[2] for r in seen),
                "temp_c": max(r[3] for r in seen),
                "reasons": sorted({r[4] for r in seen})}

    def stop(self):
        self.proc.terminate()
        self.proc.wait(timeout=30)


class Collections:
    """Python's collections, logged by ``gc.callbacks``: each one's start,
    generation and seconds."""

    def __init__(self):
        self.rows, self._start = [], None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._start = time.time()
        elif self._start is not None:
            self.rows.append((self._start, info["generation"], time.time() - self._start))

    def window(self, t0, t1) -> dict:
        seen = [r for r in list(self.rows) if t0 <= r[0] <= t1]
        return {"collections": [sum(r[1] == g for r in seen) for g in range(3)],
                "longest_collection_ms": max((r[2] * 1e3 for r in seen), default=0.0)}


@dataclasses.dataclass
class CollectFirst(Artifact):
    """An artifact that runs a full collection before its first timed
    forward (after ``warmup`` calls) and keeps the collection's seconds."""

    warmup: int = 2
    calls: int = 0
    collect_s: float = 0.0

    def __call__(self, *args):
        self.calls += 1
        if self.calls == self.warmup + 1:
            t0 = time.perf_counter()
            gc.collect()
            self.collect_s = time.perf_counter() - t0
        return super().__call__(*args)


def nas_artifact():
    """Trial 2's candidate, generated for ``h100`` as ``latency_s`` does."""
    space = parse_search_space(chip_smoke.NAS_SPACE)
    builder = ModelBuilder(space.input_shape, space.output_dim)
    archs = []
    Study(name="drift", sampler=RandomSampler(seed=0)).optimize(
        lambda trial: archs.append(sample_architecture(space, trial)) or 0.0, 3)
    candidate = builder.build(archs[2])
    device = torch.device("cuda")
    with measurement_gate(device):
        model = candidate.init(torch.Generator(device=device).manual_seed(0), device).to("cpu")
    l, c = candidate.input_shape[-1], candidate.input_shape[0]
    x = torch.zeros((chip_smoke.NAS_BATCH, l, c), dtype=torch.float32)
    return archs[2].signature(), TorchGenerator("h100").generate(model, (x,))


def bf16_window():
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(8192, 8192, device=device, dtype=torch.bfloat16, generator=gen)
    b = torch.randn(8192, 8192, device=device, dtype=torch.bfloat16, generator=gen)
    y = torch.randn(1 << 28, device=device, generator=gen)

    def step():
        for _ in range(4):
            torch.mm(a, b)
        y.mul_(1.0000001)

    def window(during=None) -> float:
        with measurement_gate(device):
            for _ in range(2):
                step()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(40):
                step()
            if during is not None:
                during()
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3
    return window


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--windows", type=int, default=60)
    parser.add_argument("--runs", type=int, default=8)
    parser.add_argument("--parts", default=",".join(PARTS))
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    sampler = Sampler()
    signature, artifact = nas_artifact()
    manager = HardwareManager()
    bf16 = bf16_window()
    print("DRIFT_SETUP " + json.dumps({"card": timing.card(), "candidate": signature}), flush=True)

    collections = Collections()

    def run(part, timed, n, rest_s=0.0, idle_s=0.0):
        time.sleep(idle_s)
        rows = []
        for i in range(n):
            time.sleep(rest_s)
            t0 = time.time()
            seconds = timed()
            t1 = time.time()
            if isinstance(seconds, tuple):
                seconds, extra = seconds
            else:
                extra = {}
            rows.append({"part": part, "i": i, "ms": seconds * 1e3, **extra,
                         **sampler.window(t0, t1), **collections.window(t0, t1)})
        for row in rows:
            row["over_first"] = row["ms"] / rows[0]["ms"]
            print("DRIFT " + json.dumps(row), flush=True)
        over = [r["ms"] / statistics.median(x["ms"] for x in rows) for r in rows]
        clocks = [r["sm_mhz"] for r in rows if "sm_mhz" in r]
        print("DRIFT_PART " + json.dumps({
            "part": part, "n": n, "median_ms": statistics.median(r["ms"] for r in rows),
            "over_median_min_max": [min(over), max(over)],
            "sm_mhz_min_max": [min(clocks), max(clocks)] if clocks else "not measured"}),
            flush=True)

    nas = lambda: manager.benchmark(artifact)["latency_s"]  # noqa: E731

    def collect_first():
        forced = CollectFirst(**{f.name: getattr(artifact, f.name)
                                 for f in dataclasses.fields(Artifact)},
                              warmup=manager.warmup)
        seconds = manager.benchmark(forced)["latency_s"]
        return seconds, {"collect_ms": forced.collect_s * 1e3}

    if "nas" in parts:
        with mock.patch.object(generator, "collector_off", contextlib.nullcontext):
            run("nas_collector_on", nas, args.windows, idle_s=5.0)
        run("nas_sustained", nas, args.windows, idle_s=5.0)
        run("nas_collect_forced", collect_first, 8)
        for rest_s in (2.0, 1.0, 0.25):
            run(f"nas_rested_{rest_s:g}", nas, 8, rest_s=rest_s)
    if "bf16" in parts:
        run("bf16_sustained", bf16, args.windows, idle_s=5.0)
    if "sibling" in parts:
        sibling_exit(bf16)
    if "explore" in parts:
        explore_runs(args.runs)
    sampler.stop()
    return 0


def explore_runs(n) -> None:
    """``n`` pairs of serial explore runs, plain and with every benchmark
    emptying the allocator's cache first."""
    benchmark = HardwareManager.benchmark

    def emptied(self, artifact):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return benchmark(self, artifact)

    runs = {"explore": [], "explore_emptied": []}
    for _ in range(n):
        for part in runs:
            patch = (mock.patch.object(HardwareManager, "benchmark", emptied)
                     if part == "explore_emptied" else contextlib.nullcontext())
            with tempfile.TemporaryDirectory(prefix="drift-") as tmp, patch:
                explorer = Explorer.from_dict(chip_smoke.explore_spec("serial", 1, tmp))
                explorer.run(save_report=False)
            runs[part].append({t.number: t.user_attrs["latency_s"] for t in explorer.study.trials})
    for part, rows in runs.items():
        median = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        for i, row in enumerate(rows):
            print("DRIFT " + json.dumps({"part": part, "i": i, "ms": {k: v * 1e3 for k, v in row.items()},
                                         "over_median": {k: v / median[k] for k, v in row.items()}}))
        print("DRIFT_PART " + json.dumps({
            "part": part, "n": len(rows), "median_ms": {k: v * 1e3 for k, v in median.items()},
            "over_median_min_max": {k: [min(r[k] / median[k] for r in rows),
                                        max(r[k] / median[k] for r in rows)] for k in median}}),
              flush=True)


def sibling_exit(bf16) -> None:
    """Three children ended by SIGTERM as a bf16 window opens."""
    exits = []
    for rep in range(3):
        child = subprocess.Popen([sys.executable, "-c", CHILD], stdout=subprocess.PIPE,
                                 text=True, env=dict(os.environ))
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError(f"the child did not start: exit {child.wait()}")
        base = statistics.median(bf16() for _ in range(5))
        during = bf16(lambda: os.kill(child.pid, signal.SIGTERM))
        child.wait(timeout=120)
        exits.append(during / base)
        print("DRIFT " + json.dumps({"part": "sibling_exit", "i": rep,
                                     "over_quiet_median": during / base}), flush=True)
    print("DRIFT_PART " + json.dumps({"part": "sibling_exit", "n": len(exits),
                                      "over_quiet_median_min_max": [min(exits), max(exits)]}))


if __name__ == "__main__":
    sys.exit(main())
