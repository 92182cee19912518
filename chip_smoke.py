#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100, ``sm_90a``).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure
(and the script then exits non-zero and prints no result line):

1. environment: the card (``nvidia-smi``), torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN, so fp32 means fp32;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` is compiled
   from the checkout's sources;
3. each kernel against its plain PyTorch version on the card, fp32 and
   bf16, with the time of the kernel, of the plain version and of one
   PyTorch library call computing the same function where there is one
   (CUDA events around 10 back-to-back calls, median of 20 such runs
   after 3 warm-ups): flash attention, then the SSD scan;
4. serve: ``python -m repro_torch.launch.serve --arch qwen3-1.7b`` in
   process, at full width with random weights: 8 requests must be served,
   the kernel launched once per layer per prefill, the plain version never;
5. prefill logits of one served request through the kernel against the
   same prefill through the plain version; then device time by kernel
   (``torch.profiler``) over a prefill and over a decode step;
6. nas: the hardware-in-the-loop NAS loop (search space, translator,
   ModelBuilder, estimators measured on the card, CriteriaRunner, Study)
   over ssm and attention mixers at zamba2-2.7b's widths: 6 trials must
   complete, every forward of a candidate must launch ``ssm_scan`` once
   per ssm layer and ``flash_attention`` once per attention layer, the
   plain versions never; each candidate's peak memory, measured again
   after the loop in reverse order with a fresh cache, must be what the
   loop measured, and the cached artifacts must hold nothing on the card;
   the best candidate's output through the kernels against its output
   through the plain versions; device time by kernel over one forward of
   each candidate;
7. a JSON line per kernel, the card's name and power limit, and the
   ``{"ok": true, ...}`` line last.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: dense peaks and memory rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
MEM_BYTES_PER_S = 3.35e12

# (B, S, H, KH, D, causal, window)
FLASH_CASES = [
    (1, 8, 4, 2, 16, True, None),
    (2, 100, 4, 2, 16, True, None),
    (1, 200, 16, 8, 128, True, None),
    (1, 128, 16, 8, 128, True, None),
    (1, 512, 16, 8, 128, True, None),
    (4, 1024, 16, 8, 128, True, None),
    (1, 128, 4, 2, 16, True, 32),
    (1, 200, 4, 2, 16, False, None),
    (1, 2048, 32, 32, 80, False, None),  # the NAS loop's attention: D=80, non-causal
]
TOLERANCE = {
    "float32": 1e-4,   # order of summation only
    "bfloat16": 2e-2,  # the plain version rounds P to bf16 before P @ V
}
REPORTED_CASE = (1, 512, 16, 8, 128, True, None)  # the longer served prompt

SERVE_ARGS = ["--arch", "qwen3-1.7b", "--requests", "8", "--arrival", "burst",
              "--prompt-lens", "128,512", "--gen-lens", "16", "--max-batch", "4",
              "--queue-limit", "8", "--seed", "0", "--device", "cuda"]
LOGITS_ATOL = 1e-3

# (B, L, H, G, N, P, chunk); the last is the NAS loop's shape at
# zamba2-2.7b's widths (d_model 2560, expand 2, d_head 64, d_state 64, one
# group, chunk 128) at batch 4 and sequence 2048
SSM_CASES = [
    (1, 64, 4, 2, 8, 16, 8),
    (2, 200, 4, 1, 16, 16, 100),
    (2, 256, 8, 2, 16, 16, 64),
    (1, 2048, 80, 1, 64, 64, 256),
    (4, 2048, 80, 1, 64, 64, 128),
]
SSM_REPORTED_CASE = (4, 2048, 80, 1, 64, 64, 128)
# The kernel against the fp32 plain version on the same inputs (bf16
# inputs upcast): it sums in fp32 and rounds y to x's dtype once.  So each
# element of y is held to SSM_Y_REL of its own |y| (half a bf16 ulp, 2^-8
# of |y| at most; nothing in fp32) plus SSM_TOL of max |y| (the order of
# summation); the fp32 state to SSM_TOL of max |state|.
SSM_Y_REL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
SSM_TOL = 1e-4
SSM_NO_LIBRARY = "no single PyTorch call computes the SSD chunked scan"

# the layered NAS loop at zamba2-2.7b's published widths (configs/
# zamba2_2_7b.py in the JAX package): Mamba2 mixers of d_model 2560,
# d_state 64, d_head 64, expand 2, and its shared attention's 32 heads of
# d_head 80; sequence 2048, batch 4
NAS_SPACE = {
    "input": [2560, 2048],  # [channels, length]
    "output": 6,
    "sequence": [
        {"block": "mixer", "op_candidates": ["ssm", "attention"],
         "type_repeat": {"type": "vary_all", "depth": [1, 2]},
         "ssm": {"impl": ["pallas"], "d_state": [64], "d_head": [64], "expand": [2]},
         "attention": {"impl": ["pallas"], "heads": [32]}},
        {"block": "pool", "op_candidates": "global_avg_pool"},
        {"block": "head", "op_candidates": "linear", "linear": {"width": [64, 128]}},
    ],
}
NAS_TRIALS = 6
NAS_BATCH = 4
NAS_REL_TOL = 1e-3  # best candidate, kernels vs plain versions, of max |output|
# a candidate's peak measured again after the loop, in reverse order: the
# allocator may hand a request a cached block up to 1 MiB larger than it
# asked for, so the two readings may differ by that much a live tensor
NAS_PEAK_REL = 1e-2
# what the loop may leave on the card: library workspaces made on first
# use, never a candidate's weights (the smallest is ~0.1 GB)
NAS_HELD_SLACK = 64 << 20


def _smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else \
        f"nvidia-smi failed: {proc.stderr.strip()}"


def _time_ms(torch, fn, warmup=3, runs=20, calls=10) -> float:
    """Device milliseconds of one call of ``fn``: the median over ``runs``
    pairs of CUDA events, each around ``calls`` back-to-back calls (so the
    host's per-call latency is hidden while the device queue stays full),
    after ``warmup`` calls."""
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


def profile_window(torch, label, step, warmup=2, steps=3) -> None:
    """Print the host wall time of ``step`` (which ends in a device
    sync), the device time by kernel under ``torch.profiler``, and the
    device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(warmup):
            step()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(((ev.self_device_time_total / 1e3 / steps, ev.key)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA")
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(ms for ms, _ in rows)
    print("profile " + json.dumps({
        "window": label, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": busy_ms if rows else "not measured",
        "device_busy_share": busy_ms / wall_ms if rows else "not measured",
        "top_kernels_ms": [[name[:70], ms] for ms, name in rows[:8]]}))


def _ssm_inputs(torch, gen, b, l, h, g, n, p, dtype):
    """Inputs of the scan as a Mamba2 layer gives them: x, B and C are
    views into one (B, L, H*P + 2*G*N) activation, read through their
    strides; dt is a softplus of a normal; a = -linspace(1, 16), the
    layer's decays at init."""
    import torch.nn.functional as F

    xbc = torch.randn(b, l, h * p + 2 * g * n, generator=gen, device="cuda").to(dtype)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda") - 1.0)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, a, bm, cm


def _ssm_work(b, l, h, g, n, p, q, esize):
    """(operations, bytes) of one scan call.  Operations: for each (batch,
    head) and chunk, the C B^T entries on or below the diagonal and their
    product with x (q (q + 1) (N + P)), then C S and the state update
    (4 q N P); the masked half of the panel is not work.  Bytes: x, B, C
    and dt read once, y and the state written once."""
    flops = b * h * (l // q) * (q * (q + 1) * (n + p) + 4 * q * n * p)
    nbytes = esize * (2 * b * l * h * p + 2 * b * l * g * n) + 4 * (b * l * h + h + b * h * n * p)
    return flops, nbytes


def nas_phase(torch, ops, ref) -> dict:
    """The layered NAS loop of ``examples/quickstart.py::hand_wired`` on the
    card: ``NAS_SPACE`` -> sample_architecture -> ModelBuilder -> n_params
    (hard, 2e8), latency_s (measured, batch 4, objective) and peak_bytes
    (batch 4, soft, 16e9, weight 0.1) on target ``h100`` -> CriteriaRunner
    -> Study with the random sampler at seed 0.  Raises unless every
    trial completes, every forward ran each kernel once per layer of its
    kind, and the plain versions never ran.  Returns the counts."""
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.space import parse_search_space
    from repro_torch.core.translate import sample_architecture
    from repro_torch.evaluation.api import CriteriaRunner, OptimizationCriteria
    from repro_torch.evaluation.cache import EvaluationCache
    from repro_torch.evaluation.estimators import (
        CompiledLatencyEstimator, CompiledMemoryEstimator, ParamCountEstimator)
    from repro_torch.search.samplers import RandomSampler
    from repro_torch.search.study import Study

    kinds = {"ssm": "ssm_scan", "attention": "flash_attention"}
    space = parse_search_space(NAS_SPACE)
    builder = ModelBuilder(space.input_shape, space.output_dim)
    cache = EvaluationCache()
    runner = CriteriaRunner([
        OptimizationCriteria(ParamCountEstimator(), kind="hard_constraint", limit=2e8),
        OptimizationCriteria(CompiledLatencyEstimator("h100", batch=NAS_BATCH),
                             kind="objective"),
        OptimizationCriteria(CompiledMemoryEstimator("h100", batch=NAS_BATCH),
                             kind="soft_constraint", limit=16e9, weight=0.1),
    ], cache=cache)
    models, rows = {}, []

    def objective(trial):
        arch = sample_architecture(space, trial)
        model = builder.build(arch)
        models.setdefault(arch.signature(), model)  # the one the cache keeps
        forwards = [0]
        model.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        value = runner.evaluate(model, trial=trial)
        torch.cuda.synchronize()
        layers = {kernel: sum(layer.op == op for layer in arch.layers)
                  for op, kernel in kinds.items()}
        rows.append({
            "trial": trial.number, "signature": arch.signature(),
            "value": value, "latency_s": trial.user_attrs["latency_s"],
            "peak_bytes": trial.user_attrs["peak_bytes"],
            "n_params": trial.user_attrs["n_params"], "wall_s": time.perf_counter() - t0,
            "forwards": forwards[0],
            "launches": {k: ops.LAUNCHES[k] - before.get(k, 0) for k in kinds.values()},
            "expected": {k: layers[k] * forwards[0] for k in kinds.values()},
        })
        return value

    plain_calls = []

    def counted(fn):
        def wrapper(*a, **kw):
            plain_calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapper

    study = Study(name="nas-h100", sampler=RandomSampler(seed=0))
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    with mock.patch.object(ref, "ssm_scan_ref", counted(ref.ssm_scan_ref)), \
            mock.patch.object(ref, "flash_attention_ref", counted(ref.flash_attention_ref)):
        study.optimize(objective, NAS_TRIALS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    held_after = torch.cuda.memory_allocated()

    # each candidate's peak is its own: measured again with a fresh cache,
    # distinct candidates in reverse order, it is what the loop measured;
    # and the artifacts the caches keep hold nothing on the card
    again = CompiledMemoryEstimator("h100", batch=NAS_BATCH, cache=EvaluationCache())
    peak_again = {sig: again.estimate(models[sig]) for sig in reversed(list(models))}
    torch.cuda.synchronize()
    held_after_again = torch.cuda.memory_allocated()
    peak_first = {row["signature"]: row["peak_bytes"] for row in rows}

    best = study.best_trial
    summary = {
        "trials": rows, "completed": len(study.completed_trials), "wall_s": wall_s,
        "launches": launches, "plain_calls": len(plain_calls),
        "cache": cache.stats.as_dict(),
        "peak_bytes_again_reversed": peak_again,
        "device_bytes_held": {"before": held_before, "after_loop": held_after,
                              "after_measuring_again": held_after_again},
        "best": {"trial": best.number, "signature": rows[best.number]["signature"],
                 "value": best.value} if best else None,
    }
    print("nas " + json.dumps(summary))
    if len(study.completed_trials) != NAS_TRIALS:
        raise AssertionError(f"nas: {len(study.completed_trials)} of {NAS_TRIALS} "
                             f"trials completed: {[t.state for t in study.trials]}")
    for row in rows:
        if row["launches"] != row["expected"]:
            raise AssertionError(f"nas: trial {row['trial']} launched {row['launches']}, "
                                 f"expected {row['expected']} (layers x forwards)")
        if not all(0 < row[k] < float("inf") for k in ("latency_s", "peak_bytes")):
            raise AssertionError(f"nas: trial {row['trial']}: latency or peak not "
                                 f"finite and positive: {row}")
    for kernel in kinds.values():
        if sum(row["expected"][kernel] for row in rows) == 0 or launches.get(kernel, 0) != \
                sum(row["expected"][kernel] for row in rows):
            raise AssertionError(f"nas: {kernel} launched {launches.get(kernel, 0)} times "
                                 f"over the loop: {rows}")
    if plain_calls:
        raise AssertionError(f"nas: the plain versions ran {len(plain_calls)} times")
    for sig, peak in peak_again.items():
        if abs(peak - peak_first[sig]) > NAS_PEAK_REL * peak_first[sig]:
            raise AssertionError(f"nas: {sig} peaks at {peak_first[sig]} B in the loop "
                                 f"and at {peak} B measured again in reverse order")
    if held_after - held_before > NAS_HELD_SLACK or held_after_again != held_after:
        raise AssertionError(f"nas: evaluated candidates stay on the card: "
                             f"{summary['device_bytes_held']}")

    # the best candidate (its seed-0 weights, from the host): its kernels
    # against its plain versions on one batch
    model = models[summary["best"]["signature"]].to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    c, l = space.input_shape
    x = torch.randn(NAS_BATCH, l, c, generator=gen, device="cuda")

    def plain_ssm(x_, dt, a, b, c_, *, chunk):
        return ref.ssm_scan_ref(x_, dt, a, b, c_, chunk=chunk)

    def plain_flash(q, k, v, *, causal, window, scale=None):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=causal,
                                       window=window, scale=scale).transpose(1, 2)

    with torch.inference_mode():
        kernel_out = model(x)
        with mock.patch.object(ops, "ssm_scan", plain_ssm), \
                mock.patch.object(ops, "flash_attention", plain_flash):
            plain_out = model(x)
        torch.cuda.synchronize()
    err = (kernel_out - plain_out).abs().max().item()
    tol = NAS_REL_TOL * plain_out.abs().max().item()
    finite = bool(torch.isfinite(kernel_out).all())
    print("nas_best " + json.dumps({
        "signature": summary["best"]["signature"], "shape": list(kernel_out.shape),
        "finite": finite, "max_abs_out": plain_out.abs().max().item(),
        "max_abs_err": err, "tol": tol}))
    if not finite or kernel_out.shape != (NAS_BATCH, space.output_dim) or err > tol:
        raise AssertionError(f"nas best candidate: max |err| {err} > {tol}, "
                             f"finite={finite}, shape {tuple(kernel_out.shape)}")

    # where the time goes: one forward of each candidate
    xb = torch.zeros(NAS_BATCH, l, c, device="cuda")
    for signature, cand in models.items():
        cand.to("cuda")
        profile_window(torch, f"nas forward B={NAS_BATCH} {signature}",
                       lambda: float(cand(xb).sum()))
        cand.to("cpu")
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.nn.attention import make_mask

    # -- 1. environment ----------------------------------------------------
    smi = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print("set torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {sorted(reports) or 'up to date'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 3. kernel against plain version ----------------------------------
    def plain(q, k, v, *, causal, window, scale=None):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=causal,
                                       window=window, scale=scale).transpose(1, 2)

    def library(q, k, v, *, causal, window):
        group = q.shape[2] // k.shape[2]
        kT = k.transpose(1, 2).repeat_interleave(group, dim=1)
        vT = v.transpose(1, 2).repeat_interleave(group, dim=1)
        mask = None
        if window is not None:
            mask = make_mask(q.shape[1], k.shape[1], causal, window, device=q.device)[0]
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kT, vT, attn_mask=mask,
            is_causal=causal and window is None)

    kernel_rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for case in FLASH_CASES:
            b, s, h, kh, d, causal, window = case
            q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dt)
            v = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dt)
            kw = dict(causal=causal, window=window)
            out = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            if not (out.shape == q.shape and out.dtype == dt and err <= TOLERANCE[dtype]):
                raise AssertionError(f"flash_attention {case} {dtype}: max |err| "
                                     f"{err} > {TOLERANCE[dtype]} or bad shape/dtype")
            pairs = int(make_mask(s, s, causal, window, device="cuda").sum())
            flops = 4 * b * h * d * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
            row = {
                "case": {"B": b, "S": s, "H": h, "KH": kh, "D": d,
                         "causal": causal, "window": window},
                "dtype": dtype, "max_abs_err": err, "tol": TOLERANCE[dtype],
                "ms": _time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw)),
                "plain_ms": _time_ms(torch, lambda: plain(q, k, v, **kw)),
                "library_ms": _time_ms(torch, library(q, k, v, **kw)),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            kernel_rows[(case, dtype)] = row
            print("flash_attention " + json.dumps(row))

    # -- 3b. the SSD scan against its plain version -------------------------
    ssm_rows = {}
    for dtype in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype)
        for case in SSM_CASES:
            b, l, h, g, n, p, chunk = case
            args = _ssm_inputs(torch, gen, b, l, h, g, n, p, dt_)
            y, state = ops.ssm_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            x_, dt_in, a_, b_, c_ = args
            want_y, want_state = ref.ssm_scan_ref(x_.float(), dt_in, a_, b_.float(),
                                                  c_.float(), chunk=chunk)
            torch.cuda.synchronize()
            err_y = (y.float() - want_y).abs()
            tol_y = SSM_Y_REL[dtype] * want_y.abs() + SSM_TOL * want_y.abs().max()
            err, over = err_y.max().item(), (err_y / tol_y).max().item()
            err_s = (state - want_state).abs().max().item()
            tol_s = SSM_TOL * want_state.abs().max().item()
            finite = bool(torch.isfinite(y.float()).all() and torch.isfinite(state).all())
            if not (y.shape == x_.shape and y.dtype == dt_ and state.dtype == torch.float32
                    and finite and over <= 1 and err_s <= tol_s):
                raise AssertionError(
                    f"ssm_scan {case} {dtype}: max |err| / tol of y {over}, state "
                    f"{err_s} (tol {tol_s}), finite={finite}, shape {tuple(y.shape)}")
            flops, nbytes = _ssm_work(b, l, h, g, n, p, chunk, torch.tensor([], dtype=dt_).element_size())
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
            row = {
                "case": {"B": b, "L": l, "H": h, "G": g, "N": n, "P": p, "chunk": chunk},
                "dtype": dtype, "max_abs_err": err,
                "tol": f"{SSM_Y_REL[dtype]} |y| + {SSM_TOL} max|y| per element",
                "max_err_over_tol": over, "max_abs_y": want_y.abs().max().item(),
                "rms_y": want_y.square().mean().sqrt().item(),
                "max_abs_err_state": err_s, "tol_state": tol_s,
                "ms": _time_ms(torch, lambda: ops.ssm_scan(*args, chunk=chunk)),
                "plain_ms": _time_ms(torch, lambda: ref.ssm_scan_ref(*args, chunk=chunk)),
                "library_ms": None, "library": SSM_NO_LIBRARY,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            ssm_rows[(case, dtype)] = row
            print("ssm_scan " + json.dumps(row))
            del args, x_, b_, c_, y, state, want_y, want_state, err_y, tol_y

    # -- 4. serve at full width -------------------------------------------
    args = serve.parse_args(SERVE_ARGS)
    plain_calls = []
    real_ref = ref.flash_attention_ref

    def counted_ref(*a, **kw):
        plain_calls.append(1)
        return real_ref(*a, **kw)

    ops.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(ref, "flash_attention_ref", counted_ref):
        summary, engine = serve._serve_lm(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    model = engine.model
    n_layers = model.spec.n_layers
    vocab = model.spec.vocab
    print("serve " + json.dumps({
        "arch": summary["arch"], "served": summary["served"], "shed": summary["shed"],
        "prefills": summary["prefills"], "tokens_generated": summary["tokens_generated"],
        "wall_s": summary["wall_s"], "tok_per_s": summary["tok_per_s"],
        "prefill_ms": summary["prefill_ms"],
        "prompt_lens": [r["prompt_len"] for r in engine.completed],  # join order
        "decode_steps": len(summary["decode_ms"]),
        "decode_ms_first": summary["decode_ms"][0],
        "decode_ms_median": statistics.median(summary["decode_ms"]),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "flash_launches": launches.get("flash_attention", 0),
        "plain_calls": len(plain_calls)}))
    if summary["served"] != 8 or summary["shed"] != 0 or summary["prefills"] != 8:
        raise AssertionError(f"serve: expected 8 served, 0 shed, 8 prefills: {summary}")
    if launches.get("flash_attention", 0) != 8 * n_layers:
        raise AssertionError(f"serve: flash_attention launched {launches} times, "
                             f"expected {8 * n_layers}")
    if plain_calls:
        raise AssertionError(f"serve: the plain version ran {len(plain_calls)} times")
    for r in engine.completed:
        if len(r["tokens"]) != 16 or not all(0 <= t < vocab for t in r["tokens"]):
            raise AssertionError(f"serve: bad generation {r}")

    # -- 5. prefill logits: kernel against plain --------------------------
    req = next(r for r in serve._traffic_from_args(args).requests() if r.prompt_len == 512)
    prompt = torch.as_tensor(req.prompt_tokens(vocab)[None], dtype=torch.long, device="cuda")
    with torch.inference_mode():
        before = ops.LAUNCHES["flash_attention"]
        kernel_logits, _ = model.prefill(model.init_cache(1, 513), prompt)
        torch.cuda.synchronize()
        if ops.LAUNCHES["flash_attention"] != before + n_layers:
            raise AssertionError("prefill logits: the kernel did not run once per layer")
        with mock.patch.object(ops, "flash_attention", plain):
            plain_logits, _ = model.prefill(model.init_cache(1, 513), prompt)
        torch.cuda.synchronize()
    err = (kernel_logits - plain_logits).abs().max().item()
    finite = bool(torch.isfinite(kernel_logits).all())
    print("prefill_logits " + json.dumps({
        "shape": list(kernel_logits.shape), "finite": finite,
        "max_abs_logit": kernel_logits.abs().max().item(),
        "max_abs_err": err, "tol": LOGITS_ATOL}))
    if not finite or kernel_logits.shape != (1, 512, vocab) or err > LOGITS_ATOL:
        raise AssertionError(f"prefill logits: max |err| {err} > {LOGITS_ATOL}, "
                             f"finite={finite}, shape {tuple(kernel_logits.shape)}")

    # -- 5b. where the time goes: device time by kernel --------------------
    decode_cache = model.init_cache(4, engine.max_context)
    decode_tokens = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    decode_pos = torch.tensor([512, 128, 300, 40], device="cuda")
    profile_window(torch, "prefill S=512", lambda: int(
        model.prefill(model.init_cache(1, 513), prompt)[0][0, -1].argmax()))
    profile_window(torch, "decode B=4", lambda: int(
        model.decode(decode_cache, decode_tokens, decode_pos)[0].argmax()))

    # -- 6. the NAS loop at zamba2-2.7b's widths ---------------------------
    del decode_cache, engine, model
    torch.cuda.empty_cache()
    nas = nas_phase(torch, ops, ref)

    # -- 7. result ---------------------------------------------------------
    served = kernel_rows[(REPORTED_CASE, "float32")]
    scan = ssm_rows[(SSM_REPORTED_CASE, "float32")]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": launches.get("flash_attention", 0),
        "launches_by_path": {"serve": launches.get("flash_attention", 0),
                             "nas": nas["launches"].get("flash_attention", 0)},
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"], "library_ms": served["library_ms"],
        "shape": "B=1 S=T=512 H=16 KH=8 D=128 causal float32",
    }, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:76",
        "launches": nas["launches"].get("ssm_scan", 0),
        "launches_by_path": {"nas": nas["launches"].get("ssm_scan", 0)},
        "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": None,
        "library": SSM_NO_LIBRARY,
        "shape": "B=4 L=2048 H=80 G=1 N=64 P=64 chunk=128 float32",
    }]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
