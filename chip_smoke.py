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
   PyTorch library call computing the same function (CUDA events around
   10 back-to-back calls, median of 20 such runs after 3 warm-ups);
4. serve: ``python -m repro_torch.launch.serve --arch qwen3-1.7b`` in
   process, at full width with random weights: 8 requests must be served,
   the kernel launched once per layer per prefill, the plain version never;
5. prefill logits of one served request through the kernel against the
   same prefill through the plain version; then device time by kernel
   (``torch.profiler``) over a prefill and over a decode step;
6. a JSON line per kernel, the card's name and power limit, and the
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

    # -- 6. result ---------------------------------------------------------
    served = kernel_rows[(REPORTED_CASE, "float32")]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": launches.get("flash_attention", 0),
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"], "library_ms": served["library_ms"],
        "shape": "B=1 S=T=512 H=16 KH=8 D=128 causal float32",
    }]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
