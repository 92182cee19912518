#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100, ``sm_90a``).

    python3 chip_smoke.py
    python3 chip_smoke.py --phases ssm,nas   # a subset, no result line

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
   after 3 warm-ups; for the served and NAS flash shapes also the
   kernel's and the library call's device time from ``torch.profiler``):
   flash attention, then the SSD scan (the ``ssm`` phase, with dt and a
   in bf16 for one case, and the kernel's device time, in all and for each
   launch, at the NAS loop's shape and at chunk 256);
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
6b. modelled: ``latency_s`` at ``metric: modelled`` on target ``h100`` over
   the nas phase's candidates: each program's operations and bytes counted
   on the ``meta`` device (the kernels' work by ``ops.kernel_work``), the
   roofline terms, and the nas phase's measured ``latency_s`` beside them;
   counting must launch nothing, allocate nothing on the card and generate
   no candidate;
6c. explore: the Explorer facade (``repro_torch.explorer``) over the nas
   phase's space and criteria with the kernel-schedule tuner (mode cached,
   budget 5) and a disk cache, three times: serial cold, serial warm (no
   tuning, no candidate run, every value from disk), and the process
   backend with 2 spawned workers; the same best trial in all three, both
   kernels launched in each; then ``mlstm_scan`` tuned at xlstm-1.3b's
   shape in fp32 and bf16, every candidate chunk launched;
6d. cascade: the explore phase's spec with a fidelity cascade (a synflow
   screen of cohorts of 8, half promoted to the measured final stage), 8
   trials, serial and then with 2 spawned process workers: the funnel, the
   screen's Spearman, its kernel launches (which must be some) and wall
   time; both runs screen the same trials and find the same best trial, and
   agree on each promoted candidate's latency within 5%;
7. the mLSTM scan against its plain version (fp32 and bf16, timed as in
   3), at the xlstm-1.3b forward's shape and smaller ones; the forward's
   shape and batch 4 at 512 also with the kernel's device time from
   ``torch.profiler``, in all and for each of its two launches;
8. xlstm_forward: ``LM.forward`` of xlstm-1.3b at full width (random
   weights, seed 0) over 2048 tokens with every mLSTM block on the kernel:
   ``mlstm_scan`` launched once per mLSTM layer (42), the plain version
   never; the logits against the same forward with ``impl="xla"`` in
   float64, within 1e-3 of max |logits| plus twice the fp32 ``impl="xla"``
   forward's own error (that forward's reading is printed too); device
   time by kind of kernel and inside the sLSTM blocks' time loops; then
   the same forward with the weights in bf16, which runs the kernel's
   bf16 path: 42 launches, each launch's h against the fp32 plain version
   on that layer's own inputs, finite logits, device time by kind;
9. xlstm_serve: ``python -m repro_torch.launch.serve --arch xlstm-1.3b`` in
   process at full width: 4 requests must be served; one prompt's prefill
   logits (the decode step looped over the prompt) against the kernel
   forward's logits at the same positions;
10. zamba2_forward: ``LM.forward`` of zamba2-2.7b as published (54 Mamba2
   layers, the weight-shared attention block run 9 times; random weights,
   seed 0) over 2048 tokens: ``ssm_scan`` launched 54 times and
   ``flash_attention`` 9, the plain versions never; the logits held to the
   float64 ``impl="xla"`` forward as in 8; device time by kind; then
   zamba2_serve, as 9 (flash 9 times a prefill; the Mamba2 layers loop
   their decode step);
11. moe_forward: dbrx-132b at its published widths cut to one of its 40
   layers (16 experts of 10752, top 4; 48 heads of 128 over 8 KV heads),
   attention on flash, over 2048 tokens: the logits held to the float64
   ``impl="xla"`` forward as in 8, save the tokens whose expert set moved
   where the float64 router's margin between its 4th and 5th probability is
   below 1e-5 (counted); any other token that moves fails;
12. paligemma_forward: paligemma-3b as published (18 layers, 8 heads of 256
   over one KV head; random weights, seed 0) over 2048 tokens, the first 256
   positions overwritten by seeded patch embeddings: ``flash_attention``
   launched 18 times (causal, D = 256), the plain version never; the logits
   held to the float64 ``impl="xla"`` forward as in 8; device time by kind;
   then paligemma_serve, as 9 (text prompts: flash 18 times a prefill);
13. whisper_forward: whisper-medium as published (24 encoder and 24 decoder
   layers; random weights, seed 0): ``encode`` of 1500 seeded frame
   embeddings, then the forward of 448 tokens against the encoder output:
   ``flash_attention`` launched 48 times (24 non-causal over the 1500 frames,
   24 causal over the 448 tokens), cross-attention never (it runs the plain
   grouped math, as in the JAX package), the plain version never; the
   logits held to the float64 ``impl="xla"`` encode and forward as in 8;
   device time by kind; then ``init_cache`` with the encoder output, a
   prefill of the first 384 tokens and 4 decode steps, their logits held to
   the forward's at the same positions within 1e-3 of their max;
14. a JSON line per kernel, the card's name and power limit, and the
   ``{"ok": true, ...}`` line last.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: dense peaks and memory rate.  fp32 work is
# bounded by the card's fastest route that keeps fp32 accuracy: split-TF32
# (each product as three TF32 products) on the tensor cores, 495 / 3 TFLOP/s
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
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
    # ragged S inside a 64-row tile, D not a multiple of 16, group 4, and a
    # window that crosses 64-row tiles
    (2, 777, 8, 2, 36, True, 100),
    # zamba2-2.7b's shared attention (causal, 32 heads of 80) in its forward
    # and at both served prompts (the 64-token one shorter than a query
    # tile), and dbrx-132b's (48 heads of 128 over 8 KV
    # heads) in the moe_forward phase
    (1, 2048, 32, 32, 80, True, None),
    (1, 128, 32, 32, 80, True, None),
    (1, 64, 32, 32, 80, True, None),
    (1, 2048, 48, 8, 128, True, None),
    # head dims above 128: nemotron-4-340b's 192 (96 heads over 8 KV heads)
    # and paligemma-3b's 256 (8 heads, one KV head), and 256 ragged and
    # non-causal
    (1, 512, 12, 1, 192, True, None),
    (1, 512, 8, 1, 256, True, None),
    (2, 300, 4, 2, 256, False, None),
    # the paligemma_forward and whisper_forward phases' attention:
    # paligemma-3b's over its 2048 tokens, whisper-medium's encoder
    # (non-causal over 1500 frames, no multiple of a tile) and decoder
    # (causal over its 448-token text context)
    (1, 2048, 8, 1, 256, True, None),
    (1, 1500, 16, 16, 64, False, None),
    (1, 448, 16, 16, 64, True, None),
    # the shapes the paligemma_serve phase's prefills give the kernel (its
    # 64- and 128-token prompts) and whisper_forward's cached prefill of 384
    # tokens; there the phases compare the kernel with itself or check it
    # only through the logits, so these rows hold it to the plain version
    (1, 64, 8, 1, 256, True, None),
    (1, 128, 8, 1, 256, True, None),
    (1, 384, 16, 16, 64, True, None),
]
TOLERANCE = {
    "float32": 1e-4,   # order of summation only
    "bfloat16": 2e-2,  # the output's rounding and P rounded to bf16 before P @ V
}
REPORTED_CASE = (1, 512, 16, 8, 128, True, None)  # the longer served prompt
NAS_FLASH_CASE = (1, 2048, 32, 32, 80, False, None)
# cases whose rows also carry device time from torch.profiler: the served and
# NAS shapes, D = 192 and 256 at 512 tokens, paligemma-3b's forward and
# whisper-medium's encoder
DEVICE_TIMED_CASES = (REPORTED_CASE, NAS_FLASH_CASE, (1, 512, 12, 1, 192, True, None),
                      (1, 512, 8, 1, 256, True, None), (1, 2048, 8, 1, 256, True, None),
                      (1, 1500, 16, 16, 64, False, None))
# cases also run at every tile pair the kernel is built for at their head
# dim (a flash_tiles line each), with the pair asked for by a schedule
TILED_CASES = (REPORTED_CASE, NAS_FLASH_CASE)

SERVE_ARGS = ["--arch", "qwen3-1.7b", "--requests", "8", "--arrival", "burst",
              "--prompt-lens", "128,512", "--gen-lens", "16", "--max-batch", "4",
              "--queue-limit", "8", "--seed", "0", "--device", "cuda"]
LOGITS_ATOL = 1e-3

# (B, L, H, G, N, P, chunk); the fifth is the NAS loop's shape at
# zamba2-2.7b's widths (d_model 2560, expand 2, d_head 64, d_state 64, one
# group, chunk 128) at batch 4 and sequence 2048; then Mamba2-2.7b's
# published d_state 128 with headdim 64, a head of 128, N and P off the MMA
# tiles with the decrement-chosen chunk 100 (ragged tiles), and chunk 1024
# (the schedules' largest) at N = P = 128
SSM_CASES = [
    (1, 64, 4, 2, 8, 16, 8),
    (2, 200, 4, 1, 16, 16, 100),
    (2, 256, 8, 2, 16, 16, 64),
    (1, 2048, 80, 1, 64, 64, 256),
    (4, 2048, 80, 1, 64, 64, 128),
    (2, 512, 8, 1, 128, 64, 128),
    (2, 512, 8, 2, 64, 128, 128),
    (2, 200, 6, 3, 24, 72, 100),
    (1, 2048, 16, 1, 128, 128, 1024),
    # zamba2-2.7b's Mamba2 layers in its forward (batch 1, 2048 tokens) and
    # at the served prompt the zamba2_serve phase checks (128 tokens)
    (1, 2048, 80, 1, 64, 64, 128),
    (1, 128, 80, 1, 64, 64, 128),
]
# cases also run with dt and a in bf16 (the wrapper takes them in fp32)
SSM_BF16_DT_CASES = [(2, 200, 6, 3, 24, 72, 100)]
SSM_REPORTED_CASE = (4, 2048, 80, 1, 64, 64, 128)
# cases whose rows also carry the kernel's device time from torch.profiler,
# in all and by launch (in fp32 the chunks' panels, then the scan)
SSM_DEVICE_TIMED_CASES = (SSM_CASES[3], SSM_REPORTED_CASE)
SSM_PASSES = {"panel_device_ms": "ssm_panel", "scan_device_ms": "ssm_scan_fwd"}
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

# (B, L, H, P, chunk, input-gate shift): the xlstm-1.3b forward's shape
# (P = 1024, chunk 128, sequence 2048) first, batch 4 at 512, the CPU tests'
# shapes with the decrement-chosen chunk 100 and the least chunk 8, input
# gates shifted by -100 (exp(-m) overflows: h must be 0, not NaN), a P that
# is not a multiple of 8 with a chunk that is not a multiple of 16 (the MMA
# tiles' zero-fill and masks), and chunk 256 at the full P
MLSTM_CASES = [
    (1, 2048, 4, 1024, 128, 0.0),
    (4, 512, 4, 1024, 128, 0.0),
    (2, 64, 2, 32, 16, 0.0),
    (2, 128, 4, 16, 32, 0.0),
    (1, 200, 2, 64, 100, 0.0),
    (1, 64, 2, 64, 8, 0.0),
    (2, 64, 2, 32, 16, -100.0),
    (1, 96, 2, 36, 24, 0.0),
    (1, 1024, 2, 1024, 256, 0.0),
    # the largest chunks a schedule allows, at the forward's shape: they
    # stream v through the state pass's ring (above 416 in fp32 and 256 in
    # bf16 at P = 1024)
    (1, 2048, 4, 1024, 512, 0.0),
    (1, 2048, 4, 1024, 1024, 0.0),
]
MLSTM_REPORTED_CASE = MLSTM_CASES[0]
# cases whose rows also carry device time, in all and by pass (the panel
# launch, then the state launch)
MLSTM_DEVICE_TIMED_CASES = (MLSTM_CASES[0], MLSTM_CASES[1], MLSTM_CASES[-2], MLSTM_CASES[-1])
MLSTM_PASSES = {"panel_device_ms": "mlstm_chunk_panel", "state_device_ms": "mlstm_chunk_state"}
# as for the SSD scan: each element of h within MLSTM_H_REL of its |h| (half
# a bf16 ulp; h is rounded once) plus MLSTM_TOL of max |h| (order of
# summation), against the fp32 plain version on the same inputs
MLSTM_H_REL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
MLSTM_TOL = 1e-4
# Chunks above the ones the kernel staged whole before (416 in fp32, 256 in
# bf16 at P = 1024; it streams v there, and in fp32 sums each staged tile
# apart and keeps the gates' cumsum in double): over 512 or 1024 terms the fp32 plain version itself lands up to
# 2.6 times MLSTM_TOL from the float64 plain version on an H100
# (scripts/mlstm_chunk_accuracy.py, PERF.md), so it cannot be the yardstick.  These cases are held to the float64 plain
# version instead: each element within the dtype's tolerance of it plus
# twice the fp32 plain version's own error at that element, i.e. the kernel
# may miss the exact h by twice what fp32 arithmetic in the plain version's
# order misses it by, and never by less than the phase's tolerance.
MLSTM_F64_CHUNK = {"float32": 416, "bfloat16": 256}
MLSTM_NO_LIBRARY = "no single PyTorch call computes the chunkwise mLSTM scan"

XLSTM_ARCH = "xlstm-1.3b"
XLSTM_SEQ = 2048  # the default sequence of examples/hw_in_loop_nas_lm.py
# The kernel forward's logits against the same weights' impl="xla" forward
# in float64: each element within XLSTM_LOGITS_REL of max |logits| plus
# twice what the fp32 impl="xla" forward itself misses float64 by there.
# (Before, the check was the fp32 xla forward within XLSTM_LOGITS_REL of
# max |logits|, which 1e-7 of noise on the mLSTM outputs moves 24.6 times
# that tolerance: PERF.md.)  Also the tolerance of the prefill check.
XLSTM_LOGITS_REL = 1e-3  # of max |logits|
XLSTM_SERVE_ARGS = ["--arch", XLSTM_ARCH, "--requests", "4", "--arrival", "burst",
                    "--prompt-lens", "64,128", "--gen-lens", "8", "--max-batch", "4",
                    "--queue-limit", "4", "--seed", "0", "--device", "cuda"]

# zamba2-2.7b as published: 54 Mamba2 layers and one weight-shared attention
# block run after every 6th (9 runs); its forward and serve are held as
# xlstm-1.3b's are (XLSTM_LOGITS_REL, against the float64 impl="xla" forward)
ZAMBA2_ARCH = "zamba2-2.7b"
ZAMBA2_SEQ = 2048
ZAMBA2_SERVE_ARGS = ["--arch", ZAMBA2_ARCH, *XLSTM_SERVE_ARGS[2:]]

# dbrx-132b at its published widths, one of its 40 layers: one layer's 16
# experts are 12.7 GB in fp32 and the float64 reference doubles the model,
# so one card holds one layer beside its reference
MOE_ARCH = "dbrx-132b"
MOE_SEQ = 2048
MOE_LAYERS = 1
# A token whose top-k expert set differs from the float64 forward's is
# exempt from the logits check only where the float64 router's margin (its
# k-th probability less its (k+1)-th) is below MOE_MARGIN: there fp32 may
# rightly route otherwise.  Any other change of expert set fails.
MOE_MARGIN = 1e-5

# paligemma-3b as published, uncut (2.51e9 parameters: 10 GB in fp32 beside
# a 20 GB float64 reference): 2048 tokens, the first 256 of them (its
# num_prefix_tokens) overwritten by seeded patch embeddings; served as
# zamba2-2.7b is (text prompts: prefill takes no prefix in either package)
PALIGEMMA_ARCH = "paligemma-3b"
PALIGEMMA_SEQ = 2048
PALIGEMMA_SERVE_ARGS = ["--arch", PALIGEMMA_ARCH, *XLSTM_SERVE_ARGS[2:]]

# whisper-medium as published, uncut: its encoder over the 1500 frames of its
# enc_context, its decoder over the 448 tokens of Whisper's text context; the
# cached path prefills the first 384 tokens and decodes 4 more.  Not served:
# the engine builds no encoder output, so its cross-attention adds zeros
# and a prefill is not the forward's (as in the JAX package's engine)
WHISPER_ARCH = "whisper-medium"
WHISPER_SEQ = 448
WHISPER_PREFILL = 384
WHISPER_DECODE_STEPS = 4


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


def _ssm_inputs(torch, gen, b, l, h, g, n, p, dtype, dt_dtype=None):
    """Inputs of the scan as a Mamba2 layer gives them: x, B and C are
    views into one (B, L, H*P + 2*G*N) activation, read through their
    strides; dt is a softplus of a normal; a = -linspace(1, 16), the
    layer's decays at init; dt and a in ``dt_dtype`` (fp32 by default)."""
    import torch.nn.functional as F

    xbc = torch.randn(b, l, h * p + 2 * g * n, generator=gen, device="cuda").to(dtype)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    dt = F.softplus(torch.randn(b, l, h, generator=gen, device="cuda") - 1.0)
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    dt_dtype = dt_dtype or torch.float32
    return x, dt.to(dt_dtype), a.to(dt_dtype), bm, cm


def ssm_phase(torch, ops, ref, gen) -> dict:
    """The SSD scan against its fp32 plain version on the same inputs, fp32
    and bf16, every case of ``SSM_CASES`` (and those of
    ``SSM_BF16_DT_CASES`` again with dt and a in bf16); the
    ``SSM_DEVICE_TIMED_CASES`` also with the kernel's device time.  Returns
    the rows."""
    from repro_torch.kernels import timing
    from repro_torch.kernels.schedule import KernelSchedule

    rows = {}
    runs = [(case, "float32") for case in SSM_CASES] + \
        [(case, "bfloat16") for case in SSM_BF16_DT_CASES]
    for dtype in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype)
        for case, dt_dtype in runs:
            b, l, h, g, n, p, chunk = case
            args = _ssm_inputs(torch, gen, b, l, h, g, n, p, dt_, getattr(torch, dt_dtype))
            y, state = ops.ssm_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            x_, dt_in, a_, b_, c_ = args
            want_y, want_state = ref.ssm_scan_ref(x_.float(), dt_in.float(), a_.float(),
                                                  b_.float(), c_.float(), chunk=chunk)
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
                    f"ssm_scan {case} {dtype} (dt {dt_dtype}): max |err| / tol of y {over}, "
                    f"state {err_s} (tol {tol_s}), finite={finite}, shape {tuple(y.shape)}")
            flops, nbytes = ops.kernel_work("ssm_scan", {"x": x_.shape, "b": b_.shape},
                                            {"dtype": dtype}, KernelSchedule(chunk=chunk))
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
            kernel = lambda: ops.ssm_scan(*args, chunk=chunk)  # noqa: E731
            row = {
                "case": {"B": b, "L": l, "H": h, "G": g, "N": n, "P": p, "chunk": chunk},
                "dtype": dtype, "dt_dtype": dt_dtype, "max_abs_err": err,
                "tol": f"{SSM_Y_REL[dtype]} |y| + {SSM_TOL} max|y| per element",
                "max_err_over_tol": over, "max_abs_y": want_y.abs().max().item(),
                "rms_y": want_y.square().mean().sqrt().item(),
                "max_abs_err_state": err_s, "tol_state": tol_s,
                "ms": timing.event_ms(kernel),
                "plain_ms": timing.event_ms(lambda: ref.ssm_scan_ref(*args, chunk=chunk)),
                "library_ms": None, "library": SSM_NO_LIBRARY,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            if case in SSM_DEVICE_TIMED_CASES and dt_dtype == "float32":
                times = timing.device_times(kernel)
                row["device_ms"] = timing.measured(sum(times.values()))
                for key, name in SSM_PASSES.items():
                    if dtype == "float32" or name != "ssm_panel":  # bf16 has no panel launch
                        row[key] = timing.measured(
                            sum(ms for k, ms in times.items() if name in k))
            rows[(case, dtype, dt_dtype)] = row
            print("ssm_scan " + json.dumps(row))
            del args, x_, b_, c_, y, state, want_y, want_state, err_y, tol_y
    return rows


def _mlstm_inputs(torch, gen, b, l, h, p, i_shift, dtype):
    """q, k, v standard normal; log input gates 2 N(0, 1) + ``i_shift``; log
    forget gates log-sigmoid(N(0, 1) + 3), an mLSTM layer's forget bias at
    init."""
    import torch.nn.functional as F

    q, k, v = (torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    il = torch.randn(b, l, h, generator=gen, device="cuda") * 2.0 + i_shift
    fl = F.logsigmoid(torch.randn(b, l, h, generator=gen, device="cuda") + 3.0)
    return q, k, v, il, fl


def mlstm_phase(torch, ops, ref, gen) -> dict:
    """The mLSTM scan against its fp32 plain version on the same inputs,
    fp32 and bf16, every case of ``MLSTM_CASES`` (the chunks above
    ``MLSTM_F64_CHUNK`` against the float64 plain version).  Returns the
    rows."""
    from repro_torch.kernels import timing
    from repro_torch.kernels.schedule import KernelSchedule

    rows = {}
    for dtype in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype)
        for case in MLSTM_CASES:
            b, l, h, p, chunk, i_shift = case
            args = _mlstm_inputs(torch, gen, b, l, h, p, i_shift, dt_)
            out, none = ops.mlstm_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            q, k, v, il, fl = args
            want = ref.mlstm_scan_ref(q.float(), k.float(), v.float(), il, fl, chunk=chunk)
            torch.cuda.synchronize()
            err_h = (out.float() - want).abs()
            tol_h = MLSTM_H_REL[dtype] * want.abs() + MLSTM_TOL * want.abs().max()
            f64 = chunk > MLSTM_F64_CHUNK[dtype]
            if f64:
                exact = ref.mlstm_scan_ref(q.double(), k.double(), v.double(), il.double(),
                                           fl.double(), chunk=chunk, dtype=torch.float64)
                plain_err = (want.double() - exact).abs()
                err_h = (out.double() - exact).abs()
                phase_tol = MLSTM_H_REL[dtype] * exact.abs() + MLSTM_TOL * exact.abs().max()
                tol_h = phase_tol + 2 * plain_err
                plain_over = (plain_err / phase_tol).max().item()
                del exact, plain_err, phase_tol
            err = err_h.max().item()
            over = (err_h / tol_h.clamp_min(1e-30)).max().item()
            finite = bool(torch.isfinite(out.float()).all())
            if not (out.shape == q.shape and out.dtype == dt_ and none is None
                    and finite and over <= 1):
                raise AssertionError(
                    f"mlstm_scan {case} {dtype}: max |err| / tol of h {over}, "
                    f"finite={finite}, shape {tuple(out.shape)}, dtype {out.dtype}")
            flops, nbytes = ops.kernel_work("mlstm_scan", {"q": q.shape}, {"dtype": dtype},
                                            KernelSchedule(chunk=chunk))
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
            kernel = lambda: ops.mlstm_scan(*args, chunk=chunk)  # noqa: E731
            row = {
                "case": {"B": b, "L": l, "H": h, "P": p, "chunk": chunk,
                         "input_gate_shift": i_shift},
                "dtype": dtype, "max_abs_err": err,
                "tol": (f"against float64: {MLSTM_H_REL[dtype]} |h| + {MLSTM_TOL} max|h| "
                        f"+ 2 |plain fp32 - float64| per element" if f64 else
                        f"{MLSTM_H_REL[dtype]} |h| + {MLSTM_TOL} max|h| per element"),
                "max_err_over_tol": over, "max_abs_h": want.abs().max().item(),
                **({"plain_fp32_err_over_tol": plain_over} if f64 else {}),
                "finite": finite,
                "ms": timing.event_ms(kernel),
                "plain_ms": timing.event_ms(lambda: ref.mlstm_scan_ref(*args, chunk=chunk)),
                "library_ms": None, "library": MLSTM_NO_LIBRARY,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            if case in MLSTM_DEVICE_TIMED_CASES:
                times = timing.device_times(kernel)
                row["device_ms"] = timing.measured(sum(times.values()))
                for key, name in MLSTM_PASSES.items():
                    row[key] = timing.measured(sum(ms for k, ms in times.items() if name in k))
            rows[(case, dtype)] = row
            print("mlstm_scan " + json.dumps(row))
            del args, q, k, v, out, want, err_h, tol_h
    return rows


def _counted(calls, fn):
    def wrapper(*a, **kw):
        calls.append(fn.__name__)
        return fn(*a, **kw)
    return wrapper


def profile_by_kind(torch, label, step, ranges=()) -> dict:
    """One run of ``step`` (which ends in a device sync) under
    ``torch.profiler``: its host wall time, device time by kind of kernel
    (GEMMs, the mLSTM scan, the SSD scan, flash attention, the rest:
    elementwise passes, copies, reductions), for each ``record_function`` range
    named in ``ranges`` the host time inside it, the device time of the
    kernels launched in it and its span on the device, and the device's
    busy share of the wall time.  The host's operators are recorded only
    when ``ranges`` are asked for.  Returns the printed row."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * bool(ranges) + [ProfilerActivity.CUDA]
    with torch.inference_mode(), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kinds = {"gemm": 0.0, "mlstm_scan": 0.0, "ssm_scan": 0.0, "flash": 0.0, "rest": 0.0}
    kernels, in_ranges = [], {}
    for ev in averages:
        on_device = str(ev.device_type).endswith("CUDA")
        if ev.key in ranges:
            # the range appears twice: on the host (with the device time of
            # the kernels launched inside it) and as a span on the device
            row = in_ranges.setdefault(ev.key, {})
            if on_device:
                row["device_span_ms"] = ev.self_device_time_total / 1e3
            else:
                row.update(kernels_device_ms=ev.device_time_total / 1e3,
                           host_ms=ev.cpu_time_total / 1e3, calls=ev.count)
            continue
        if not (on_device and ev.self_device_time_total > 0):
            continue
        ms, low = ev.self_device_time_total / 1e3, ev.key.lower()
        kernels.append((ms, ev.key, ev.count))
        if "mlstm_chunk" in low:
            kinds["mlstm_scan"] += ms
        elif "ssm_panel" in low or "ssm_scan_fwd" in low:
            kinds["ssm_scan"] += ms
        elif "flash_fwd" in low:
            kinds["flash"] += ms
        elif any(tag in low for tag in ("gemm", "gemv", "cutlass", "xmma")):
            kinds["gemm"] += ms
        else:
            kinds["rest"] += ms
    busy_ms = sum(ms for ms, _, _ in kernels)
    row = {
        "window": label, "wall_ms": wall_ms,
        "device_ms": busy_ms if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels else "not measured",
        "device_ms_by_kind": kinds if kernels else "not measured",
        "kernel_launches": sum(n for _, _, n in kernels),
        "ranges": in_ranges,
        "top_kernels_ms": [[name[:70], ms, n] for ms, name, n in sorted(kernels, reverse=True)[:8]]}
    print("profile " + json.dumps(row))
    return row


def _run_forward(model, tokens, dtype=None, frames=None, prefix_embeds=None):
    """The logits of ``model`` on ``tokens``: with ``frames``, encoded first
    and attended to by the cross-attention; with ``prefix_embeds`` over the
    first positions.  The inputs are cast to ``dtype`` when it is given."""
    cast = (lambda x: x) if dtype is None else (lambda x: x.to(dtype))
    kw = {}
    if frames is not None:
        kw["enc_out"] = model.encode(cast(frames))
    if prefix_embeds is not None:
        kw["prefix_embeds"] = cast(prefix_embeds)
    return model(tokens, **kw)


def _xla_forwards(torch, ops, serve, spec, model, tokens, **inputs) -> dict:
    """The yardsticks of a kernel forward of ``model`` (an ``LM`` of
    ``spec`` on the kernels): the same weights' forward (``inputs`` as
    :func:`_run_forward` takes them) with every kernel sub-block on its
    plain layer (``impl="xla"``), in fp32 (sharing the weights) and in
    float64 (a copy, made after the fp32 forward).  Returns their logits
    ("plain", "float64"), their host walls and the kernel launches the
    plain one made (there must be none)."""
    from repro_torch.models.lm import LM

    xla = serve.swap_spec_impl(spec, "xla")
    out = {}
    for name, dtype in (("plain", None), ("float64", torch.float64)):
        other = LM(xla)
        other.load_state_dict({k: v if dtype is None else v.to(dtype)
                               for k, v in model.state_dict().items()},
                              strict=True, assign=True)
        with torch.inference_mode():
            before = sum(ops.LAUNCHES.values())
            t0 = time.perf_counter()
            out[name] = _run_forward(other, tokens, dtype, **inputs)
            torch.cuda.synchronize()
            out[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3
            out[f"{name}_kernel_launches"] = sum(ops.LAUNCHES.values()) - before
        del other
    return out


def _float64_readings(logits, plain, logits64, held=None) -> dict:
    """The logits check of a kernel forward: each element within
    ``XLSTM_LOGITS_REL`` of max |float64 logits| plus twice what the fp32
    ``impl="xla"`` forward (``plain``) misses float64 by there; over the
    tokens ``held`` marks ((B, S) bool; all by default).  Also the fp32
    forward's own reading, and the check before (the fp32 forward within
    ``XLSTM_LOGITS_REL`` of its max |logits|)."""
    scale = XLSTM_LOGITS_REL * logits64.abs().max()
    if held is not None:
        logits, plain, logits64 = logits[held], plain[held], logits64[held]
    plain_err = (plain.double() - logits64).abs()
    over = ((logits.double() - logits64).abs() / (scale + 2 * plain_err)).max().item()
    err = (logits - plain).abs().max().item()
    tol = XLSTM_LOGITS_REL * plain.abs().max().item()
    return {
        "max_err_over_tol": over,
        "tol": (f"against the float64 impl=xla forward: {XLSTM_LOGITS_REL} max|logits| "
                f"+ 2 |fp32 impl=xla - float64| per element"),
        "plain_fp32_err_over_tol": (plain_err / scale).max().item(),
        "old_check": {"against": "the fp32 impl=xla forward", "max_abs_err": err,
                      "tol": tol, "max_err_over_tol": err / tol},
    }


def _sub_count(layers, kind) -> int:
    """Sub-blocks of ``kind`` a run of ``layers`` (a spec's decoder or
    encoder layers) makes (the shared layer once a run)."""
    return sum(sub.kind == kind for layer in layers for sub in layer.subs)


def xlstm_forward_phase(torch, ops, ref, serve) -> dict:
    """``LM.forward`` of xlstm-1.3b at full width over ``XLSTM_SEQ`` tokens,
    every mLSTM block on the kernel (``serve.swap_spec_impl``).  Raises
    unless ``mlstm_scan`` launched once per mLSTM layer, the plain version
    never, and the logits match the same weights' forward with
    ``impl="xla"`` in float64 (``XLSTM_LOGITS_REL``); the reading of the
    check before it (the fp32 ``impl="xla"`` forward) is printed beside.
    Returns the counts and times."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.nn import xlstm as xlstm_mod

    spec = get_arch(XLSTM_ARCH).spec()
    n_mlstm = _sub_count(spec.layers, "mlstm")
    model = LM(serve.swap_spec_impl(spec, "pallas"))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = _tokens(torch, spec.vocab, XLSTM_SEQ)
    n_params = sum(t.numel() for t in model.state_dict().values())
    run = _kernel_forward(torch, ops, ref, model, tokens)
    logits, launches = run["logits"], run["launches"]
    del run["logits"]

    # the check: the same weights' forward with impl="xla" in float64
    xla = _xla_forwards(torch, ops, serve, spec, model, tokens)
    readings = _float64_readings(logits, xla["plain"], xla["float64"])
    finite = bool(torch.isfinite(logits).all())
    logits_shape = tuple(logits.shape)
    del logits, xla["plain"], xla["float64"]

    # where the time goes: the sLSTM blocks' time loops and the mLSTM blocks
    def ranged(name, fn):
        def wrapper(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapper

    with mock.patch.object(xlstm_mod, "slstm_block_apply",
                           ranged("slstm_block", xlstm_mod.slstm_block_apply)), \
            mock.patch.object(xlstm_mod, "mlstm_block_apply",
                              ranged("mlstm_block", xlstm_mod.mlstm_block_apply)):
        prof = profile_by_kind(torch, f"xlstm forward B=1 L={XLSTM_SEQ}",
                               lambda: float(model(tokens)[0, -1, 0]),
                               ranges=("slstm_block", "mlstm_block"))
    summary = {
        "arch": spec.name, "n_params": n_params, "tokens": list(tokens.shape),
        "wall_ms": run["wall_ms"], "device_ms": prof["device_ms"],
        "device_ms_source": "the profiled forward's kernels (torch.profiler)",
        "plain_impl_wall_ms": xla["plain_wall_ms"],
        "mlstm_layers": n_mlstm, "mlstm_scan_launches": launches.get("mlstm_scan", 0),
        "plain_calls": run["plain_calls"],
        "plain_impl_kernel_launches": xla["plain_kernel_launches"],
        "max_memory_allocated": run["max_memory_allocated"],
        "logits_shape": list(logits_shape), "finite": finite,
        "float64_impl_wall_ms": xla["float64_wall_ms"], **readings,
    }
    print("xlstm_forward " + json.dumps(summary))
    if (launches != {"mlstm_scan": n_mlstm} or run["plain_calls"]
            or xla["plain_kernel_launches"]):
        raise AssertionError(f"xlstm_forward: mlstm_scan launched {launches} times "
                             f"(expected {n_mlstm}), plain calls {run['plain_calls']}, "
                             f"launches under impl=xla {xla['plain_kernel_launches']}")
    over = readings["max_err_over_tol"]
    if not finite or logits_shape != (1, XLSTM_SEQ, spec.vocab) or over > 1:
        raise AssertionError(f"xlstm_forward: logits max |err| / tol {over} against the "
                             f"float64 forward, finite={finite}, shape {logits_shape}")
    del model
    torch.cuda.empty_cache()
    return summary


def xlstm_forward_bf16_phase(torch, ops, ref, serve) -> dict:
    """The forward of :func:`xlstm_forward_phase` with the same weights in
    bf16 (``LM.init`` draws in fp32 and rounds; the gate projections stay
    fp32), so that every mLSTM block runs the kernel's bf16 path.  Raises
    unless ``mlstm_scan`` launched once per mLSTM layer and the plain
    version never, every launch's h holds the kernel's bf16 tolerance
    against the fp32 plain version on that layer's own inputs, and the
    logits are finite and of the expected shape.  The logits are not held
    against another forward: with random weights this model moves its
    logits by about their own size under rounding to bf16 (the plain bf16
    forward lands as far from the fp32 one as the kernel's does;
    ``scripts/xlstm_logits_variants.py --bf16``).  Returns the counts and
    times."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM

    spec = get_arch(XLSTM_ARCH).spec()
    n_mlstm = _sub_count(spec.layers, "mlstm")
    tokens = _tokens(torch, spec.vocab, XLSTM_SEQ)
    model = LM(serve.swap_spec_impl(spec, "pallas"))
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)

    plain_calls = []
    with mock.patch.object(ref, "mlstm_scan_ref", _counted(plain_calls, ref.mlstm_scan_ref)), \
            torch.inference_mode():
        ops.LAUNCHES.clear()
        t0 = time.perf_counter()
        logits = model(tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.LAUNCHES)
    finite = bool(torch.isfinite(logits).all())
    logits_shape = tuple(logits.shape)
    del logits

    # every launch against the fp32 plain version on its own inputs
    overs, kernel = [], ops.mlstm_scan

    def checked(q, k, v, i_log, f_log, *, chunk):
        h, none = kernel(q, k, v, i_log, f_log, chunk=chunk)
        want = ref.mlstm_scan_ref(q.float(), k.float(), v.float(), i_log, f_log, chunk=chunk)
        tol = MLSTM_H_REL["bfloat16"] * want.abs() + MLSTM_TOL * want.abs().max()
        overs.append(((h.float() - want).abs() / tol.clamp_min(1e-30)).max().item())
        return h, none

    with mock.patch.object(ops, "mlstm_scan", checked), torch.inference_mode():
        model(tokens)

    prof = profile_by_kind(torch, f"xlstm forward bf16 B=1 L={XLSTM_SEQ}",
                           lambda: float(model(tokens)[0, -1, 0]))
    summary = {
        "arch": spec.name, "dtype": "bfloat16", "tokens": list(tokens.shape), "wall_ms": wall,
        "device_ms": prof["device_ms"],
        "device_ms_source": "the profiled forward's kernels (torch.profiler)",
        "mlstm_layers": n_mlstm, "mlstm_scan_launches": launches.get("mlstm_scan", 0),
        "plain_calls": len(plain_calls),
        "h_max_err_over_tol_by_layer": overs,
        "h_tol": f"{MLSTM_H_REL['bfloat16']} |h| + {MLSTM_TOL} max|h| per element, "
                 f"against the fp32 plain version on the layer's own inputs",
        "logits_shape": list(logits_shape), "finite": finite,
    }
    print("xlstm_forward_bf16 " + json.dumps(summary))
    if launches.get("mlstm_scan", 0) != n_mlstm or plain_calls:
        raise AssertionError(f"xlstm_forward_bf16: mlstm_scan launched {launches} times "
                             f"(expected {n_mlstm}), plain calls {len(plain_calls)}")
    if len(overs) != n_mlstm or max(overs) > 1:
        raise AssertionError(f"xlstm_forward_bf16: h max |err| / tol by layer {overs}")
    if not finite or logits_shape != (1, XLSTM_SEQ, spec.vocab):
        raise AssertionError(f"xlstm_forward_bf16: logits finite={finite}, "
                             f"shape {logits_shape}")
    del model
    torch.cuda.empty_cache()
    return summary


KERNEL_OF_KIND = {"attention": "flash_attention", "mamba2": "ssm_scan", "mlstm": "mlstm_scan"}


def _forward_launches(layers) -> dict:
    """Kernel launches one run of ``layers`` on the kernels makes: one a
    sub-block of each kind that has a kernel (cross-attention has none)."""
    return {kernel: _sub_count(layers, kind) for kind, kernel in KERNEL_OF_KIND.items()
            if _sub_count(layers, kind)}


def _plain_versions(ref, calls):
    """Patches counting the calls of every kernel's plain version."""
    return [mock.patch.object(ref, name, _counted(calls, getattr(ref, name)))
            for name in ("flash_attention_ref", "ssm_scan_ref", "mlstm_scan_ref")]


def lm_serve_phase(torch, ops, ref, serve, name, argv) -> dict:
    """``launch.serve`` of a model at full width (``argv``: 4 requests, 8
    tokens each).  Raises unless they are served with no shed, each
    prefill launched ``flash_attention`` once per attention sub-block (a
    recurrent layer loops its decode step and launches no scan) and no
    plain version ran, and the longest prompt's prefill logits match the
    kernel forward's logits at the same positions within
    ``XLSTM_LOGITS_REL`` of their max.  Prints ``<name>_serve`` and
    ``<name>_prefill_logits`` lines; returns the first."""
    from contextlib import ExitStack

    args = serve.parse_args(argv)
    plain_calls = []
    ops.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    with ExitStack() as stack:
        for patch in _plain_versions(ref, plain_calls):
            stack.enter_context(patch)
        summary, engine = serve._serve_lm(args)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    model = engine.model
    vocab = model.spec.vocab
    per_prefill = {"flash_attention": _sub_count(model.spec.layers, "attention")}
    out = {
        "arch": summary["arch"], "served": summary["served"], "shed": summary["shed"],
        "prefills": summary["prefills"], "tokens_generated": summary["tokens_generated"],
        "wall_s": summary["wall_s"], "tok_per_s": summary["tok_per_s"],
        "prefill_ms": summary["prefill_ms"],
        "prompt_lens": [r["prompt_len"] for r in engine.completed],
        "decode_ms": summary["decode_ms"], "max_memory_allocated": peak,
        **{f"{kernel}_launches": launches.get(kernel, 0) for kernel in KERNEL_OF_KIND.values()},
        "plain_calls": len(plain_calls)}
    print(f"{name}_serve " + json.dumps(out))
    if summary["served"] != 4 or summary["shed"] != 0 or summary["prefills"] != 4:
        raise AssertionError(f"{name}_serve: expected 4 served, 0 shed, 4 prefills: {summary}")
    want = {k: 4 * n for k, n in per_prefill.items() if n}
    if {k: n for k, n in launches.items() if n} != want or plain_calls:
        raise AssertionError(f"{name}_serve: kernels launched {launches}, expected {want}; "
                             f"plain calls {len(plain_calls)}")
    for r in engine.completed:
        if len(r["tokens"]) != 8 or not all(0 <= t < vocab for t in r["tokens"]):
            raise AssertionError(f"{name}_serve: bad generation {r}")

    # the longest prompt's prefill logits against the kernel forward at the
    # same positions
    req = max(serve._traffic_from_args(args).requests(), key=lambda r: r.prompt_len)
    prompt = torch.as_tensor(req.prompt_tokens(vocab)[None], dtype=torch.long, device="cuda")
    with torch.inference_mode():
        prefill_logits, _ = model.prefill(model.init_cache(1, req.prompt_len + 1), prompt)
        ops.LAUNCHES.clear()
        fwd_logits = model(prompt)
        torch.cuda.synchronize()
        fwd_launches = dict(ops.LAUNCHES)
    err = (prefill_logits - fwd_logits).abs().max().item()
    tol = XLSTM_LOGITS_REL * fwd_logits.abs().max().item()
    finite = bool(torch.isfinite(prefill_logits).all())
    print(f"{name}_prefill_logits " + json.dumps({
        "prompt_len": req.prompt_len, "shape": list(prefill_logits.shape), "finite": finite,
        "max_abs_logit": fwd_logits.abs().max().item(), "max_abs_err": err, "tol": tol,
        "max_err_over_tol": err / tol,
        **{f"forward_{kernel}_launches": n for kernel, n in fwd_launches.items()}}))
    if fwd_launches != _forward_launches(model.spec.layers):
        raise AssertionError(f"{name}_serve: the forward launched {fwd_launches}, "
                             f"expected {_forward_launches(model.spec.layers)}")
    if not finite or prefill_logits.shape != fwd_logits.shape or err > tol:
        raise AssertionError(f"{name}_serve: prefill logits max |err| {err} > {tol}, "
                             f"finite={finite}")
    del engine, model
    torch.cuda.empty_cache()
    return out


def _kernel_forward(torch, ops, ref, model, tokens, runs=2, calls=None, **inputs) -> dict:
    """``runs`` forwards of ``model`` on ``tokens`` (``inputs`` as
    :func:`_run_forward` takes them) with the kernels' plain versions
    counted: the first one's logits and launches, every run's host wall,
    the peak memory.  ``calls``, a dict, receives the first run's kernel
    calls by shape (``schedule.record_kernel_calls``)."""
    from contextlib import ExitStack

    from repro_torch.kernels import schedule as ksched

    plain_calls, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ExitStack() as stack, torch.inference_mode():
        for patch in _plain_versions(ref, plain_calls):
            stack.enter_context(patch)
        for run in range(runs):
            with ExitStack() as recording:
                if run == 0:
                    ops.LAUNCHES.clear()
                    if calls is not None:
                        recording.enter_context(ksched.record_kernel_calls(calls))
                t0 = time.perf_counter()
                out = _run_forward(model, tokens, **inputs)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            if run == 0:
                logits, launches = out, {k: n for k, n in ops.LAUNCHES.items() if n}
            del out
    return {"logits": logits, "launches": launches, "plain_calls": len(plain_calls),
            "wall_ms": walls, "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _flash_calls_by_shape(calls) -> dict:
    """Flash calls recorded by ``schedule.record_kernel_calls``, counted by
    query and key lengths and mask."""
    out = {}
    for (kernel, _), call in calls.items():
        if kernel == "flash_attention":
            key = (f"S={call['shapes']['q'][1]} T={call['shapes']['k'][1]} "
                   f"causal={call['meta']['causal']}")
            out[key] = out.get(key, 0) + call["calls"]
    return out


def _model_forward(torch, ops, ref, serve, name, spec, tokens, **inputs):
    """``LM.forward`` of ``spec`` (random fp32 weights, seed 0) on ``tokens``
    (``inputs`` as :func:`_run_forward` takes them: an encoder's frames, a
    prefix of patch embeddings), every attention, Mamba2 and mLSTM
    sub-block of the encoder and decoder on its kernel.  Raises unless
    each kernel launched once per sub-block of its kind, no plain version
    was called, and the logits hold the float64 check of
    :func:`xlstm_forward_phase`.  Prints the ``<name>_forward`` line (with
    device time by kind); returns (that line, the model, its logits)."""
    from repro_torch.models.lm import LM

    want = _forward_launches(spec.encoder_layers + spec.layers)
    model = LM(serve.swap_spec_impl(spec, "pallas"))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    calls = {}
    run = _kernel_forward(torch, ops, ref, model, tokens, calls=calls, **inputs)
    logits = run.pop("logits")
    xla = _xla_forwards(torch, ops, serve, spec, model, tokens, **inputs)
    readings = _float64_readings(logits, xla["plain"], xla["float64"])
    finite, logits_shape = bool(torch.isfinite(logits).all()), tuple(logits.shape)
    del xla["plain"], xla["float64"]
    prof = profile_by_kind(torch, f"{name} forward B={tokens.shape[0]} L={tokens.shape[1]}",
                           lambda: float(_run_forward(model, tokens, **inputs)[0, -1, 0]))
    kinds, device_ms = prof["device_ms_by_kind"], prof["device_ms"]
    summary = {
        "arch": spec.name, "layers": spec.n_layers,
        "encoder_layers": len(spec.encoder_layers),
        "n_params": sum(t.numel() for t in model.state_dict().values()),
        "tokens": list(tokens.shape),
        **{f"{key}_shape": list(x.shape) for key, x in inputs.items()},
        **run, "expected_launches": want,
        "flash_calls_by_shape": _flash_calls_by_shape(calls),
        "device_ms": device_ms, "device_ms_by_kind": kinds,
        "device_share_by_kind": ({k: ms / device_ms for k, ms in kinds.items()}
                                 if isinstance(kinds, dict) else "not measured"),
        "device_busy_share": prof["device_busy_share"],
        "device_ms_source": "the profiled forward's kernels (torch.profiler)",
        "plain_impl_wall_ms": xla["plain_wall_ms"],
        "plain_impl_kernel_launches": xla["plain_kernel_launches"],
        "float64_impl_wall_ms": xla["float64_wall_ms"],
        "logits_shape": list(logits_shape), "finite": finite, **readings,
    }
    print(f"{name}_forward " + json.dumps(summary))
    if run["launches"] != want or run["plain_calls"] or xla["plain_kernel_launches"]:
        raise AssertionError(f"{name}_forward: kernels launched {run['launches']} "
                             f"(expected {want}), plain calls {run['plain_calls']}, "
                             f"launches under impl=xla {xla['plain_kernel_launches']}")
    over = readings["max_err_over_tol"]
    if not finite or logits_shape != (*tokens.shape, spec.vocab) or over > 1:
        raise AssertionError(f"{name}_forward: logits max |err| / tol {over} against the "
                             f"float64 forward, finite={finite}, shape {logits_shape}")
    return summary, model, logits


def _tokens(torch, vocab, seq):
    """Batch-1 tokens drawn from seed 1, as every model phase draws them."""
    return torch.randint(0, vocab, (1, seq), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))


def _embeddings(torch, *shape):
    """Standard normal stand-ins for a stub frontend's output (frame or patch
    embeddings), drawn from seed 2."""
    return torch.randn(shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))


def zamba2_forward_phase(torch, ops, ref, serve) -> dict:
    """``LM.forward`` of zamba2-2.7b as published over ``ZAMBA2_SEQ``
    tokens at batch 1 (:func:`_model_forward`): ``ssm_scan`` once per
    Mamba2 layer (54) and ``flash_attention`` once per run of the shared
    attention block (9).  Returns the counts and times."""
    from repro_torch.configs import get_arch

    spec = get_arch(ZAMBA2_ARCH).spec()
    summary, model, logits = _model_forward(torch, ops, ref, serve, "zamba2", spec,
                                            _tokens(torch, spec.vocab, ZAMBA2_SEQ))
    del model, logits
    torch.cuda.empty_cache()
    return summary


def paligemma_forward_phase(torch, ops, ref, serve) -> dict:
    """``LM.forward`` of paligemma-3b as published over ``PALIGEMMA_SEQ``
    tokens at batch 1, its first ``num_prefix_tokens`` (256) positions
    overwritten by seeded patch embeddings (:func:`_model_forward`):
    ``flash_attention`` once per layer (18; causal, 8 heads of 256 over one
    KV head).  Returns the counts and times."""
    from repro_torch.configs import get_arch

    spec = get_arch(PALIGEMMA_ARCH).spec()
    prefix = _embeddings(torch, 1, spec.num_prefix_tokens, spec.d_model)
    summary, model, logits = _model_forward(torch, ops, ref, serve, "paligemma", spec,
                                            _tokens(torch, spec.vocab, PALIGEMMA_SEQ),
                                            prefix_embeds=prefix)
    del model, logits
    torch.cuda.empty_cache()
    return summary


def whisper_forward_phase(torch, ops, ref, serve) -> dict:
    """whisper-medium as published (:func:`_model_forward`): ``encode`` of
    ``enc_context`` (1500) seeded frame embeddings, then the forward of
    ``WHISPER_SEQ`` tokens against the encoder output.  Raises unless flash
    ran once per encoder layer non-causally over the frames and once per
    decoder layer causally over the tokens (cross-attention takes the plain
    grouped math and launches nothing); then the cached path: ``init_cache``
    with the encoder output, a prefill of ``WHISPER_PREFILL`` tokens (flash
    once per decoder layer) and ``WHISPER_DECODE_STEPS`` per-slot decode
    steps, whose logits must match the forward's at the same positions
    within ``XLSTM_LOGITS_REL`` of their max.  Returns the counts and
    times."""
    from repro_torch.configs import get_arch

    arch = get_arch(WHISPER_ARCH)
    spec = arch.spec()
    tokens = _tokens(torch, spec.vocab, WHISPER_SEQ)
    frames = _embeddings(torch, 1, arch.enc_context, spec.d_model)
    summary, model, logits = _model_forward(torch, ops, ref, serve, "whisper", spec,
                                            tokens, frames=frames)
    n_enc = _sub_count(spec.encoder_layers, "attention")
    n_dec = _sub_count(spec.layers, "attention")
    want = {f"S={arch.enc_context} T={arch.enc_context} causal=False": n_enc,
            f"S={WHISPER_SEQ} T={WHISPER_SEQ} causal=True": n_dec}
    if summary["flash_calls_by_shape"] != want:
        raise AssertionError(f"whisper_forward: flash calls {summary['flash_calls_by_shape']}"
                             f", expected {want}")

    # the cached path against the forward at the same positions
    with torch.inference_mode():
        enc = model.encode(frames)
        cache = model.init_cache(1, WHISPER_SEQ, enc_out=enc)
        ops.LAUNCHES.clear()
        t0 = time.perf_counter()
        pre, cache = model.prefill(cache, tokens[:, :WHISPER_PREFILL])
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = {k: n for k, n in ops.LAUNCHES.items() if n}
        steps, decode_ms = [], []
        for t in range(WHISPER_PREFILL, WHISPER_PREFILL + WHISPER_DECODE_STEPS):
            t0 = time.perf_counter()
            step, cache = model.decode(cache, tokens[:, t:t + 1],
                                       torch.tensor([t], device="cuda"))
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(step)
        decode_launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    cached = torch.cat([pre, *steps], dim=1)
    want_logits = logits[:, :WHISPER_PREFILL + WHISPER_DECODE_STEPS]
    err = (cached - want_logits).abs().max().item()
    tol = XLSTM_LOGITS_REL * want_logits.abs().max().item()
    finite = bool(torch.isfinite(cached).all())
    summary["cached"] = {
        "prefill_tokens": WHISPER_PREFILL, "decode_steps": WHISPER_DECODE_STEPS,
        "enc_len": int(cache[0]["sub_1"]["k"].shape[1]),
        "prefill_wall_ms": prefill_ms, "decode_wall_ms": decode_ms,
        "prefill_launches": prefill_launches, "launches_after_decode": decode_launches,
        "max_abs_logit": want_logits.abs().max().item(), "max_abs_err": err, "tol": tol,
        "max_err_over_tol": err / tol, "finite": finite}
    print("whisper_cached " + json.dumps(summary["cached"]))
    if prefill_launches != {"flash_attention": n_dec} or decode_launches != prefill_launches:
        raise AssertionError(f"whisper_cached: launches {prefill_launches} in the prefill, "
                             f"{decode_launches} after decoding; expected {n_dec} flash "
                             f"launches in the prefill and none in decode")
    if not finite or err > tol:
        raise AssertionError(f"whisper_cached: logits max |err| {err} > {tol}, "
                             f"finite={finite}")
    del model, logits, enc, cache, cached, pre, steps
    torch.cuda.empty_cache()
    return summary


def moe_forward_phase(torch, ops, ref, serve) -> dict:
    """``LM.forward`` of dbrx-132b at its published widths cut to
    ``MOE_LAYERS`` of its 40 layers (random fp32 weights, seed 0) over
    ``MOE_SEQ`` tokens at batch 1, attention on flash.  Raises unless flash
    launched once a layer and its plain version never, no token routes to
    another expert set than the float64 forward's unless its float64
    margin is below ``MOE_MARGIN`` (those are counted and left out of the
    logits check), and the other tokens' logits hold the float64 check of
    :func:`xlstm_forward_phase`.  Returns the counts and times."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.nn import moe as moe_mod

    full = get_arch(MOE_ARCH).spec()
    spec = dataclasses.replace(full, layers=full.layers[:MOE_LAYERS])
    cfg = next(sub.cfg for sub in spec.layers[0].subs if sub.kind == "moe")
    want = _forward_launches(spec.layers)
    model = LM(serve.swap_spec_impl(spec, "pallas"))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = _tokens(torch, spec.vocab, MOE_SEQ)

    # the routing of each forward's MoE layers, in the order they ran
    routes, route = [], moe_mod.route_topk

    def routed(router_logits, top_k):
        ids, gates, probs = route(router_logits, top_k)
        routes.append((ids, probs))
        return ids, gates, probs

    with mock.patch.object(moe_mod, "route_topk", routed):
        run = _kernel_forward(torch, ops, ref, model, tokens, runs=1)
        xla = _xla_forwards(torch, ops, serve, spec, model, tokens)
    logits = run.pop("logits")
    # split the routings into the kernel, fp32 xla and float64 forwards
    n_moe = _sub_count(spec.layers, "moe")
    if len(routes) != 3 * n_moe:
        raise AssertionError(f"moe_forward: {len(routes)} routings recorded, expected "
                             f"3 forwards x {n_moe} MoE layers")
    forwards = [routes[i * n_moe:(i + 1) * n_moe] for i in range(3)]
    ids = [torch.stack([r[0] for r in fwd]) for fwd in forwards]  # (layers, B, S, K)
    probs64 = torch.stack([r[1] for r in forwards[2]])  # (layers, B, S, E)
    sets = [torch.sort(i, dim=-1).values for i in ids]
    moved_at = (sets[0] != sets[2]).any(-1)  # (layers, B, S): the kernel's set differs
    top = torch.sort(probs64, dim=-1, descending=True).values
    margin = top[..., cfg.top_k - 1] - top[..., cfg.top_k]
    moved = moved_at.any(0)
    # exempt where every layer that moved the token had a near-tie margin
    exempt = moved & ~(moved_at & (margin >= MOE_MARGIN)).any(0)
    readings = _float64_readings(logits, xla["plain"], xla["float64"], held=~exempt)
    dropped = [sum((moe_mod._slot_assignment(layer, cfg.n_experts, cfg.capacity(MOE_SEQ))[1]
                    < 0).sum().item() for layer in ids[f]) for f in (0, 2)]
    finite, logits_shape = bool(torch.isfinite(logits).all()), tuple(logits.shape)
    del logits, xla["plain"], xla["float64"], routes[:]
    prof = profile_by_kind(torch, f"dbrx forward depth {MOE_LAYERS} B=1 L={MOE_SEQ}",
                           lambda: float(model(tokens)[0, -1, 0]))
    summary = {
        "arch": spec.name, "reduced": f"depth {full.n_layers} -> {MOE_LAYERS}",
        "n_params": sum(t.numel() for t in model.state_dict().values()),
        "experts": cfg.n_experts, "top_k": cfg.top_k, "capacity": cfg.capacity(MOE_SEQ),
        "tokens": list(tokens.shape), **run, "expected_launches": want,
        "device_ms": prof["device_ms"], "device_ms_by_kind": prof["device_ms_by_kind"],
        "device_busy_share": prof["device_busy_share"],
        "device_ms_source": "the profiled forward's kernels (torch.profiler)",
        "plain_impl_wall_ms": xla["plain_wall_ms"],
        "plain_impl_kernel_launches": xla["plain_kernel_launches"],
        "float64_impl_wall_ms": xla["float64_wall_ms"],
        "tokens_moved": int(moved.sum()), "tokens_exempt": int(exempt.sum()),
        "tokens_moved_in_plain_fp32": int((sets[1] != sets[2]).any(-1).any(0).sum()),
        "margin_exempt_below": MOE_MARGIN, "min_float64_margin": margin.min().item(),
        "dropped_choices": dropped[0], "dropped_choices_float64": dropped[1],
        "logits_shape": list(logits_shape), "finite": finite, **readings,
    }
    print("moe_forward " + json.dumps(summary))
    if run["launches"] != want or run["plain_calls"] or xla["plain_kernel_launches"]:
        raise AssertionError(f"moe_forward: kernels launched {run['launches']} "
                             f"(expected {want}), plain calls {run['plain_calls']}, "
                             f"launches under impl=xla {xla['plain_kernel_launches']}")
    if (moved & ~exempt).any():
        raise AssertionError(f"moe_forward: {int((moved & ~exempt).sum())} tokens route to "
                             f"another expert set than float64's at a margin of "
                             f"{MOE_MARGIN} or more")
    over = readings["max_err_over_tol"]
    if not finite or logits_shape != (1, MOE_SEQ, spec.vocab) or over > 1:
        raise AssertionError(f"moe_forward: logits max |err| / tol {over} against the "
                             f"float64 forward, finite={finite}, shape {logits_shape}")
    del model
    torch.cuda.empty_cache()
    return summary


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
    study = Study(name="nas-h100", sampler=RandomSampler(seed=0))
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    with mock.patch.object(ref, "ssm_scan_ref", _counted(plain_calls, ref.ssm_scan_ref)), \
            mock.patch.object(ref, "flash_attention_ref",
                              _counted(plain_calls, ref.flash_attention_ref)):
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

    with torch.inference_mode():
        kernel_out = model(x)
        with mock.patch.object(ops, "ssm_scan", plain_ssm), \
                mock.patch.object(ops, "flash_attention", _flash_plain):
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


def _flash_plain(q, k, v, *, causal, window, scale=None):
    """The plain version of the flash kernel, in the wrapper's layout."""
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window, scale=scale).transpose(1, 2)


def _flash_library(q, k, v, *, causal, window):
    """One PyTorch call computing the same attention (SDPA, KV repeated to
    the query heads beforehand), as a yardstick: the port never calls it."""
    import torch.nn.functional as F

    from repro_torch.nn.attention import make_mask

    group = q.shape[2] // k.shape[2]
    kT = k.transpose(1, 2).repeat_interleave(group, dim=1)
    vT = v.transpose(1, 2).repeat_interleave(group, dim=1)
    mask = None
    if window is not None:
        mask = make_mask(q.shape[1], k.shape[1], causal, window, device=q.device)[0]
    return lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kT, vT, attn_mask=mask, is_causal=causal and window is None)


def flash_phase(torch, ops, gen) -> dict:
    """The flash kernel against its plain version on the same inputs, fp32
    and bf16, every case of ``FLASH_CASES``, with the kernel's, the plain
    version's and SDPA's times; the ``DEVICE_TIMED_CASES`` also with the
    kernel's and SDPA's device time.  A bf16 output is held to the plain
    version run in float64 on the same (bf16) inputs: the bf16 plain
    version, which rounds the normalised P to bf16, lies itself up to 0.022
    from that, and beside it the kernel's reading (and SDPA's) could pass
    the tolerance only as its error and the plain version's cancelled.  The
    bf16 plain version's own error and the kernel's distance from it are
    printed.  Returns the rows."""
    from repro_torch.kernels import timing

    rows = {}
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
            want = _flash_plain(q, k, v, **kw)
            held = want if dtype == "float32" else _flash_plain(
                q.double(), k.double(), v.double(), **kw)
            torch.cuda.synchronize()
            err = (out.to(held.dtype) - held).abs().max().item()
            if not (out.shape == q.shape and out.dtype == dt and err <= TOLERANCE[dtype]):
                raise AssertionError(f"flash_attention {case} {dtype}: max |err| "
                                     f"{err} > {TOLERANCE[dtype]} or bad shape/dtype")
            flops, nbytes = ops.kernel_work("flash_attention", {"q": q.shape, "k": k.shape},
                                            {"dtype": dtype, **kw}, None)
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
            kernel = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
            library = _flash_library(q, k, v, **kw)
            row = {
                "case": {"B": b, "S": s, "H": h, "KH": kh, "D": d,
                         "causal": causal, "window": window},
                "dtype": dtype, "max_abs_err": err, "tol": TOLERANCE[dtype],
                "ms": timing.event_ms(kernel),
                "plain_ms": timing.event_ms(lambda: _flash_plain(q, k, v, **kw)),
                "library_ms": timing.event_ms(library),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            if dtype == "bfloat16":
                row["held_to"] = "the plain version in float64"
                row["plain_max_abs_err"] = (want.double() - held).abs().max().item()
                row["max_abs_err_vs_bf16_plain"] = (out.float() - want.float()).abs().max().item()
            if case in DEVICE_TIMED_CASES:
                row["device_ms"] = timing.device_ms(kernel)
                row["library_device_ms"] = timing.device_ms(library)
            rows[(case, dtype)] = row
            print("flash_attention " + json.dumps(row))
            if case in TILED_CASES:
                rows.update(flash_tiles(torch, ops, case, dtype, q, k, v, held, row))
            del q, k, v, out, want, held
    return rows


def flash_tiles(torch, ops, case, dtype, q, k, v, held, base) -> dict:
    """The flash kernel at every tile pair it is built for at this case's
    head dim, each asked for by a schedule: the pair launched must be the
    one asked for, and each within the dtype's tolerance of the plain
    version as :func:`flash_phase` holds it (``held``).  Rows keyed (case, dtype, (block_q, block_kv))."""
    from repro_torch.kernels import schedule as ksched
    from repro_torch.kernels import timing

    b, s, h, kh, d, causal, window = case
    kw = dict(causal=causal, window=window)
    rows = {}
    for bq in ops.FLASH_Q_TILES:
        for bk in ops.FLASH_KV_TILES:
            if not ops.flash_takes(d, q.dtype, bq, bk):
                continue
            sched = ksched.KernelSchedule(block_q=bq, block_kv=bk)
            sink = {}
            with ksched.record_kernel_calls(sink):
                out = ops.flash_attention(q, k, v, schedule=sched, **kw)
            torch.cuda.synchronize()
            (call,) = sink.values()
            err = (out.to(held.dtype) - held).abs().max().item()
            if call["launched"] != {"block_q": bq, "block_kv": bk} or err > TOLERANCE[dtype]:
                raise AssertionError(f"flash_attention {case} {dtype} tiles ({bq}, {bk}): "
                                     f"launched {call['launched']}, max |err| {err}")
            kernel = lambda: ops.flash_attention(q, k, v, schedule=sched, **kw)  # noqa: E731
            row = {"case": base["case"], "dtype": dtype,
                   "block_q": bq, "block_kv": bk, "max_abs_err": err,
                   "tol": TOLERANCE[dtype], "ms": timing.event_ms(kernel),
                   "device_ms": timing.device_ms(kernel), "bound_ms": base["bound_ms"],
                   "plain_ms": base["plain_ms"], "library_ms": base["library_ms"]}
            rows[(case, dtype, (bq, bk))] = row
            print("flash_tiles " + json.dumps(row))
    return rows


def flash_rule_check(ops) -> None:
    """The built kernel's answer to which tile pairs it takes at each head
    dim and dtype against :func:`repro_torch.kernels.ops.flash_takes`, the
    rule the wrapper maps schedules with; and every head dim up to 256 has
    a pair."""
    import torch

    from repro_torch.kernels import build

    takes = ops.bind_flash_takes(build.load("flash_attention"))
    pairs = 0
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in range(4, 257, 4):
            found = [(bq, bk) for bq in ops.FLASH_Q_TILES for bk in ops.FLASH_KV_TILES
                     if ops.flash_takes(d, dtype, bq, bk)]
            built = [(bq, bk) for bq in ops.FLASH_Q_TILES for bk in ops.FLASH_KV_TILES
                     if takes(d, code, bq, bk)]
            if found != built or not found:
                raise AssertionError(f"flash tile rule at D={d} {dtype}: wrapper {found}, "
                                     f"kernel {built}")
            pairs += len(found)
    print(f"flash_rule: the wrapper's tile rule agrees with the kernel's at every D "
          f"in 4..256 and both dtypes ({pairs} (D, dtype, pair) cases)")


# the Explorer facade over the nas phase's space and criteria, with
# kernel_tuning.yaml's sections: the kernel-schedule tuner (mode cached,
# budget 5), measured latency at batch 4, a disk cache
EXPLORE_TUNE_BUDGET = 5
# xlstm-1.3b's mLSTM call, (B, L, H, P), tuned directly in both dtypes
EXPLORE_MLSTM_SHAPE = (1, 2048, 4, 1024)


def explore_spec(backend: str, workers: int, cache_dir: str) -> dict:
    """The explore phase's experiment, as a dict (the card's machine has no
    PyYAML): ``NAS_SPACE`` at zamba2-2.7b's widths, the nas phase's three
    criteria on target ``h100``, the random sampler at seed 0, ``NAS_TRIALS``
    trials, kernel tuning cached at budget ``EXPLORE_TUNE_BUDGET``."""
    return {
        "name": f"explore-{backend}",
        "search_space": NAS_SPACE,
        "sampler": {"name": "random", "seed": 0},
        "executor": {"backend": backend, "n_workers": workers},
        "criteria": [
            {"estimator": "n_params", "kind": "hard_constraint", "limit": 2e8},
            {"estimator": "latency_s", "kind": "objective",
             "params": {"batch": NAS_BATCH, "metric": "measured"}},
            {"estimator": "peak_bytes", "kind": "soft_constraint", "limit": 16e9,
             "weight": 0.1, "params": {"batch": NAS_BATCH}},
        ],
        "kernel_tuning": {"mode": "cached", "budget": EXPLORE_TUNE_BUDGET},
        "target": "h100",
        "cache": {"dir": cache_dir},
        "budget": {"n_trials": NAS_TRIALS},
        "report_dir": cache_dir,
    }


def _tuning_rows(records) -> list:
    """Each tuning record as the explore line prints it: the kernel, its
    shape bucket, the winner, and every timed candidate's requested,
    effective and launched schedule with its ms."""
    return [{
        "kernel": r["kernel"], "bucket": r["bucket"], "winner": r["schedule"],
        "candidates": [{"requested": c["schedule"], "effective": c["effective"],
                        "launched": c["launched"], "ms": c["latency_s"] * 1e3}
                       for c in r["candidates"]],
    } for r in records]


def explore_phase(torch, ops) -> dict:
    """The Explorer facade on the card, three runs of ``explore_spec`` in
    this process: serial on a fresh disk cache (cold: the tuner sweeps),
    serial again on the same cache (warm: nothing is tuned, every estimator
    value is read from disk, no candidate is generated), and the process
    backend with 2 spawned workers on a fresh cache.  Each prints an
    ``explore`` line.  Raises if the warm run tunes, generates, misses or
    launches, if the runs disagree on the best trial, or if ``ssm_scan`` or
    ``flash_attention`` was launched no time in the cold or process run.  Then tunes
    ``mlstm_scan`` at xlstm-1.3b's shape in both dtypes through
    ``ScheduleTuner.tune``: every candidate chunk (512 included) must
    launch.  Returns the runs' summaries."""
    import tempfile

    from repro_torch.explorer.explorer import Explorer
    from repro_torch.hwgen.autotune import ScheduleTuner
    from repro_torch.hwgen.generator import generate_call_count
    from repro_torch.hwgen.targets import get_target

    kernels = ("ssm_scan", "flash_attention")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="explore-") as tmp:
        plan = (("serial_cold", "serial", 1, f"{tmp}/cache"),
                ("serial_warm", "serial", 1, f"{tmp}/cache"),
                ("process", "process", 2, f"{tmp}/cache_process"))
        for name, backend, workers, cache_dir in plan:
            ops.LAUNCHES.clear()
            generated = generate_call_count()
            t0 = time.perf_counter()
            explorer = Explorer.from_dict(explore_spec(backend, workers, cache_dir))
            report = explorer.run(save_report=False)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            kt = report.kernel_tuning
            trials = [{"number": t.number, "signature": t.user_attrs.get("signature"),
                       "state": t.state.value, "latency_s": t.user_attrs.get("latency_s"),
                       "peak_bytes": t.user_attrs.get("peak_bytes"),
                       "kernel_schedules": t.user_attrs.get("kernel_schedules")}
                      for t in explorer.study.trials]
            # candidates placed and run once: this process's, and each spawned
            # worker's (their counts start at 0)
            per_pid = {}
            for tr in explorer.study.trials:
                w = tr.user_attrs.get("worker") or {}
                if w.get("pid") not in (None, os.getpid()):
                    per_pid[w["pid"]] = max(per_pid.get(w["pid"], 0), w["generates"])
            generates = generate_call_count() - generated + sum(per_pid.values())
            run = {
                "run": name, "backend": backend, "n_workers": workers, "wall_s": wall_s,
                "states": report.states, "best": report.best, "trials": trials,
                "tunes": kt["tunes"], "tune_cache_hits": kt["cache_hits"],
                "tune_time_s": kt["tune_time_s"], "schedules": kt["schedules"],
                "tuning": _tuning_rows(kt["records"] or []),
                "cache": report.cache, "generates": generates,
                "LAUNCHES": {k: report.kernel_launches.get(k, 0) for k in kernels},
            }
            runs[name] = run
            print("explore " + json.dumps(run))
            # the warm run reads every value from disk: it launches nothing
            missing = [k for k in kernels if (run["LAUNCHES"][k] == 0) != (name == "serial_warm")]
            if missing or report.states.get("complete") != NAS_TRIALS:
                raise AssertionError(f"explore {name}: kernels {missing} launched "
                                     f"{run['LAUNCHES']} times, or not every trial "
                                     f"completed: {report.states}")
        warm = runs["serial_warm"]
        if (warm["tunes"] != 0 or warm["generates"] != 0 or warm["cache"]["misses"] != 0
                or warm["cache"]["disk_hits"] == 0):
            raise AssertionError(f"explore: the warm run tuned {warm['tunes']} buckets, "
                                 f"generated {warm['generates']} candidates and missed "
                                 f"{warm['cache']['misses']} values: {warm['cache']}")
        bests = {name: (r["best"] or {}).get("number") for name, r in runs.items()}
        if len(set(bests.values())) != 1 or None in bests.values():
            raise AssertionError(f"explore: the runs disagree on the best trial: {bests}")
        latency = {name: {t["number"]: t["latency_s"] for t in r["trials"]}
                   for name, r in runs.items()}
        ratios = [latency["process"][n] / latency["serial_cold"][n]
                  for n in latency["serial_cold"]
                  if latency["serial_cold"][n] and latency["process"].get(n)]
        print("explore_summary " + json.dumps({
            "best": bests, "wall_s": {name: r["wall_s"] for name, r in runs.items()},
            "process_over_serial_latency": [min(ratios), max(ratios)] if ratios else None}))

    # the mLSTM scan at xlstm-1.3b's shape: every candidate chunk launches
    b, l, h, p = EXPLORE_MLSTM_SHAPE
    tuner = ScheduleTuner(get_target("h100"), budget=EXPLORE_TUNE_BUDGET)
    shapes = {"q": (b, l, h, p), "k": (b, l, h, p), "v": (b, l, h, p),
              "i_log": (b, l, h), "f_log": (b, l, h)}
    mlstm = {}
    for dtype in ("float32", "bfloat16"):
        before = ops.LAUNCHES["mlstm_scan"]
        record = tuner.tune("mlstm_scan", shapes, {"dtype": dtype})
        torch.cuda.synchronize()
        launched = [c["launched"]["chunk"] for c in record["candidates"]]
        calls = (tuner.warmup + tuner.iters) * len(record["candidates"])
        row = {"dtype": dtype, "shape": list(EXPLORE_MLSTM_SHAPE),
               "winner": record["schedule"], "tune_time_s": record["tune_time_s"],
               "tuning": _tuning_rows([record]),
               "launches": ops.LAUNCHES["mlstm_scan"] - before, "expected_launches": calls}
        mlstm[dtype] = row
        print("explore_mlstm " + json.dumps(row))
        if sorted(launched) != [32, 64, 128, 256, 512] or row["launches"] != calls:
            raise AssertionError(f"explore: mlstm_scan {dtype} launched chunks {launched} "
                                 f"({row['launches']} launches, expected {calls})")
    return {"runs": runs, "mlstm": mlstm}


def modelled_phase(torch, ops, nas=None) -> dict:
    """``latency_s`` at ``metric: modelled`` on target ``h100`` at batch
    ``NAS_BATCH`` over the nas phase's candidates (``NAS_SPACE``, the random
    sampler at seed 0, ``NAS_TRIALS`` trials): for each, the program's
    operations and bytes (``hwgen.generator.program_cost``), the roofline
    terms, the kernel calls and their share of the operations, and, given
    the nas phase's summary, its measured ``latency_s`` and measured over
    modelled.  Raises if the estimator's value is not the printed bound, or
    if counting launched a kernel, allocated on the card or generated a
    candidate.  Returns the rows."""
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.space import parse_search_space
    from repro_torch.core.translate import sample_architecture
    from repro_torch.evaluation.estimators import CompiledLatencyEstimator
    from repro_torch.hwgen.generator import generate_call_count, program_cost
    from repro_torch.hwgen.roofline import roofline_terms
    from repro_torch.hwgen.targets import get_target
    from repro_torch.search.samplers import RandomSampler
    from repro_torch.search.study import Study

    space = parse_search_space(NAS_SPACE)
    builder = ModelBuilder(space.input_shape, space.output_dim)
    estimator = CompiledLatencyEstimator("h100", batch=NAS_BATCH, metric="modelled")
    chip = get_target("h100").chip
    measured = {row["signature"]: row["latency_s"] for row in (nas or {}).get("trials", ())}
    c, l = space.input_shape
    rows = []

    def objective(trial):
        model = builder.build(sample_architecture(space, trial))
        t0 = time.perf_counter()
        value = estimator.estimate(model)
        count_s = time.perf_counter() - t0
        cost = program_cost(model, (torch.empty(NAS_BATCH, l, c, device="meta"),))
        r = roofline_terms(hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
                           collective_bytes=cost.collective_bytes, n_chips=1, chip=chip)
        sig = model.arch.signature()
        kernels = {}
        for call in cost.kernel_calls:
            kernels[call["kernel"]] = kernels.get(call["kernel"], 0) + call["calls"]
        lat = measured.get(sig)
        rows.append({
            "trial": trial.number, "signature": sig, "latency_s": value,
            "flops": cost.flops, "bytes": cost.bytes_accessed,
            "compute_s": r.compute_s, "memory_s": r.memory_s, "dominant": r.dominant,
            "bound_s": r.bound_s, "kernel_calls": kernels,
            "kernel_flops_share": cost.kernel_flops / cost.flops,
            "count_s": count_s,
            "measured_latency_s": lat if lat is not None else "not measured",
            "measured_over_modelled": lat / r.bound_s if lat is not None else "not measured",
        })
        if value != r.bound_s:
            raise AssertionError(f"modelled: {sig}: the estimator gave {value} s, the "
                                 f"roofline of its count {r.bound_s} s")
        return value

    torch.cuda.synchronize()
    launches, held, generated = dict(ops.LAUNCHES), torch.cuda.memory_allocated(), \
        generate_call_count()
    Study(name="modelled-h100", sampler=RandomSampler(seed=0)).optimize(objective, NAS_TRIALS)
    torch.cuda.synchronize()
    moved = {"launches": dict(ops.LAUNCHES) != launches,
             "memory_allocated": torch.cuda.memory_allocated() != held,
             "generates": generate_call_count() != generated}
    for row in rows:
        print("modelled " + json.dumps(row))
    print("modelled_summary " + json.dumps({
        "target": "h100", "batch": NAS_BATCH, "trials": len(rows),
        "compute_peak_flops": chip.peak_flops_bf16, "hbm_bytes_per_s": chip.hbm_bandwidth,
        "touched_the_card": moved}))
    if any(moved.values()) or len(rows) != NAS_TRIALS:
        raise AssertionError(f"modelled: counting moved {moved}, or not every trial "
                             f"was counted ({len(rows)} of {NAS_TRIALS})")
    return {"rows": rows}


# the explore phase's spec with a fidelity cascade: a synflow screen of
# cohorts of 8, half promoted to the measured final stage
CASCADE_TRIALS = 8
CASCADE_FIDELITY = {
    "generation": 8,
    "stages": [{"name": "zero_cost",
                "criteria": [{"estimator": "synflow", "kind": "objective",
                              "direction": "minimize"}],
                "keep": {"top_frac": 0.5}}],
}
# a promoted candidate's latency_s in the process run against the serial
# run's: the bound of the -m cuda test of the process backend
CASCADE_LATENCY_REL = 0.05


def cascade_phase(torch, ops) -> dict:
    """``Explorer`` over the explore phase's spec with ``CASCADE_FIDELITY``
    and ``CASCADE_TRIALS`` trials, serial, then with the process backend (2
    spawned workers, a fresh store).  Each run prints its funnel, the
    Spearman of each stage, the kernel launches and wall time of screening
    (the parent screens every cohort) against the rest of the run, and the
    best trial.  Raises unless screening launched a kernel, the runs agree
    on the screened set and the best trial, and each promoted candidate's
    ``latency_s`` agrees within ``CASCADE_LATENCY_REL``.  Returns the
    runs' summaries."""
    import collections
    import tempfile

    from repro_torch.explorer.explorer import Explorer, SpecObjective
    from repro_torch.hwgen.generator import generate_call_count

    runs = {}
    screen_cohort = SpecObjective.screen_cohort
    with tempfile.TemporaryDirectory(prefix="cascade-") as tmp:
        for backend, workers in (("serial", 1), ("process", 2)):
            screening = {"wall_s": 0.0, "launches": collections.Counter()}

            def timed(self, trials):
                before, t0 = dict(ops.LAUNCHES), time.perf_counter()
                try:
                    return screen_cohort(self, trials)
                finally:
                    torch.cuda.synchronize()
                    screening["wall_s"] += time.perf_counter() - t0
                    for kernel, n in ops.LAUNCHES.items():
                        screening["launches"][kernel] += n - before.get(kernel, 0)

            spec = dict(explore_spec(backend, workers, f"{tmp}/{backend}"),
                        name=f"cascade-{backend}", fidelity=CASCADE_FIDELITY,
                        budget={"n_trials": CASCADE_TRIALS})
            ops.LAUNCHES.clear()
            generated = generate_call_count()
            t0 = time.perf_counter()
            with mock.patch.object(SpecObjective, "screen_cohort", timed):
                explorer = Explorer.from_dict(spec)
                report = explorer.run(save_report=False)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            trials = explorer.study.trials
            run = {
                "run": backend, "n_workers": workers, "wall_s": wall_s,
                "screening_wall_s": screening["wall_s"],
                "after_screening_wall_s": wall_s - screening["wall_s"],
                "screening_launches": dict(screening["launches"]),
                "funnel": report.fidelity["funnel"],
                "spearman": report.fidelity["spearman"],
                "states": report.states, "best": report.best,
                "screened": sorted(t.number for t in trials
                                   if t.user_attrs.get("fidelity_stage") == "zero_cost"),
                "promoted": {t.number: {"signature": t.user_attrs.get("signature"),
                                        "synflow": t.user_attrs.get("synflow"),
                                        "latency_s": t.user_attrs.get("latency_s")}
                             for t in trials
                             if t.user_attrs.get("fidelity_stage") == "promoted"},
                "parent_generates": generate_call_count() - generated,
                "kernel_launches": report.kernel_launches,
            }
            runs[backend] = run
            print("cascade " + json.dumps(run))
            if sum(run["screening_launches"].values()) == 0:
                raise AssertionError(f"cascade {backend}: screening launched no kernel: "
                                     f"{run['screening_launches']}")
    serial, process = runs["serial"], runs["process"]
    ratios = {n: process["promoted"][n]["latency_s"] / p["latency_s"]
              for n, p in serial["promoted"].items()
              if p["latency_s"] and (process["promoted"].get(n) or {}).get("latency_s")}
    print("cascade_summary " + json.dumps({
        "screened": {k: r["screened"] for k, r in runs.items()},
        "best": {k: (r["best"] or {}).get("number") for k, r in runs.items()},
        "process_over_serial_latency": ratios}))
    if (serial["screened"] != process["screened"] or serial["best"] is None
            or (process["best"] or {}).get("number") != serial["best"]["number"]):
        raise AssertionError(f"cascade: the runs disagree on the screened set or the best "
                             f"trial: {serial['screened']} / {process['screened']}, "
                             f"{serial['best']} / {process['best']}")
    if sorted(ratios) != sorted(serial["promoted"]) or any(
            abs(r - 1) > CASCADE_LATENCY_REL for r in ratios.values()):
        raise AssertionError(f"cascade: promoted latencies, process over serial: {ratios}")
    return runs


# the phases that drive a whole model, by name
MODEL_PHASES = {
    "xlstm_forward": xlstm_forward_phase,
    "xlstm_forward_bf16": xlstm_forward_bf16_phase,
    "xlstm_serve": functools.partial(lm_serve_phase, name="xlstm",
                                     argv=XLSTM_SERVE_ARGS),
    "zamba2_forward": zamba2_forward_phase,
    "zamba2_serve": functools.partial(lm_serve_phase, name="zamba2",
                                      argv=ZAMBA2_SERVE_ARGS),
    "moe_forward": moe_forward_phase,
    "paligemma_forward": paligemma_forward_phase,
    "paligemma_serve": functools.partial(lm_serve_phase, name="paligemma",
                                         argv=PALIGEMMA_SERVE_ARGS),
    "whisper_forward": whisper_forward_phase,
}
SUBSET_PHASES = ("flash", "ssm", "nas", "modelled", "explore", "cascade", "mlstm",
                 *MODEL_PHASES)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--phases", default="",
        help=f"run only these phases (comma-separated, of {', '.join(SUBSET_PHASES)}) "
             f"after the environment and the build, and print no result line: for "
             f"comparing two trees in one run (default: every phase)")
    subset = [name for name in parser.parse_args(argv).phases.split(",") if name]
    unknown = sorted(set(subset) - set(SUBSET_PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {SUBSET_PHASES}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build, ops, ref, timing
    from repro_torch.launch import serve

    # -- 1. environment ----------------------------------------------------
    smi = timing.card()
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
        # each compiled kernel's registers; the ones that spill by name
        kernel, used, spills = None, [], []
        for line in log.splitlines():
            if "Compiling entry" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            elif "spill stores" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
            elif "Used" in line and "registers" in line:
                used.append(int(line.split("Used")[1].split()[0]))
        print(f"  {name}: {len(used)} kernels, registers {min(used, default=0)}-"
              f"{max(used, default=0)}, {len(spills)} spilling")
        for line in spills:
            print(f"  {name} spills: {line}")

    if subset:
        gen = torch.Generator(device="cuda").manual_seed(0)
        nas = None  # the modelled phase prints the nas phase's latency_s when it ran
        for name in subset:
            if name == "flash":
                flash_rule_check(ops)
                flash_phase(torch, ops, gen)
            elif name == "ssm":
                ssm_phase(torch, ops, ref, gen)
            elif name == "nas":
                nas = nas_phase(torch, ops, ref)
            elif name == "modelled":
                modelled_phase(torch, ops, nas)
            elif name == "explore":
                explore_phase(torch, ops)
            elif name == "cascade":
                cascade_phase(torch, ops)
            elif name == "mlstm":
                mlstm_phase(torch, ops, ref, gen)
            elif name in MODEL_PHASES:
                MODEL_PHASES[name](torch, ops, ref, serve)
        return 0

    # -- 3. kernel against plain version ----------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rule_check(ops)
    kernel_rows = flash_phase(torch, ops, gen)

    # -- 3b. the SSD scan against its plain version -------------------------
    ssm_rows = ssm_phase(torch, ops, ref, gen)

    # -- 4. serve at full width -------------------------------------------
    args = serve.parse_args(SERVE_ARGS)
    plain_calls = []
    ops.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(ref, "flash_attention_ref",
                           _counted(plain_calls, ref.flash_attention_ref)):
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
        with mock.patch.object(ops, "flash_attention", _flash_plain):
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

    # -- 6b. metric: modelled over the nas phase's candidates ----------------
    modelled_phase(torch, ops, nas)

    # -- 6c. the Explorer facade with the kernel-schedule tuner -------------
    torch.cuda.empty_cache()
    explore = explore_phase(torch, ops)

    # -- 6d. the fidelity cascade: a synflow screen before the measurement --
    torch.cuda.empty_cache()
    cascade = cascade_phase(torch, ops)

    # -- 7. the mLSTM scan against its plain version -----------------------
    mlstm_rows = mlstm_phase(torch, ops, ref, gen)

    # -- 8. the xlstm-1.3b forward through the kernel -----------------------
    xfwd = xlstm_forward_phase(torch, ops, ref, serve)
    xfwd16 = xlstm_forward_bf16_phase(torch, ops, ref, serve)

    # -- 9. serving xlstm-1.3b ----------------------------------------------
    xserve = lm_serve_phase(torch, ops, ref, serve, "xlstm", XLSTM_SERVE_ARGS)

    # -- 10. zamba2-2.7b: its forward, then serving it -----------------------
    zfwd = zamba2_forward_phase(torch, ops, ref, serve)
    zserve = lm_serve_phase(torch, ops, ref, serve, "zamba2", ZAMBA2_SERVE_ARGS)

    # -- 11. dbrx-132b at its published widths, one layer ---------------------
    moe = moe_forward_phase(torch, ops, ref, serve)

    # -- 12. paligemma-3b: its forward with a patch prefix, then serving it ----
    pfwd = paligemma_forward_phase(torch, ops, ref, serve)
    pserve = lm_serve_phase(torch, ops, ref, serve, "paligemma", PALIGEMMA_SERVE_ARGS)

    # -- 13. whisper-medium: encoder, decoder, the cached path ----------------
    wfwd = whisper_forward_phase(torch, ops, ref, serve)

    # -- 14. result --------------------------------------------------------
    served = kernel_rows[(REPORTED_CASE, "float32")]
    scan = ssm_rows[(SSM_REPORTED_CASE, "float32", "float32")]
    mscan = mlstm_rows[(MLSTM_REPORTED_CASE, "float32")]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": launches.get("flash_attention", 0),
        "launches_by_path": {"serve": launches.get("flash_attention", 0),
                             "nas": nas["launches"].get("flash_attention", 0),
                             **{f"explore_{name}": r["LAUNCHES"]["flash_attention"]
                                for name, r in explore["runs"].items()},
                             **{f"cascade_{name}_screening":
                                r["screening_launches"].get("flash_attention", 0)
                                for name, r in cascade.items()},
                             "zamba2_forward": zfwd["launches"].get("flash_attention", 0),
                             "zamba2_serve": zserve["flash_attention_launches"],
                             "moe_forward": moe["launches"].get("flash_attention", 0),
                             "paligemma_forward": pfwd["launches"].get("flash_attention", 0),
                             "paligemma_serve": pserve["flash_attention_launches"],
                             "whisper_forward": wfwd["launches"].get("flash_attention", 0),
                             "whisper_prefill":
                                 wfwd["cached"]["prefill_launches"].get("flash_attention", 0)},
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"], "library_ms": served["library_ms"],
        "device_ms": served["device_ms"], "library_device_ms": served["library_device_ms"],
        "shape": "B=1 S=T=512 H=16 KH=8 D=128 causal float32",
    }, {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:76",
        "launches": nas["launches"].get("ssm_scan", 0),
        "launches_by_path": {"nas": nas["launches"].get("ssm_scan", 0),
                             **{f"explore_{name}": r["LAUNCHES"]["ssm_scan"]
                                for name, r in explore["runs"].items()},
                             **{f"cascade_{name}_screening":
                                r["screening_launches"].get("ssm_scan", 0)
                                for name, r in cascade.items()},
                             "zamba2_forward": zfwd["launches"].get("ssm_scan", 0),
                             "zamba2_serve": zserve["ssm_scan_launches"]},
        "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": None,
        "library": SSM_NO_LIBRARY, "device_ms": scan["device_ms"],
        **{key: scan[key] for key in SSM_PASSES},
        "shape": "B=4 L=2048 H=80 G=1 N=64 P=64 chunk=128 float32",
    }, {
        "name": "mlstm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_scan.cu",
        "replaces": "src/repro/kernels/mlstm_scan.py:88",
        "launches": xfwd["mlstm_scan_launches"],
        "launches_by_path": {"xlstm_forward": xfwd["mlstm_scan_launches"],
                             "xlstm_forward_bf16": xfwd16["mlstm_scan_launches"],
                             "xlstm_serve": xserve["mlstm_scan_launches"],
                             **{f"explore_tune_{dtype}": r["launches"]
                                for dtype, r in explore["mlstm"].items()}},
        "max_abs_err": mscan["max_abs_err"], "ms": mscan["ms"],
        "plain_ms": mscan["plain_ms"], "bound_ms": mscan["bound_ms"],
        "bound_by": mscan["bound_by"], "library_ms": None,
        "library": MLSTM_NO_LIBRARY, "device_ms": mscan["device_ms"],
        **{key: mscan[key] for key in MLSTM_PASSES},
        "shape": "B=1 L=2048 H=4 P=1024 chunk=128 float32",
    }]}))
    print(timing.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
