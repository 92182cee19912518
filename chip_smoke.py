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
6e. sweep: ``repro_torch.explorer.sweep.run_sweep`` three times.  The
   port's ``sweep_small.yaml`` (conv_pool, ``metric: modelled``, targets
   host_cpu, edge_npu and h100 by samplers random and grid, 6 trials): the
   edge_npu cells count no forward the host_cpu cells counted, the h100
   cells measure ``peak_bytes`` on the card under their own ``@cuda``
   scope, and a second run resumes all 6 cells doing nothing.  A kernel
   sweep: the explore phase's spec by samplers random and grid: both
   kernels launched through ``run_sweep``, the plain versions never, the
   random cell's six candidates the nas phase's, the grid cell re-tuning
   nothing, a resumed second run doing nothing; each kernel, in the
   fastest candidate that reaches it on its tuned schedule, held to its
   plain versions as in 6.  Then ``hw_parallel.yaml`` at target h100,
   serial and with 2 spawned workers: the same best trial, every
   candidate's ``peak_bytes`` within 1% of the serial run's, and the
   workers' fp32 flags (TF32 for matmuls and cuDNN, the matmul precision)
   the parent's;
6f. serving: ``serving.yaml``'s traffic-shaped criteria at target h100
   over its conv_pool space (8 trials) and over the nas phase's space (6
   trials): every ``prefill_latency_s`` the roofline bound of the counted
   forward at ``max_batch``, every ``decode_latency_s`` the reference's
   formula, a decode state for every candidate of the nas space; nothing
   launched, allocated on the card or generated;
6g. report_boot: the paper's deploy-best mode.  The explore phase's spec
   over zamba2-2.7b's hybrid of the nas phase's layers (one or two Mamba2
   blocks, then its attention block) with ``serving.yaml``'s traffic, 6
   trials, with the artifact store and without it (its cost to the
   search; each stored program's export seconds and bytes); then
   ``python -m repro_torch.launch.serve --from-report`` in a fresh
   process: booted from the store it must generate nothing, serve all 24
   requests and launch flash and ``ssm_scan`` on every batch; with
   ``REPRO_ARTIFACTS=0`` it generates once; the loaded program's output
   against the eager candidate's (printed; expected equal bit for bit)
   and against the plain versions (1e-3 of its max);
6h. remote: the remote worker pool.  ``warmup()`` in a spawned process
   (its split: import, CUDA context, kernel libraries, cuBLAS, the first
   meta forward's imports), then 2 daemons (``python -m
   repro_torch.worker``) and their own splits; the explore phase's spec
   through ``executor: remote`` and serially: every trial in a daemon,
   flash and ``ssm_scan`` launched there, the serial best trial, each
   latency within 5% and peak within 1%; again with SIGTERM to one daemon
   while it measures: resubmitted at once on its ``shutdown`` frame, every
   trial completed, the same best trial, the measurement gate free after;
   the sweep phase's kernel sweep fanned to the surviving daemon: both
   cells computed there and persisted here, the local sweep's best trials
   (or a trial it measured within 5% of one),
   a resumed re-run doing nothing; no degradation warning anywhere.  After
   the first explore run (``remote_hostless``), the same spec again from a
   parent without a card (``CUDA_VISIBLE_DEVICES= python -m
   repro_torch.explorer spec.json --device cpu --remote-workers ...``): the
   first run's trial params, states and best trial, each latency within 5%
   and peak within 1% of it, flash and ``ssm_scan`` launched in the daemons;
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
   time by kind of kernel (the sLSTM and mLSTM blocks' host ranges are no
   longer recorded: processing them took ~165 s of the phase's ~185); then
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
14. training: ``python -m repro_torch.launch.train --arch qwen3-1.7b`` in
   process at full width (fp32, AdamW with the CLI's cosine schedule, batch
   4 x 512 tokens, 8 steps; ``train``): every loss finite, the last below
   the first, no kernel launched (training runs the plain math, as the
   reference's does), the plain attention once a layer a step (twice with
   remat, the spec's default: the backward recomputes each layer); its step
   times, tokens/s, allocator peak and device time by kind over one step.
   ``train_check``: the same widths cut to 2 layers, one step in fp32 and
   in float64 from the same weights and batch: each gradient tensor and
   the parameters after AdamW held to the float64 step, and a microbatch-4
   step to the single one.  ``train_resume``: the CLI at ``--smoke``,
   with and without compression: 12 steps checkpointing every 5 then a
   rerun to 20 (resumed from step 10), and a run preempted by SIGTERM
   after step 10 and resumed, which must end on the uninterrupted run's
   loss.  ``train_mesh``, in a child process: the CLI's 4 steps of the
   same shape on the plain path, then on a (1, 1) NCCL mesh with every
   parameter and moment a DTensor; losses and parameters equal (or within
   ``TRAIN_MESH_ATOL``), each path's step ms, allocator peak and model
   TFLOP/s;
14c. dryrun: the multi-pod dry run (``python -m repro_torch.launch.dryrun``)
   under this machine's torch, each cell in a child process with the cards
   hidden: qwen3-1.7b train_4k on (16, 16) and, without the cost counters,
   on (2, 16, 16), dbrx-132b train_4k with ``--opt``'s variant cut to 8 of
   its 40 layers (no cost counters), and zamba2-2.7b long_500k; each must
   be ``ok`` (status, seconds, collective
   bytes by kind printed).  Then the dry run held to the card: qwen3-1.7b
   cut to 2 layers at batch 4 x 512, its (1, 1) record on the fake group
   against the same step on a (1, 1) NCCL mesh: ``argument_bytes`` equal to
   the card's parameters, moments and batch and to the bytes the caching
   allocator was asked for them (its blocks round each up to 512 bytes, or
   more where a large block is not split), no collective; MemTracker's
   peak over the card's printed;
14d. pod_nas: the paper's mode-2 LM search (``examples/torch/
   hw_in_loop_nas_lm.py``), in a child process: 3 trials on ``h100_pod``
   (256 cards over the fake process group, bf16 parameters laid out on
   ``meta`` at the reference's widths, each counted at 1 and 2 layers and
   extrapolated), each trial's counting seconds, per-device argument and
   peak GB, collective bytes and roofline terms printed; then its best
   candidate cut to 2 layers laid out on a (1, 1) NCCL mesh on the card,
   the counted ``argument_bytes`` held to the card's parameter and token
   bytes and to the bytes the allocator was asked for them.  Before it,
   here and alone on the host, 2 trials of its ``h100`` branch measured on
   the card (sequence 128, batch 2, fp32); the child then runs beside the
   dryrun phase's children.  No kernel is launched (the backbones run the
   plain math);
15. val_accuracy: the paper's Listing 3 through the port's
   ``examples/torch/nas_conv1d.py`` (its space, data, criteria and study),
   training and latency on the card, 6 trials with TPE and successive
   halving; the best trial trained again on the CPU from the same weights
   must agree; then the example's deploy of the winner (measured latency,
   counted FLOPs, its peak within the card's memory);
15b. examples: the port's copies of the reference's other examples, in a
   scratch directory: ``quickstart`` at target h100 and at host_cpu (the
   same trials and best; the winner's output on the card within 1e-5 of
   its max of the same weights' on the CPU), ``nas_parallel --tiny
   --trials 8 --workers 2`` on threads (serial and thread best equal, the
   candidates sampled at host_cpu), ``train_lm --full`` 100 steps then
   resumed to 110 (losses at 25, 50, 75 and 100 finite and falling, step
   ms, tokens/s, allocator peak) and ``elastic_restart`` on a (1, 1) NCCL
   mesh (the restart at step 10 from parameters equal to those saved, the
   group destroyed after); no kernel launched;
16. each phase's wall seconds (``phase_seconds``), a JSON line per
   kernel, the card's name and power limit, and the ``{"ok": true, ...}``
   line last.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import functools
import json
import math
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

# training (the train CLI at full width; fp32 against float64 at depth 2;
# resume; the paper's Listing 3 with val_accuracy)
TRAIN_ARGS = ["--arch", "qwen3-1.7b", "--steps", "8", "--seq", "512",
              "--global-batch", "4", "--log-every", "1"]
TRAIN_RANGES = ("train.value_and_grad", "train.optimizer_update")
TRAIN_CHECK_DEPTH = 2  # of 28: a float64 copy of every layer would not fit beside fp32
TRAIN_GRAD_REL = 1e-3  # each fp32 gradient tensor vs float64, of its max |float64 gradient|
TRAIN_OPT_REL = 1e-5  # fp32 AdamW arithmetic vs float64, of the tensor's max |parameter|
TRAIN_MB_ATOL = 1e-4  # microbatch 4 vs 1, as tests/test_train_infra.py holds them
TRAIN_RESUME_ARGS = ["--arch", "qwen3-1.7b", "--smoke", "--seq", "32",
                     "--global-batch", "2", "--log-every", "100"]
# resumed vs uninterrupted final loss: where the card's backward is not
# deterministic (the embedding's gradient may sum with atomics); with
# compression the error-feedback residual is not checkpointed
RESUME_REL = 1e-5
RESUME_COMPRESSION_REL = 1e-2
# sharded training on one card: the train CLI on a (1, 1) NCCL mesh with
# DTensor parameters and optimizer state, against the plain path from the
# same seed; 4 steps of TRAIN_ARGS's shape
TRAIN_MESH_ARGS = ["--arch", "qwen3-1.7b", "--steps", "4", "--seq", "512",
                   "--global-batch", "4", "--log-every", "100"]
TRAIN_MESH_ATOL = 1e-6  # tests/test_torch_train.py's OPT_ATOL, per element, where bits differ
# the dry run's CLI cells (arch, shape, mesh, extra arguments), each in a
# child process with the cards hidden, all at once; dbrx with --opt's
# variant (selective remat, the chunked loss, the MoE step on DTensor),
# without the cost counters (a third of its time) and cut to its first 8
# layers: all 40 took 81.5 s of a 95.9 s phase on an NVIDIA H100 80GB
# HBM3's host, in a whole run that came within 14 s of the script's
# 1,200 s limit
DRYRUN_CELLS = [
    ("qwen3-1.7b", "train_4k", "single", []),
    ("qwen3-1.7b", "train_4k", "multi", ["--no-cost"]),
    ("dbrx-132b", "train_4k", "single",
     ["--variant", "chunked_loss,remat_dots,seq_shard,moe_2d", "--no-cost", "--units", "8"]),
    ("zamba2-2.7b", "long_500k", "single", []),
]
# the dry run held to the card: qwen3-1.7b cut to 2 layers, batch 4 x 512
DRYRUN_CHECK = {"arch": "qwen3-1.7b", "layers": 2, "batch": 4, "seq": 512}
DRYRUN_ALLOC_ROUND = 512  # the caching allocator's least rounding of a block
# the paper's mode-2 LM search (examples/torch/hw_in_loop_nas_lm.py): its
# study on h100_pod counted on the host in a child process, its best
# candidate cut to POD_CHECK_LAYERS laid out on the card; its h100 branch
# measured here
POD_EXAMPLE = ROOT / "examples" / "torch" / "hw_in_loop_nas_lm.py"
POD_TRIALS = 3
POD_MEASURED_TRIALS = 2
POD_CHECK_LAYERS = 2
POD_BATCH, POD_SEQ = 32, 2048  # the reference's defaults
LISTING3_TRIALS = 6
LISTING3_STEPS = 40
VAL_LOSS_REL = 1e-3  # the best trial's last training loss, card vs CPU (40 fp32 SGD steps)
# quickstart's winner on the card against the same weights on the CPU (TF32 off)
QUICKSTART_OUT_REL = 1e-5


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


def _ranged(name, fn):
    """``fn`` inside a ``torch.profiler`` range named ``name``."""
    from torch.profiler import record_function

    def wrapper(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapper


def _counted(calls, fn):
    def wrapper(*a, **kw):
        calls.append(fn.__name__)
        return fn(*a, **kw)
    return wrapper


def profile_by_kind(torch, label, step, ranges=(), inference=True) -> dict:
    """One run of ``step`` (which ends in a device sync) under
    ``torch.profiler``: its host wall time, device time by kind of kernel
    (GEMMs, the mLSTM scan, the SSD scan, flash attention, the rest:
    elementwise passes, copies, reductions), for each ``record_function`` range
    named in ``ranges`` the host time inside it, the device time of the
    kernels launched in it and its span on the device, and the device's
    busy share of the wall time.  The host's operators are recorded only
    when ``ranges`` are asked for.  ``step`` runs under ``inference_mode``
    unless ``inference`` is False (a train step).  Returns the printed row."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * bool(ranges) + [ProfilerActivity.CUDA]
    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(activities=activities) as prof:
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

    parts, t_part = {}, time.perf_counter()

    def part(name):  # host seconds of each part of the phase
        nonlocal t_part
        torch.cuda.synchronize()
        parts[name] = round(time.perf_counter() - t_part, 2)
        t_part = time.perf_counter()

    spec = get_arch(XLSTM_ARCH).spec()
    n_mlstm = _sub_count(spec.layers, "mlstm")
    model = LM(serve.swap_spec_impl(spec, "pallas"))
    model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = _tokens(torch, spec.vocab, XLSTM_SEQ)
    n_params = sum(t.numel() for t in model.state_dict().values())
    part("init")
    run = _kernel_forward(torch, ops, ref, model, tokens)
    logits, launches = run["logits"], run["launches"]
    del run["logits"]
    part("kernel_forwards")

    # the check: the same weights' forward with impl="xla" in float64
    xla = _xla_forwards(torch, ops, serve, spec, model, tokens)
    part("xla_forwards")
    readings = _float64_readings(logits, xla["plain"], xla["float64"])
    finite = bool(torch.isfinite(logits).all())
    logits_shape = tuple(logits.shape)
    del logits, xla["plain"], xla["float64"]
    part("readings")

    # where the time goes: device time by kind.  The host's operators are
    # not recorded: with the blocks' ranges the profiler took ~165 s to
    # process the sLSTM loops' ~260,000 launches (parts_s)
    prof = profile_by_kind(torch, f"xlstm forward B=1 L={XLSTM_SEQ}",
                           lambda: float(model(tokens)[0, -1, 0]))
    part("profile")
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
        "float64_impl_wall_ms": xla["float64_wall_ms"], **readings, "parts_s": parts,
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
    _candidate_against_plain(torch, ops, ref, "nas_best",
                             models[summary["best"]["signature"]], space.output_dim)

    # where the time goes: one forward of each candidate
    c, l = space.input_shape
    xb = torch.zeros(NAS_BATCH, l, c, device="cuda")
    for signature, cand in models.items():
        cand.to("cuda")
        profile_window(torch, f"nas forward B={NAS_BATCH} {signature}",
                       lambda: float(cand(xb).sum()))
        cand.to("cpu")
    return summary


def _candidate_against_plain(torch, ops, ref, label, model, output_dim) -> dict:
    """One NAS candidate (weights already drawn) on one seeded batch of
    ``NAS_BATCH`` through its kernels against the same forward through
    their plain versions, within ``NAS_REL_TOL`` of the output's max;
    prints a ``label`` line and raises on a miss."""
    model = model.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    c, l = model.input_shape
    x = torch.randn(NAS_BATCH, l, c, generator=gen, device="cuda")

    def plain_ssm(x_, dt, a, b, c_, *, chunk):
        return ref.ssm_scan_ref(x_, dt, a, b, c_, chunk=chunk)

    with torch.inference_mode():
        kernel_out = model(x)
        with mock.patch.object(ops, "ssm_scan", plain_ssm), \
                mock.patch.object(ops, "flash_attention", _flash_plain):
            plain_out = model(x)
        torch.cuda.synchronize()
    model.to("cpu")
    err = (kernel_out - plain_out).abs().max().item()
    tol = NAS_REL_TOL * plain_out.abs().max().item()
    finite = bool(torch.isfinite(kernel_out).all())
    row = {"signature": model.arch.signature(), "shape": list(kernel_out.shape),
           "finite": finite, "max_abs_out": plain_out.abs().max().item(),
           "max_abs_err": err, "tol": tol}
    print(f"{label} " + json.dumps(row))
    if not finite or kernel_out.shape != (NAS_BATCH, output_dim) or err > tol:
        raise AssertionError(f"{label}: max |err| {err} > {tol}, "
                             f"finite={finite}, shape {tuple(kernel_out.shape)}")
    return row


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


# examples/experiments/spaces/conv_pool.yaml (src/repro_torch/experiments/
# spaces/ holds the port's copy) as a dict: the card's machine has no PyYAML
CONV_POOL_SPACE = {
    "input": [4, 256],
    "output": 6,
    "sequence": [
        {"block": "features", "op_candidates": "conv-block",
         "type_repeat": {"type": "vary_all", "depth": [1, 2, 3]}},
        {"block": "head", "op_candidates": "linear", "linear": {"width": [32, 64]}},
    ],
    "default_op_params": {"conv1d": {"kernel_size": [3, 5], "out_channels": [8, 16]}},
    "composites": {"conv-block": {"sequence": [
        {"block": "conv", "op_candidates": "conv1d"},
        {"block": "pool", "op_candidates": ["maxpool", "identity"]}]}},
    "preprocessing": {"normalize": {"kind": ["zscore", "minmax"]}},
}
# the port's src/repro_torch/experiments/sweep_small.yaml, its space inlined
# (the phase gives it a fresh cache and report directory)
SWEEP_SMALL = {
    "name": "sweep-small",
    "base": {
        "name": "sweep-small-base",
        "search_space": CONV_POOL_SPACE,
        "sampler": {"name": "random", "seed": 0},
        "executor": {"backend": "serial"},
        "criteria": [
            {"estimator": "n_params", "kind": "hard_constraint", "limit": 2.0e6},
            {"estimator": "latency_s", "kind": "objective",
             "params": {"batch": 8, "metric": "modelled"}},
            {"estimator": "peak_bytes", "kind": "objective", "weight": 1.0e-9,
             "params": {"batch": 8}},
        ],
        "target": "host_cpu",
        "budget": {"n_trials": 6},
    },
    "axes": {"targets": ["host_cpu", "edge_npu", "h100"],
             "samplers": [{"name": "random", "seed": 0}, {"name": "grid", "seed": 0}]},
    "cache": "results/cache",
    "report_dir": "results",
}
# examples/experiments/hw_parallel.yaml at target h100 (its space inlined)
HW_PARALLEL = {
    "name": "hw-parallel",
    "search_space": CONV_POOL_SPACE,
    "sampler": {"name": "random", "seed": 0},
    "executor": {"backend": "process", "n_workers": 2},
    "schedule": {"mode": "sliding_window", "tell_order": "completion"},
    "criteria": [
        {"estimator": "n_params", "kind": "hard_constraint", "limit": 1.0e6},
        {"estimator": "peak_bytes", "kind": "soft_constraint", "limit": 64.0e6,
         "weight": 0.1, "params": {"batch": 8}},
        {"estimator": "latency_s", "kind": "objective",
         "params": {"batch": 8, "metric": "modelled"}},
    ],
    "target": "h100",
    "cache": {"dir": "results/cache"},
    "budget": {"n_trials": 12},
    "report_dir": "results",
}
# examples/experiments/serving.yaml at target h100 (its space inlined); the
# serving phase also runs it over NAS_SPACE at SERVING_NAS_TRIALS trials
SERVING_EXPERIMENT = {
    "name": "serving",
    "search_space": CONV_POOL_SPACE,
    "sampler": {"name": "random", "seed": 7},
    "executor": {"backend": "serial"},
    "criteria": [
        {"estimator": "p99_latency_s", "kind": "objective", "weight": 1.0},
        {"estimator": "throughput_tok_s", "kind": "objective", "direction": "maximize",
         "weight": 1.0e-6},
        {"estimator": "kv_cache_peak_bytes", "kind": "hard_constraint", "limit": 64.0e6},
    ],
    "serving": {
        "max_batch": 4, "queue_limit": 8, "dtype_bytes": 2,
        "traffic": {"seed": 3, "n_requests": 24, "arrival": "poisson", "rate_rps": 50.0,
                    "prompt_lens": {8: 0.75, 16: 0.25}, "gen_lens": [4, 8]},
    },
    "target": "h100",
    "cache": {"dir": "results/cache"},
    "budget": {"n_trials": 8},
    "report_dir": "results",
}
SERVING_NAS_TRIALS = 6


def _watched_sweep(torch, ops, ref, spec) -> tuple:
    """``run_sweep(spec)`` with each cell watched.  Returns the report and
    what the run did: by cell, its trials, the forwards counted on ``meta``
    (``program_cost``: signature and batch), the (kernel, bucket) pairs the
    tuner swept and the candidates generated; and over the run, the kernel
    launches, the plain versions' calls, the generates and the bytes the
    card holds after it against before."""
    from repro_torch.evaluation import estimators
    from repro_torch.explorer.explorer import Explorer
    from repro_torch.explorer.sweep import run_sweep
    from repro_torch.hwgen.autotune import ScheduleTuner
    from repro_torch.hwgen.generator import generate_call_count

    cells, current = {}, [None]
    run, count, sweep = Explorer.run, estimators.program_cost, ScheduleTuner._sweep

    def watched_run(self, *args, **kwargs):
        cell = current[0] = cells.setdefault(
            self.spec.name, {"target": self.spec.target, "counted": [], "swept": []})
        generated, launched = generate_call_count(), dict(ops.LAUNCHES)
        try:
            return run(self, *args, **kwargs)
        finally:
            cell["generates"] = generate_call_count() - generated
            cell["launches"] = {k: n - launched.get(k, 0) for k, n in ops.LAUNCHES.items()
                                if n - launched.get(k, 0)}
            cell["trials"] = [{
                "number": t.number, "state": t.state.value,
                "signature": t.user_attrs.get("signature"),
                "latency_s": t.user_attrs.get("latency_s"),
                "peak_bytes": t.user_attrs.get("peak_bytes"),
                "kernel_schedules": t.user_attrs.get("kernel_schedules")}
                for t in self.study.trials]
            cell["explorer"] = self
            current[0] = None

    def watched_count(candidate, example_args, schedules=None):
        current[0]["counted"].append([candidate.arch.signature(), example_args[0].shape[0]])
        return count(candidate, example_args, schedules=schedules)

    def watched_sweep(self, kernel, shapes, meta, bucket):
        current[0]["swept"].append([kernel, bucket])
        return sweep(self, kernel, shapes, meta, bucket)

    plain_calls = []
    torch.cuda.synchronize()
    held, generated = torch.cuda.memory_allocated(), generate_call_count()
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    with mock.patch.object(Explorer, "run", watched_run), \
            mock.patch.object(estimators, "program_cost", watched_count), \
            mock.patch.object(ScheduleTuner, "_sweep", watched_sweep):
        patches = _plain_versions(ref, plain_calls)
        for patch in patches:
            patch.start()
        try:
            report = run_sweep(spec)
        finally:
            for patch in patches:
                patch.stop()
    torch.cuda.synchronize()
    return report, {
        "cells": cells, "wall_s": time.perf_counter() - t0,
        "launches": {k: n for k, n in ops.LAUNCHES.items() if n},
        "plain_calls": len(plain_calls), "generates": generate_call_count() - generated,
        "held_bytes_moved": torch.cuda.memory_allocated() - held}


def _cell_rows(report, watch) -> list:
    """Each cell of a watched sweep as the sweep lines print it."""
    rows = []
    for cell in report.cells:
        seen = watch["cells"].get(cell["name"], {})
        rows.append({
            "cell": cell["name"], "resumed": cell["resumed"], "best": cell["best"],
            "criteria_values": cell["criteria_values"],
            "wall_clock_s": cell["wall_clock_s"], "generates": seen.get("generates", 0),
            "launches": seen.get("launches", {}),
            "counted": len(seen.get("counted", ())), "swept": seen.get("swept", []),
            "trials": seen.get("trials", [])})
    return rows


def _resumed_quietly(label, report, again, watch) -> None:
    """A re-run of a finished sweep resumes every cell: it runs no cell, so
    it counts, tunes, generates, places and launches nothing, and merges to
    the first run's matrix."""
    quiet = {"n_resumed": again.n_resumed, "cells_run": sorted(watch["cells"]),
             "launches": watch["launches"], "plain_calls": watch["plain_calls"],
             "generates": watch["generates"], "held_bytes_moved": watch["held_bytes_moved"],
             "matrix_equal": again.matrix == report.matrix}
    print(f"{label}_resumed " + json.dumps(quiet))
    if quiet != {"n_resumed": report.n_cells, "cells_run": [], "launches": {},
                 "plain_calls": 0, "generates": 0, "held_bytes_moved": 0,
                 "matrix_equal": True}:
        raise AssertionError(f"{label}: the resumed re-run did work: {quiet}")


def sweep_phase(torch, ops, ref, nas=None) -> dict:
    """``run_sweep`` on the card, three runs:

    (a) ``SWEEP_SMALL`` (the port's ``sweep_small.yaml``: conv_pool,
    ``metric: modelled``, [host_cpu, edge_npu, h100] x [random 0, grid 0],
    6 trials) on a fresh store.  Raises if an ``edge_npu`` cell counts a
    forward a ``host_cpu`` cell counted, if the ``h100`` cells generate no
    candidate (their ``peak_bytes`` is measured on the card) or the store
    holds no ``peak_bytes`` entry under each of the ``@cpu`` and ``@cuda``
    scopes, or if a second run resumes less than every cell or does any
    work.

    (b) a kernel sweep: ``explore_spec("serial", 1, ...)`` (``NAS_SPACE`` at
    zamba2-2.7b's widths, measured on ``h100``, tuning cached) over the
    samplers [random 0, grid 0].  Raises unless ``flash_attention`` and
    ``ssm_scan`` both launched and no plain version ran, the random cell's
    signatures are the nas phase's in order, the grid cell swept no
    (kernel, bucket) the random cell swept, and a second run does nothing;
    then holds each kernel, in the fastest candidate that reaches it on
    its tuned schedules, to its plain versions.

    (c) ``HW_PARALLEL`` (``hw_parallel.yaml`` at target ``h100``), serial
    and with 2 spawned workers, through ``Explorer``: every trial must
    complete and both runs must find the same best trial.

    Returns the kernel sweep's launches by cell and, by cell, its best
    trial and each trial's signature and ``latency_s``."""
    import tempfile

    from repro_torch.core.space import parse_search_space
    from repro_torch.core.translate import sample_architecture
    from repro_torch.evaluation.disk_cache import DiskEvaluationCache
    from repro_torch.explorer.explorer import Explorer
    from repro_torch.explorer.sweep import SweepSpec
    from repro_torch.kernels import schedule as ksched
    from repro_torch.search.samplers import RandomSampler
    from repro_torch.search.study import Study

    with tempfile.TemporaryDirectory(prefix="sweep-") as tmp:
        # -- (a) the port's sweep_small: three targets, two samplers ---------
        spec = SweepSpec.from_dict(dict(SWEEP_SMALL, cache=f"{tmp}/small_cache",
                                        report_dir=f"{tmp}/small"))
        report, watch = _watched_sweep(torch, ops, ref, spec)
        rows = _cell_rows(report, watch)
        for row in rows:
            print("sweep_small " + json.dumps(row))
        counted = {}
        for cell in watch["cells"].values():
            counted.setdefault(cell["target"], set()).update(map(tuple, cell["counted"]))
        scopes = {}
        for key, _ in DiskEvaluationCache(f"{tmp}/small_cache").entries():
            if isinstance(key, list) and key[0] in ("peak_bytes", "roofline_terms"):
                scopes.setdefault(f"{key[0]}@{key[1].rsplit('@', 1)[-1]}", []).append(key[3])
        h100_generates = sum(c["generates"] for c in watch["cells"].values()
                             if c["target"] == "h100")
        summary = {
            "wall_s": watch["wall_s"], "matrix": report.matrix,
            "target_rankings": {k: [r["target"] for r in v]
                                for k, v in report.target_rankings.items()},
            "counted_by_target": {t: len(c) for t, c in counted.items()},
            "edge_npu_counted_after_host_cpu":
                len(counted.get("edge_npu", set()) & counted.get("host_cpu", set())),
            "h100_generates": h100_generates,
            "store_entries_by_scope": {k: len(v) for k, v in sorted(scopes.items())},
            "launches": watch["launches"], "cache": report.cache}
        print("sweep_small_summary " + json.dumps(summary))
        if (report.n_cells != 6 or summary["edge_npu_counted_after_host_cpu"]
                or not counted.get("host_cpu") or h100_generates == 0
                or not scopes.get("peak_bytes@cpu") or not scopes.get("peak_bytes@cuda")
                or any(c["states"] != {"complete": 6} for c in report.cells)):
            raise AssertionError(f"sweep_small: {summary}")
        again, watch = _watched_sweep(torch, ops, ref, spec)
        _resumed_quietly("sweep_small", report, again, watch)

        # -- (b) the kernels through a sweep: NAS_SPACE on h100 ---------------
        base = explore_spec("serial", 1, f"{tmp}/kernels_cache")
        spec = SweepSpec.from_dict({
            "name": "sweep-kernels", "base": base,
            "axes": {"samplers": SWEEP_SMALL["axes"]["samplers"]},
            "report_dir": f"{tmp}/kernels"})
        report, watch = _watched_sweep(torch, ops, ref, spec)
        rows = _cell_rows(report, watch)
        kernel_cells = _kernel_cells(rows)
        for row in rows:
            print("sweep_kernels " + json.dumps(row))
        random_cell, grid_cell = rows
        if nas is not None:
            want = [row["signature"] for row in nas["trials"]]
        else:  # the nas phase did not run: its sampler's draws
            space = parse_search_space(NAS_SPACE)
            study = Study(sampler=RandomSampler(seed=0))
            want = [sample_architecture(space, study.ask()).signature()
                    for _ in range(NAS_TRIALS)]
        got = [t["signature"] for t in random_cell["trials"]]
        retuned = [b for b in grid_cell["swept"] if b in random_cell["swept"]]
        summary = {"wall_s": watch["wall_s"], "launches": watch["launches"],
                   "plain_calls": watch["plain_calls"],
                   "random_signatures_are_the_nas_phases": got == want,
                   "swept": {"random": len(random_cell["swept"]),
                             "grid": len(grid_cell["swept"])},
                   "grid_retuned": retuned, "best": {r["cell"]: r["best"] for r in rows}}
        print("sweep_kernels_summary " + json.dumps(summary))
        kernels = ("flash_attention", "ssm_scan")
        if (any(watch["launches"].get(k, 0) == 0 for k in kernels) or watch["plain_calls"]
                or got != want or retuned
                or any(c["states"] != {"complete": NAS_TRIALS} for c in report.cells)):
            raise AssertionError(f"sweep_kernels: {summary}; signatures {got} against "
                                 f"the nas phase's {want}")
        again, quiet = _watched_sweep(torch, ops, ref, spec)
        _resumed_quietly("sweep_kernels", report, again, quiet)

        # each kernel in the fastest candidate that reaches it, on the
        # schedules the sweep tuned for it, against its plain versions
        for op, kernel in (("attention", "flash_attention"), ("ssm", "ssm_scan")):
            trial, cell = min(
                ((t, c) for c in watch["cells"].values()
                 for t in c["explorer"].study.trials
                 if f"{op}(" in (t.user_attrs.get("signature") or "")),
                key=lambda tc: tc[0].user_attrs["latency_s"])
            model = cell["explorer"]._objective.build_model(trial)
            model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
            plan = {k: ksched.as_schedule(k, v)
                    for k, v in trial.user_attrs["kernel_schedules"].items()}
            with ksched.use_schedules(plan):
                _candidate_against_plain(torch, ops, ref, f"sweep_{kernel}", model,
                                         NAS_SPACE["output"])
        launches = {row["cell"].rsplit("=", 1)[-1]: row["launches"] for row in rows}

        # -- (c) hw_parallel.yaml on the card: serial, then 2 spawned workers --
        runs = {}
        for backend, workers in (("serial", 1), ("process", 2)):
            raw = dict(HW_PARALLEL, executor={"backend": backend, "n_workers": workers},
                       cache={"dir": f"{tmp}/hw_{backend}"}, report_dir=f"{tmp}/hw")
            t0 = time.perf_counter()
            explorer = Explorer.from_dict(raw)
            hw = explorer.run(save_report=False)
            torch.cuda.synchronize()
            runs[backend] = {
                "backend": backend, "n_workers": workers,
                "wall_s": time.perf_counter() - t0, "states": hw.states, "best": hw.best,
                "criteria_values": hw.criteria_values, "cache": hw.cache,
                "peak_bytes": {t.number: t.user_attrs.get("peak_bytes")
                               for t in explorer.study.trials}}
            print("sweep_hw_parallel " + json.dumps(runs[backend]))
        serial, process = runs["serial"], runs["process"]
        n = HW_PARALLEL["budget"]["n_trials"]
        if (serial["states"] != {"complete": n} or process["states"] != {"complete": n}
                or serial["best"]["number"] != process["best"]["number"]):
            raise AssertionError(f"sweep hw_parallel on h100: states {serial['states']} | "
                                 f"{process['states']}, best {serial['best']} | "
                                 f"{process['best']}")
        # a spawned worker's fp32 flags, from the process backend's pool and
        # from a pool with torch's defaults (what a worker had before the
        # backend passed the parent's flags on)
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        from repro_torch.evaluation.artifact_store import ArtifactStore
        from repro_torch.search.executors import ProcessExecutor, numerics_flags

        with ProcessExecutor()._make_pool(1) as passed, ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as defaults:
            flags = {"parent": numerics_flags(),
                     "worker": passed.submit(numerics_flags).result(),
                     "worker_with_torch_defaults": defaults.submit(numerics_flags).result()}
        peaks = {t: (serial["peak_bytes"][t], process["peak_bytes"][t])
                 for t in serial["peak_bytes"]}
        apart = {t: p for t, p in peaks.items()
                 if p[0] is None or p[1] is None or abs(p[1] - p[0]) > NAS_PEAK_REL * p[0]}
        # each generate's memory record as the store keeps it (the peak, and
        # what the card held before and after), by signature and run
        records = {}
        for backend in runs:
            store = ArtifactStore(f"{tmp}/hw_{backend}")
            for key in store.keys():
                rec = store.record(json.loads(key)["key"])
                records.setdefault(json.loads(key)["key"][3], {})[backend] = {
                    **rec["meta"]["memory"], "measured_by": rec["meta"]["measured_by"]}
        signatures = {t.number: t.user_attrs.get("signature") for t in explorer.study.trials}
        print("sweep_hw_parallel_peaks " + json.dumps({
            "flags": flags, "peak_bytes_serial_process": peaks, "apart": apart,
            "apart_records": {t: records.get(signatures[t]) for t in apart}}))
        if flags["worker"] != flags["parent"] or apart:
            raise AssertionError(f"sweep hw_parallel on h100: the workers' flags {flags} "
                                 f"are not the parent's, or the peaks of trials {apart} "
                                 f"differ from the serial run's by more than {NAS_PEAK_REL}")
    return {"launches": launches, "kernel_cells": kernel_cells}


def serving_phase(torch, ops) -> dict:
    """``SERVING_EXPERIMENT`` (``serving.yaml`` at target ``h100``) through
    ``Explorer`` over its conv_pool space at its 8 trials and over
    ``NAS_SPACE`` at ``SERVING_NAS_TRIALS``.  For every trial, beside the
    criteria (``p99_latency_s``, ``throughput_tok_s``,
    ``kv_cache_peak_bytes``): ``prefill_latency_s`` against the roofline
    bound of the forward counted at ``max_batch`` (the printed terms), and
    ``decode_latency_s`` against the reference's formula on the printed
    ``n_params``, ``flops`` and state elements.  Raises on a mismatch, on a
    trial that did not complete, on a ``NAS_SPACE`` candidate with no decode
    state, or if the phase launched a kernel, allocated on the card or
    generated a candidate.  Returns the rows."""
    import tempfile

    from repro_torch.evaluation.serving import DecodeLatencyEstimator, PrefillLatencyEstimator
    from repro_torch.explorer.explorer import Explorer
    from repro_torch.hwgen.generator import generate_call_count, program_cost
    from repro_torch.hwgen.roofline import roofline_terms
    from repro_torch.hwgen.targets import get_target

    chip = get_target("h100").chip
    torch.cuda.synchronize()
    launches, held, generated = dict(ops.LAUNCHES), torch.cuda.memory_allocated(), \
        generate_call_count()
    out = {}
    with tempfile.TemporaryDirectory(prefix="serving-") as tmp:
        for label, space, trials in (("conv_pool", CONV_POOL_SPACE,
                                      SERVING_EXPERIMENT["budget"]["n_trials"]),
                                     ("nas", NAS_SPACE, SERVING_NAS_TRIALS)):
            raw = dict(SERVING_EXPERIMENT, name=f"serving-{label}", search_space=space,
                       budget={"n_trials": trials}, cache={"dir": f"{tmp}/{label}"},
                       report_dir=tmp)
            t0 = time.perf_counter()
            explorer = Explorer.from_dict(raw)
            report = explorer.run(save_report=False)
            wall_s = time.perf_counter() - t0
            serving, objective = explorer.spec.serving, explorer._objective
            prefill = PrefillLatencyEstimator("h100", serving=serving, cache=objective.cache)
            decode = DecodeLatencyEstimator("h100", serving=serving, cache=objective.cache)
            mean_ctx = (sum(n * w for n, w in serving.traffic.prompt_lens.items())
                        + 0.5 * sum(n * w for n, w in serving.traffic.gen_lens.items()))
            rows = []
            for trial in explorer.study.trials:
                model = objective.build_model(trial)
                c, l = model.input_shape
                cost = program_cost(model, (torch.empty(serving.max_batch, l, c,
                                                        device="meta"),))
                bound = roofline_terms(hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
                                       collective_bytes=cost.collective_bytes, n_chips=1,
                                       chip=chip)
                state = serving.max_batch * serving.dtype_bytes * (
                    model.state_elems_fixed + model.state_elems_per_token * mean_ctx)
                want_decode = max(serving.max_batch * (model.flops / l) / chip.peak_flops_bf16,
                                  (model.n_params * 4 + state) / chip.hbm_bandwidth)
                row = {
                    "trial": trial.number, "state": trial.state.value,
                    "signature": trial.user_attrs.get("signature"),
                    **{k: trial.user_attrs.get(k) for k in
                       ("p99_latency_s", "throughput_tok_s", "kv_cache_peak_bytes")},
                    "prefill_latency_s": prefill.estimate(model),
                    "flops": cost.flops, "bytes": cost.bytes_accessed,
                    "compute_s": bound.compute_s, "memory_s": bound.memory_s,
                    "bound_s": bound.bound_s,
                    "decode_latency_s": decode.estimate(model),
                    "decode_formula_s": want_decode, "n_params": model.n_params,
                    "model_flops": model.flops,
                    "state_elems_fixed": model.state_elems_fixed,
                    "state_elems_per_token": model.state_elems_per_token}
                rows.append(row)
                print(f"serving_{label} " + json.dumps(row))
            out[label] = {"wall_s": wall_s, "states": report.states, "best": report.best,
                          "criteria_values": report.criteria_values, "rows": rows}
            print(f"serving_{label}_summary " + json.dumps(
                {k: v for k, v in out[label].items() if k != "rows"}))
            for row in rows:
                if (row["state"] != "complete" or row["prefill_latency_s"] != row["bound_s"]
                        or abs(row["decode_latency_s"] - row["decode_formula_s"])
                        > 1e-12 * row["decode_formula_s"]
                        or (label == "nas" and not row["kv_cache_peak_bytes"])):
                    raise AssertionError(f"serving {label}: trial {row['trial']}: {row}")
    torch.cuda.synchronize()
    moved = {"launches": dict(ops.LAUNCHES) != launches,
             "memory_allocated": torch.cuda.memory_allocated() != held,
             "generates": generate_call_count() != generated}
    print("serving_summary " + json.dumps({"touched_the_card": moved}))
    if any(moved.values()):
        raise AssertionError(f"serving: the modelled estimators touched the card: {moved}")
    return out


# the report_boot phase: explore_spec over zamba2-2.7b's hybrid of NAS_SPACE's
# layers (one or two Mamba2 blocks, then its attention block; the head's
# width searched), so every candidate, and the winner the boot serves,
# reaches both kernels (NAS_SPACE's own winner is a lone ssm layer), with
# serving.yaml's serving section
REPORT_BOOT_SPACE = {
    "input": NAS_SPACE["input"],
    "output": NAS_SPACE["output"],
    "sequence": [
        {"block": "mamba2", "op_candidates": "ssm",
         "type_repeat": {"type": "repeat_op", "depth": [1, 2]},
         "ssm": NAS_SPACE["sequence"][0]["ssm"]},
        {"block": "attention", "op_candidates": "attention",
         "attention": NAS_SPACE["sequence"][0]["attention"]},
        *NAS_SPACE["sequence"][1:],
    ],
}
REPORT_BOOT_CHILD = """
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
torch.empty(1, device="cuda")
print("CUDA_INIT_S " + json.dumps(time.perf_counter() - t0))
from repro_torch.launch import serve
rc = serve.main(sys.argv[1:])
sys.stdout.flush()
sys.exit(rc)
"""


def _boot_child(torch, report_path, env_extra, expect) -> dict:
    """``serve.main(["--from-report", report_path, "--expect-compiles",
    expect])`` in a fresh Python process (so the store, not this process's
    memory, carries the program); its summary line, exit code and wall
    seconds."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(SRC), **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", REPORT_BOOT_CHILD, "--from-report", report_path,
         "--expect-compiles", str(expect)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    wall_s = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    init = [line for line in proc.stdout.splitlines() if line.startswith("CUDA_INIT_S ")]
    if not lines or not init:
        raise AssertionError(f"report_boot: the boot printed no summary (exit "
                             f"{proc.returncode}): {proc.stderr[-3000:]}")
    return {"rc": proc.returncode, "wall_s": wall_s,
            "cuda_init_s": json.loads(init[-1].split(" ", 1)[1]), **json.loads(lines[-1])}


def report_boot_phase(torch, ops, ref) -> dict:
    """The paper's deploy-best mode on the card: an exploration measures
    its candidates and leaves each one's program in the artifact store,
    and a server boots the winner from it without generating.

    ``explore_spec("serial", 1, ...)`` over ``REPORT_BOOT_SPACE`` at
    target ``h100`` with ``serving.yaml``'s serving section, ``NAS_TRIALS``
    trials, three times on fresh cache dirs: with ``REPRO_ARTIFACTS=0``
    (the first run, which also pays the phase's warm-up), with the store,
    and without it again (what the store costs a search: the second
    run's wall time less the third's).  Prints the store's puts and entries, and each program's
    export seconds and blob bytes.  Then, in a fresh child process,
    ``serve.main(["--from-report", R, "--expect-compiles", "0"])``: it
    must exit 0 with ``compiles`` 0, serve every request of the traffic
    and launch ``flash_attention`` and ``ssm_scan``; the same boot with
    ``REPRO_ARTIFACTS=0`` must generate once (``compiles`` 1).  Last, the
    loaded program on one seeded batch against the eager candidate on the
    same seed-0 weights and schedules (printed, expected equal bit for
    bit) and against the candidate on its plain versions, within
    ``NAS_REL_TOL`` of the output's max.  Raises on any miss; returns the
    warm boot's summary."""
    import tempfile

    from repro_torch.evaluation.artifact_store import ArtifactStore
    from repro_torch.evaluation.serving import _ServingEstimator
    from repro_torch.explorer.explorer import Explorer
    from repro_torch.hwgen.generator import generate_call_count
    from repro_torch.kernels import schedule as ksched
    from repro_torch.launch.serve import rebuild_best

    kernels = ("ssm_scan", "flash_attention")
    with tempfile.TemporaryDirectory(prefix="report-boot-") as tmp:
        walls = {}
        for label, flag in (("warm_up_without_store", "0"), ("with_store", "1"),
                            ("without_store", "0")):
            raw = dict(explore_spec("serial", 1, f"{tmp}/cache_{label}"),
                       name=f"report-boot-{label}", search_space=REPORT_BOOT_SPACE,
                       serving=SERVING_EXPERIMENT["serving"], report_dir=f"{tmp}/{label}")
            with mock.patch.dict(os.environ, {"REPRO_ARTIFACTS": flag}):
                ops.LAUNCHES.clear()
                t0 = time.perf_counter()
                explorer = Explorer.from_dict(raw)
                report = explorer.run(save_report=True)
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t0
            if report.states.get("complete") != NAS_TRIALS or not all(
                    report.kernel_launches.get(k) for k in kernels):
                raise AssertionError(f"report_boot {label}: states {report.states}, "
                                     f"launches {report.kernel_launches}")
            if label == "with_store":
                stored = report
        report = stored
        store = ArtifactStore(f"{tmp}/cache_with_store")
        records = [store.record(json.loads(k)["key"]) for k in store.keys()]
        programs = [{"blob": r["blob"][:12], "export_s": r["meta"]["export_s"],
                     "blob_bytes": r["meta"]["blob_bytes"],
                     "measured_by": r["meta"]["measured_by"]} for r in records]
        explore_row = {
            "wall_s": walls, "store_cost_s": walls["with_store"] - walls["without_store"],
            "best": report.best, "artifacts": report.artifacts, "puts": len(records),
            "entries": len(store), "programs": programs,
            "export_s_total": sum(p["export_s"] for p in programs),
            "launches": report.kernel_launches}
        print("report_boot_explore " + json.dumps(explore_row))
        if not records or report.artifacts["entries"] != len(records):
            raise AssertionError(f"report_boot: the store holds {len(records)} programs, "
                                 f"the report says {report.artifacts}")

        # -- the boot, in a fresh process: warm from the store, then cold --
        warm = _boot_child(torch, report.artifact, {}, 0)
        cold = _boot_child(torch, report.artifact, {"REPRO_ARTIFACTS": "0"}, 1)
        n_requests = SERVING_EXPERIMENT["serving"]["traffic"]["n_requests"]
        for label, row in (("warm", warm), ("cold", cold)):
            print(f"report_boot_{label} " + json.dumps(row))
        print("report_boot_summary " + json.dumps({
            "boot_s": {"warm": warm["boot_s"], "cold": cold["boot_s"]},
            "boot_parts": {"warm": warm["boot_parts"], "cold": cold["boot_parts"]},
            "cuda_init_s": {"warm": warm["cuda_init_s"], "cold": cold["cuda_init_s"]},
            "compiles": {"warm": warm["compiles"], "cold": cold["compiles"]},
            "exec_s": {"warm": warm["exec_s"], "cold": cold["exec_s"]},
            "child_wall_s": {"warm": warm["wall_s"], "cold": cold["wall_s"]},
            "launches": {"warm": warm["launches"], "cold": cold["launches"]}}))
        if (warm["rc"] != 0 or warm["compiles"] != 0 or warm["served"] != n_requests
                or warm["shed"] != 0 or not all(warm["launches"].get(k) for k in kernels)
                or warm["signature"] != report.best["signature"]):
            raise AssertionError(f"report_boot: the warm boot {warm}")
        if cold["rc"] != 0 or cold["compiles"] != 1 or cold["served"] != n_requests:
            raise AssertionError(f"report_boot: the cold boot {cold}")

        # -- the loaded program against the eager candidate -----------------
        with open(report.artifact) as f:
            candidate, spec = rebuild_best(json.load(f))
        est = _ServingEstimator(target=spec.target, serving=spec.serving,
                                cache=spec.cache.dir)
        schedules = (report.kernel_tuning or {}).get("schedules")
        plan = est._schedule_plan(candidate, {"schedules": schedules} if schedules else None)
        generated = generate_call_count()
        artifact = est._artifact(candidate, plan)
        if artifact.program is None or generate_call_count() != generated:
            raise AssertionError("report_boot: the store did not give the program back")
        model = artifact.fn.to("cuda")
        c, l = candidate.input_shape
        x = torch.randn(spec.serving.max_batch, l, c, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))

        def plain_ssm(x_, dt, a, b, c_, *, chunk):
            return ref.ssm_scan_ref(x_, dt, a, b, c_, chunk=chunk)

        with torch.inference_mode(), ksched.use_schedules(artifact.schedules):
            loaded_out = artifact(x)
            eager_out = model(x)
            with mock.patch.object(ops, "ssm_scan", plain_ssm), \
                    mock.patch.object(ops, "flash_attention", _flash_plain):
                plain_out = model(x)
            torch.cuda.synchronize()
        model.to("cpu")
        tol = NAS_REL_TOL * plain_out.abs().max().item()
        check = {"signature": candidate.arch.signature(), "shape": list(loaded_out.shape),
                 "equal_to_eager": bool(torch.equal(loaded_out, eager_out)),
                 "max_abs_diff_eager": (loaded_out - eager_out).abs().max().item(),
                 "max_abs_err_plain": (loaded_out - plain_out).abs().max().item(),
                 "tol": tol, "finite": bool(torch.isfinite(loaded_out).all())}
        print("report_boot_check " + json.dumps(check))
        if not check["finite"] or check["max_abs_err_plain"] > tol \
                or check["max_abs_diff_eager"] > tol:
            raise AssertionError(f"report_boot: the loaded program {check}")
    return {"explore": explore_row, "warm": warm, "cold": cold, "check": check}


REMOTE_DAEMONS = 2
REMOTE_LATENCY_REL = 0.05  # the cascade's limit: a trial's latency_s, daemon vs serial
REMOTE_START_S = 300.0  # a daemon's start: interpreter, torch, CUDA, the libraries
REMOTE_EXIT_S = 60.0  # a daemon's exit after SIGTERM
# the remote layer's degradations: each turns the run into a local one, or
# loses a daemon, so none may pass unseen
REMOTE_WARNINGS = ("remote worker", "degrading", "sweep worker", "sweep cell",
                   "quarantin", "failed after")


def _start_daemon(cache_dir) -> dict:
    """``python -m repro_torch.worker --port 0 --cache-dir <cache_dir>`` as
    a child process; its output is drained by a thread into ``lines``."""
    import subprocess
    import threading

    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.worker", "--port", "0",
         "--cache-dir", str(cache_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    daemon = {"proc": proc, "pid": proc.pid, "t0": t0, "lines": []}
    threading.Thread(target=lambda: daemon["lines"].extend(
        iter(proc.stdout.readline, "")), daemon=True).start()
    return daemon


def _await_daemon(daemon) -> None:
    """Wait for the daemon's ``listening on`` line; parse it and its
    ``warmed up:`` line's parts into the daemon's record."""
    deadline = daemon["t0"] + REMOTE_START_S
    while time.perf_counter() < deadline:
        listening = [line for line in list(daemon["lines"]) if line.startswith("listening on ")]
        if listening:
            daemon["addr"] = listening[0].split()[-1]
            daemon["start_to_listening_s"] = time.perf_counter() - daemon["t0"]
            warm = next(line for line in daemon["lines"] if line.startswith("warmed up: "))
            daemon["parts"] = {k: None if v == "-" else float(v) for k, v in (
                field.split("=") for field in warm.split() if "=" in field)}
            return
        if daemon["proc"].poll() is not None:
            break
        time.sleep(0.05)
    raise AssertionError(f"remote: daemon {daemon['pid']} did not listen within "
                         f"{REMOTE_START_S} s (exit {daemon['proc'].poll()}): "
                         f"{''.join(daemon['lines'])[-4000:]}")


def _stop_daemon(daemon, sig=None) -> dict:
    """SIGTERM (or ``sig``) the daemon and wait for it; SIGKILL it after
    ``REMOTE_EXIT_S``.  Returns how it ended."""
    import signal

    proc = daemon["proc"]
    if proc.poll() is None:
        t0 = time.perf_counter()
        proc.send_signal(sig or signal.SIGTERM)
        try:
            proc.wait(timeout=REMOTE_EXIT_S)
            return {"exit_code": proc.returncode, "exit_s": time.perf_counter() - t0}
        except Exception:
            proc.kill()
            proc.wait(timeout=REMOTE_EXIT_S)
            return {"exit_code": proc.returncode, "killed_after_s": REMOTE_EXIT_S}
    return {"exit_code": proc.returncode}


def _gate_free(path) -> bool:
    import fcntl

    with open(path, "a+b") as f:
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return False
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        return True


def _remote_trials(explorer) -> list:
    return [{"number": t.number, "state": t.state.value, "params": dict(t.params),
             "signature": t.user_attrs.get("signature"),
             "latency_s": t.user_attrs.get("latency_s"),
             "peak_bytes": t.user_attrs.get("peak_bytes"),
             "kernel_schedules": t.user_attrs.get("kernel_schedules"),
             "pid": (t.user_attrs.get("worker") or {}).get("pid"),
             "launches": (t.user_attrs.get("worker") or {}).get("launches") or {}}
            for t in explorer.study.trials]


def _launch_delta(trials, seen) -> dict:
    """Kernel launches over a run, from the trials' cumulative per-process
    counts, less what each process had launched before the run (``seen``,
    updated)."""
    total = {}
    for pid in {t["pid"] for t in trials}:
        now = {}
        for t in trials:
            if t["pid"] == pid:
                for k, n in t["launches"].items():
                    now[k] = max(now.get(k, 0), n)
        before = seen.get(pid, {})
        for k, n in now.items():
            total[k] = total.get(k, 0) + n - before.get(k, 0)
        seen[pid] = {**before, **now}
    return total


def _remote_warnings(caught) -> list:
    return [str(w.message) for w in caught
            if any(p in str(w.message) for p in REMOTE_WARNINGS)]


def _explore_run(torch, spec) -> tuple:
    """``Explorer.from_dict(spec).run()``, with the remote layer's warnings
    recorded; returns the explorer, its report, the wall and the warnings."""
    import warnings

    from repro_torch.explorer.explorer import Explorer

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        explorer = Explorer.from_dict(spec)
        report = explorer.run(save_report=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return explorer, report, wall_s, _remote_warnings(caught)


def _against_serial(label, trials, serial, pids, failures) -> dict:
    """A run's trials against the serial run's: all complete, each in a
    daemon (``pids``), each latency within ``REMOTE_LATENCY_REL`` and peak
    within ``NAS_PEAK_REL``; the same signatures.  What fails is added to
    ``failures``."""
    by_number = {t["number"]: t for t in serial}
    latency = {t["number"]: t["latency_s"] / by_number[t["number"]]["latency_s"]
               for t in trials}
    peak = {t["number"]: t["peak_bytes"] / by_number[t["number"]]["peak_bytes"]
            for t in trials}
    summary = {
        "states": sorted({t["state"] for t in trials}),
        "not_in_a_daemon": [t["number"] for t in trials if t["pid"] not in pids],
        "signatures_equal": [t["signature"] for t in trials] == [t["signature"] for t in serial],
        "latency_over_serial": [min(latency.values()), max(latency.values())],
        "peak_over_serial": [min(peak.values()), max(peak.values())],
        "latency_apart": {n: r for n, r in latency.items() if abs(r - 1) > REMOTE_LATENCY_REL},
        "peak_apart": {n: r for n, r in peak.items() if abs(r - 1) > NAS_PEAK_REL},
    }
    if (summary["states"] != ["complete"] or summary["not_in_a_daemon"]
            or not summary["signatures_equal"] or summary["latency_apart"]
            or summary["peak_apart"] or len(trials) != NAS_TRIALS):
        failures.append(f"remote {label}: {summary}")
    return summary


def _hostless_run(tmp, addrs, label) -> tuple:
    """``explore_spec`` through the daemons at ``addrs`` from a parent
    without a card: ``CUDA_VISIBLE_DEVICES= python -m repro_torch.explorer
    <spec>.json --device cpu --remote-workers <addrs>`` with no disk cache
    (the daemons' store would answer every value) and the study stored as
    JSONL, from which the trials are read back.  Returns the trials (as ``_remote_trials`` gives
    them), the report, the wall and the child's output."""
    import subprocess

    spec = explore_spec("remote", REMOTE_DAEMONS, f"{tmp}/{label}")
    spec.pop("cache")
    spec["persistence"] = f"{tmp}/{label}.jsonl"
    path = Path(tmp) / f"{label}.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.explorer", str(path),
                           "--device", "cpu", "--remote-workers", ",".join(addrs),
                           "--report-dir", f"{tmp}/{label}"],
                          capture_output=True, text=True, env=env, cwd=str(ROOT),
                          timeout=REMOTE_START_S + 300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"remote_hostless: the parent without a card exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    report = json.loads((Path(tmp) / label / f"{spec['name']}.report.json").read_text())
    stored = {}
    for line in Path(spec["persistence"]).read_text().splitlines():
        record = json.loads(line)
        if record.get("kind") == "trial":
            stored[record["trial"]["number"]] = record["trial"]
    trials = [{"number": t["number"], "state": t["state"], "params": t["params"],
               "signature": t["user_attrs"].get("signature"),
               "latency_s": t["user_attrs"].get("latency_s"),
               "peak_bytes": t["user_attrs"].get("peak_bytes"),
               "kernel_schedules": t["user_attrs"].get("kernel_schedules"),
               "pid": (t["user_attrs"].get("worker") or {}).get("pid"),
               "launches": (t["user_attrs"].get("worker") or {}).get("launches") or {}}
              for t in (stored[n] for n in sorted(stored))]
    return trials, report, wall, proc.stdout + proc.stderr


def _hostless_against(trials, report, parent, parent_best, pids, launched) -> dict:
    """The card-less parent's run against the on-card parent's: the same
    trial params, states and best trial; each latency within
    ``REMOTE_LATENCY_REL`` and peak within ``NAS_PEAK_REL``; every trial in
    a daemon; flash and ``ssm_scan`` launched there; the report naming the
    daemons' device; no degradation in its output."""
    by_number = {t["number"]: t for t in parent}
    latency = {t["number"]: t["latency_s"] / by_number[t["number"]]["latency_s"]
               for t in trials}
    peak = {t["number"]: t["peak_bytes"] / by_number[t["number"]]["peak_bytes"]
            for t in trials}
    row = {
        "same_trials": [(t["number"], t["state"], t["params"]) for t in trials]
        == [(t["number"], t["state"], t["params"]) for t in parent],
        "best": report["best"]["number"], "parent_best": parent_best,
        "device": report["device"], "backend": report["backend"],
        "not_in_a_daemon": [t["number"] for t in trials if t["pid"] not in pids],
        "latency_over_parent": [min(latency.values()), max(latency.values())],
        "peak_over_parent": [min(peak.values()), max(peak.values())],
        "latency_apart": {n: r for n, r in latency.items() if abs(r - 1) > REMOTE_LATENCY_REL},
        "peak_apart": {n: r for n, r in peak.items() if abs(r - 1) > NAS_PEAK_REL},
        "launches_in_daemons": launched}
    row["ok"] = (row["same_trials"] and row["best"] == parent_best
                 and row["device"] == "cuda" and row["backend"] == "remote"
                 and not row["not_in_a_daemon"] and not row["latency_apart"]
                 and not row["peak_apart"] and len(trials) == NAS_TRIALS
                 and all(launched.get(k, 0) > 0 for k in ("flash_attention", "ssm_scan")))
    return row


def _kernel_sweep_spec(report_dir) -> dict:
    """The sweep phase's kernel sweep (``explore_spec`` by samplers random 0
    and grid 0) without a disk cache, so every cell measures its candidates
    wherever it runs."""
    base = explore_spec("serial", 1, report_dir)
    base.pop("cache")
    return {"name": "sweep-kernels", "base": base,
            "axes": {"samplers": SWEEP_SMALL["axes"]["samplers"]},
            "report_dir": str(report_dir)}


def _sweep_bests(report) -> dict:
    return {c["name"]: [(c["best"] or {}).get("number"), (c["best"] or {}).get("signature")]
            for c in report.cells}


def _kernel_cells(rows) -> dict:
    """By cell of a watched sweep: its best trial [number, signature] and
    each trial's [signature, latency_s]."""
    return {row["cell"]: {"best": [row["best"]["number"], row["best"]["signature"]],
                          "trials": {t["number"]: [t["signature"], t["latency_s"]]
                                     for t in row["trials"]}}
            for row in rows}


def _local_kernel_sweep(torch, report_dir) -> dict:
    """The kernel sweep without a disk cache, run here; ``_kernel_cells``
    of it."""
    from repro_torch.explorer import sweep as sweep_mod
    from repro_torch.explorer.explorer import Explorer

    trials, run = {}, Explorer.run

    def watched_run(self, *args, **kwargs):
        try:
            return run(self, *args, **kwargs)
        finally:
            trials[self.spec.name] = [{
                "number": t.number, "signature": t.user_attrs.get("signature"),
                "latency_s": t.user_attrs.get("latency_s")} for t in self.study.trials]

    with mock.patch.object(Explorer, "run", watched_run):
        report = sweep_mod.run_sweep(sweep_mod.SweepSpec.from_dict(
            _kernel_sweep_spec(report_dir)))
    torch.cuda.synchronize()
    return _kernel_cells([{"cell": c["name"], "best": c["best"], "trials": trials[c["name"]]}
                          for c in report.cells])


def _same_best(bests, local) -> dict:
    """Each cell's best trial against the local sweep's: the same trial,
    or a near tie (the local run measured the two within
    ``REMOTE_LATENCY_REL`` of each other); the signature the local sweep
    gave that trial number."""
    out = {}
    for name, (number, signature) in bests.items():
        cell = local[name]
        mine, theirs = cell["trials"][number], cell["trials"][cell["best"][0]]
        out[name] = {"best": number, "local_best": cell["best"][0],
                     "signature_is_the_local_trials": signature == mine[0],
                     "local_latency_over_local_best": mine[1] / theirs[1]}
        out[name]["ok"] = (out[name]["signature_is_the_local_trials"]
                           and mine[1] <= theirs[1] * (1 + REMOTE_LATENCY_REL))
    return out


def remote_phase(torch, ops, local_sweep=None) -> dict:
    """The remote worker pool on the card.  ``warmup()`` once in a process
    of the ``spawn`` context (its split is printed as
    ``remote_warmup_spawn``); then ``REMOTE_DAEMONS`` daemons
    (``python -m repro_torch.worker --port 0 --cache-dir <tmp>``) started
    together, their ``warmed up:`` parts printed as ``remote_warmup``.

    (a) ``explore_spec`` through ``executor: remote`` at the daemons, then
    serially on another fresh cache: every trial in a daemon, flash and
    ``ssm_scan`` launched there (differences of the daemons' cumulative
    counts), the serial run's best trial, each ``latency_s`` within
    ``REMOTE_LATENCY_REL`` and each ``peak_bytes`` within ``NAS_PEAK_REL``
    of the serial run's.  (a2) The same spec from a parent without a card
    (``_hostless_run``: a child with the cards hidden, ``--device cpu``, no
    disk cache), held to (a) by ``_hostless_against``; if a latency misses,
    both parents run again in turns, each measuring anew, and the check
    reads the second pair (a daemon is sometimes slow: ROADMAP Queue 3 item
    2).  (b) The same spec again without a disk cache
    (the daemons' store would answer every value): SIGTERM to one daemon
    once it has finished a trial and holds the measurement gate for its
    next; the ``shutdown`` frame must make the client resubmit at once
    (the loss is "announced shutdown", not a heartbeat timeout), every
    trial completes with the serial best trial, the daemon exits, and the
    gate is free after it.  (c) ``run_sweep`` of the kernel sweep with
    ``workers=[the survivor]``: both cells computed over the wire and
    persisted by this process, each cell's best trial the local sweep's
    or, where the local sweep measured the two within
    ``REMOTE_LATENCY_REL``, a near tie of it, with the signature the local
    sweep gave that trial (``local_sweep``: the sweep phase's
    ``kernel_cells``, else run here), and a resumed second run does
    nothing.  Any of the remote layer's
    degradation warnings fails the phase."""
    import multiprocessing
    import tempfile
    import threading
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.explorer import sweep as sweep_mod
    from repro_torch.explorer.explorer import Explorer
    from repro_torch.hwgen.generator import measurement_gate_path
    from repro_torch.search.remote.executor import RemoteExecutor
    from repro_torch.search.remote.worker import warmup

    t_phase = t0 = time.perf_counter()
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        spawned = pool.submit(warmup, "cuda").result()
    spawned["submit_to_result_s"] = time.perf_counter() - t0
    print("remote_warmup_spawn " + json.dumps(spawned))

    gate = measurement_gate_path(torch.device("cuda", 0))
    daemons, failures = [], []  # the phase runs to its end, then raises
    with tempfile.TemporaryDirectory(prefix="remote-") as tmp:
        try:
            free_before = torch.cuda.mem_get_info()[0]
            daemons = [_start_daemon(f"{tmp}/daemon_store") for _ in range(REMOTE_DAEMONS)]
            for daemon in daemons:
                _await_daemon(daemon)
            addrs = [d["addr"] for d in daemons]
            pids = {d["pid"] for d in daemons}
            print("remote_warmup " + json.dumps({
                "daemons": [{k: d[k] for k in ("pid", "addr", "start_to_listening_s", "parts")}
                            for d in daemons],
                "card_free_bytes_before": free_before,
                "card_free_bytes_with_daemons": torch.cuda.mem_get_info()[0]}))

            # -- (a) the explore spec on the daemons, then serially ----------
            seen = {}
            spec = explore_spec("remote", REMOTE_DAEMONS, f"{tmp}/cache_remote")
            spec["executor"]["workers"] = addrs
            explorer, report, wall_remote, warned = _explore_run(torch, spec)
            remote = _remote_trials(explorer)
            launched = _launch_delta(remote, seen)
            serial_explorer, serial_report, wall_serial, _ = _explore_run(
                torch, explore_spec("serial", 1, f"{tmp}/cache_serial"))
            serial = _remote_trials(serial_explorer)
            explore = {
                "wall_s": {"remote": wall_remote, "serial": wall_serial},
                "best": {"remote": report.best, "serial": serial_report.best},
                "launches_in_daemons": launched, "warnings": warned,
                "trials": remote, "serial_trials": serial,
                **_against_serial("explore", remote, serial, pids, failures)}
            print("remote_explore " + json.dumps(explore))
            if (warned or any(launched.get(k, 0) <= 0 for k in ("flash_attention", "ssm_scan"))
                    or report.best["number"] != serial_report.best["number"]):
                failures.append(f"remote explore: warnings {warned}, launches in the "
                                f"daemons {launched}, best {report.best['number']} "
                                f"against the serial {serial_report.best['number']}")

            # -- (a2) the same spec from a parent without a card --------------
            trials, hreport, wall_hostless, output = _hostless_run(tmp, addrs, "hostless")
            hostless = {"wall_s": wall_hostless, "trials": trials,
                        "warnings": [line for line in output.splitlines()
                                     if any(p in line for p in REMOTE_WARNINGS)],
                        **_hostless_against(trials, hreport, remote, report.best["number"],
                                            pids, _launch_delta(trials, seen))}
            print("remote_hostless " + json.dumps(hostless))
            if hostless["latency_apart"] and not hostless["warnings"]:
                # a daemon's measurement is sometimes slow (ROADMAP Queue 3
                # item 2): both parents again in turns, each measuring anew,
                # before the check is read; the limit stays
                spec = explore_spec("remote", REMOTE_DAEMONS, f"{tmp}/cache_again")
                spec.pop("cache")
                spec["executor"]["workers"] = addrs
                again_explorer, again_report, wall_again, _ = _explore_run(torch, spec)
                parent_again = _remote_trials(again_explorer)
                _launch_delta(parent_again, seen)
                trials, hreport, wall_hostless, output = _hostless_run(tmp, addrs,
                                                                       "hostless_again")
                hostless["first"] = {k: hostless[k] for k in (
                    "latency_over_parent", "latency_apart", "ok")}
                hostless.update(wall_s=wall_hostless, trials=trials, parent_again_s=wall_again,
                                **_hostless_against(trials, hreport, parent_again,
                                                    again_report.best["number"], pids,
                                                    _launch_delta(trials, seen)))
                print("remote_hostless_again " + json.dumps(hostless))
            if not hostless["ok"] or hostless["warnings"]:
                failures.append(f"remote hostless: {json.dumps(hostless)[:3000]}")

            # -- (b) SIGTERM to a daemon mid-run ------------------------------
            victim, survivor = daemons
            kill = {"done": {}, "lost": []}
            collect, on_lost = RemoteExecutor._collect, RemoteExecutor._on_worker_lost

            def kill_when_measuring(client):
                # SIGTERM once the victim runs its next trial while the gate
                # is held: by the victim for sure when the survivor is idle;
                # failing that within 0.5 s, held by either; within 1.5 s,
                # the victim merely busy (how it was is recorded)
                armed, state = time.perf_counter(), None
                while time.perf_counter() < armed + 30.0:
                    with client._lock:
                        busy = {w.addr: w.busy.key.number if w.busy else None
                                for w in client._workers}
                    in_flight = busy.get(victim["addr"])
                    held = in_flight is not None and not _gate_free(gate)
                    waited = time.perf_counter() - armed
                    if held and busy.get(survivor["addr"]) is None:
                        state = "gate held, survivor idle: the victim measuring"
                    elif held and waited > 0.5:
                        state = "gate held, survivor busy too"
                    elif in_flight is not None and waited > 1.5:
                        state = "victim busy, gate free"
                    if state:
                        break
                    time.sleep(0.002)
                kill.update(in_flight=in_flight, killed_while=state,
                            t_kill=time.perf_counter())
                os.kill(victim["pid"], 15)

            def watched_collect(self, study, trial, value, error, worker_addr):
                out = collect(self, study, trial, value, error, worker_addr)
                kill["done"][trial.number] = (time.perf_counter(), worker_addr)
                if worker_addr == victim["addr"] and "armed" not in kill:
                    kill["armed"] = trial.number
                    threading.Thread(target=kill_when_measuring, args=(self._client,),
                                     daemon=True).start()
                return out

            def watched_lost(self, worker_addr, reason):
                kill["lost"].append([worker_addr, reason, time.perf_counter()])
                return on_lost(self, worker_addr, reason)

            spec = explore_spec("remote", REMOTE_DAEMONS, f"{tmp}/cache_kill")
            spec.pop("cache")
            spec["executor"]["workers"] = addrs
            with mock.patch.object(RemoteExecutor, "_collect", watched_collect), \
                    mock.patch.object(RemoteExecutor, "_on_worker_lost", watched_lost):
                explorer, report, wall_kill, warned = _explore_run(torch, spec)
            killed = _remote_trials(explorer)
            ended = _stop_daemon(victim)
            t_kill = kill.get("t_kill")
            lost = [[a, r, t - t_kill] for a, r, t in kill["lost"]] if t_kill else kill["lost"]
            resubmitted = kill["done"].get(kill.get("in_flight"))
            row = {
                "wall_s": wall_kill, "victim_pid": victim["pid"],
                "victims_first_trial": kill.get("armed"), "in_flight": kill.get("in_flight"),
                "killed_while": kill.get("killed_while"),
                "lost": lost, "warnings": warned,
                "in_flight_done_after_s": None if resubmitted is None or t_kill is None
                else resubmitted[0] - t_kill,
                "in_flight_done_by": None if resubmitted is None else resubmitted[1],
                "victim_ended": ended, "gate_free_after": _gate_free(gate),
                "best": report.best, "launches_in_daemons": _launch_delta(killed, seen),
                "trials": killed, **_against_serial("kill", killed, serial, pids, failures)}
            print("remote_kill " + json.dumps(row))
            unexpected = [w for w in warned
                          if not (victim["addr"] in w and "announced shutdown" in w)]
            if (t_kill is None or row["in_flight"] is None
                    or [a for a, r, _ in lost] != [victim["addr"]]
                    or lost[0][1] != "worker announced shutdown" or unexpected
                    or row["in_flight_done_by"] != survivor["addr"]
                    or "killed_after_s" in ended or not row["gate_free_after"]
                    or report.best["number"] != serial_report.best["number"]):
                failures.append(f"remote kill: {json.dumps(row)[:3000]}")

            # -- (c) the kernel sweep's cells over the wire ---------------------
            if local_sweep is None:
                local_sweep = _local_kernel_sweep(torch, f"{tmp}/sweep_local")
            persisted, local_runs, dispatched = [], [], []
            persist, run, dispatch = (sweep_mod._persist_cell_report, Explorer.run,
                                      sweep_mod._dispatch_cells)

            cell_launches = {}

            def watched_persist(cell, report_dict):
                persisted.append(cell.name)
                cell_launches[cell.name] = report_dict.get("kernel_launches") or {}
                return persist(cell, report_dict)

            def watched_run(self, *args, **kwargs):
                local_runs.append(self.spec.name)
                return run(self, *args, **kwargs)

            def watched_dispatch(addrs_, cells):
                dispatched.append([c.name for c in cells])
                return dispatch(addrs_, cells)

            import warnings

            rows = {}
            spec = sweep_mod.SweepSpec.from_dict(_kernel_sweep_spec(f"{tmp}/sweep_remote"))
            for attempt in ("first", "resumed"):
                for record in (persisted, local_runs, dispatched):
                    record.clear()
                with mock.patch.object(sweep_mod, "_persist_cell_report", watched_persist), \
                        mock.patch.object(Explorer, "run", watched_run), \
                        mock.patch.object(sweep_mod, "_dispatch_cells", watched_dispatch), \
                        warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    t0 = time.perf_counter()
                    swept = sweep_mod.run_sweep(spec, workers=[survivor["addr"]])
                    wall = time.perf_counter() - t0
                # the survivor's cumulative counts, as each cell's report
                # carries them, less what it had launched before the sweep
                cumulative = {}
                for counts in cell_launches.values():
                    for k, n in counts.items():
                        cumulative[k] = max(cumulative.get(k, 0), n)
                before = seen.get(survivor["pid"], {})
                seen[survivor["pid"]] = {**before, **cumulative}
                rows[attempt] = {
                    "wall_s": wall, "n_resumed": swept.n_resumed,
                    "dispatched": list(dispatched), "persisted": list(persisted),
                    "run_here": list(local_runs), "warnings": _remote_warnings(caught),
                    "bests": _same_best(_sweep_bests(swept), local_sweep),
                    "launches_in_daemon": {k: n - before.get(k, 0)
                                           for k, n in cumulative.items()}}
                cell_launches.clear()
                print(f"remote_sweep_{attempt} " + json.dumps(rows[attempt]))
            first, again = rows["first"], rows["resumed"]
            if (first["n_resumed"] != 0 or sorted(first["persisted"]) != sorted(local_sweep)
                    or first["run_here"] or first["warnings"]
                    or not all(c["ok"] for c in first["bests"].values())
                    or again["n_resumed"] != 2
                    or any(first["launches_in_daemon"].get(k, 0) <= 0
                           for k in ("flash_attention", "ssm_scan"))
                    or again["dispatched"] or again["persisted"] or again["run_here"]
                    or again["bests"] != first["bests"]):
                failures.append(f"remote sweep: {rows}")
            survivor_ended = _stop_daemon(survivor)
        finally:
            for daemon in daemons:
                if daemon["proc"].poll() is None:
                    daemon["proc"].kill()
                    daemon["proc"].wait(timeout=REMOTE_EXIT_S)
    summary = {"phase_s": time.perf_counter() - t_phase, "survivor_ended": survivor_ended,
               "wall_s": {"explore_remote": wall_remote, "explore_serial": wall_serial,
                          "hostless": hostless["wall_s"], "kill": wall_kill,
                          "sweep": first["wall_s"]}}
    print("remote_summary " + json.dumps(summary))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"explore": launched, "hostless": hostless["launches_in_daemons"],
            "kill": row["launches_in_daemons"], "sweep": first["launches_in_daemon"]}


def _launched_since(ops, before) -> dict:
    """Kernel launches since the ``before`` snapshot of ``ops.LAUNCHES``."""
    return {k: n - before.get(k, 0) for k, n in ops.LAUNCHES.items() if n != before.get(k, 0)}


def train_phase(torch, ops) -> dict:
    """``python -m repro_torch.launch.train --arch qwen3-1.7b`` in process,
    as published (28 layers, d_model 2048, vocab 151,936, tied embeddings):
    fp32, AdamW with the CLI's cosine schedule, ``TRAIN_ARGS``.  Raises
    unless every loss is finite, the last below the first, no kernel
    launched and the plain attention ran once a layer a step (twice with
    remat: the backward recomputes each layer).  Prints the
    step times (host clock ending in a device sync), tokens/s, the
    allocator's peak and the device time by kind over one more step, with
    its forward-and-backward and its optimizer update as ranges."""
    from repro_torch.launch import train
    from repro_torch.nn import attention as attn
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep

    args = train.build_parser().parse_args(TRAIN_ARGS)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    before, plain = dict(ops.LAUNCHES), []
    t0 = time.perf_counter()
    with mock.patch.object(attn, "grouped_attention",
                           _counted(plain, attn.grouped_attention)):
        summary, state = train.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = _launched_since(ops, before)
    spec, losses, step_s = state["model"].spec, summary["losses"], summary["step_s"]
    steady = statistics.median(step_s[1:])
    row = {
        "arch": spec.name, "n_params": sum(p.numel() for p in state["params"].values()),
        "layers": spec.n_layers, "d_model": spec.d_model, "vocab": spec.vocab,
        "tie_embeddings": spec.tie_embeddings, "dtype": "float32", "optimizer": "adamw",
        "steps": args.steps, "global_batch": args.global_batch, "seq": args.seq,
        "losses": losses, "step_ms": [s * 1e3 for s in step_s],
        "first_step_ms": step_s[0] * 1e3, "median_step_ms": steady * 1e3,
        "median_step_ms_of": "steps 2-8, host clock ending in a device sync",
        "tok_per_s": args.global_batch * args.seq / steady,
        "max_memory_allocated": peak, "held_before": held, "wall_s": wall,
        "kernel_launches": launched,
        "plain_attention_calls": len(plain), "straggler_flags": summary["straggler_flags"]}
    print("train " + json.dumps(row))
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall or is not finite: {losses}")
    if launched:
        raise AssertionError(f"train: kernels launched in training: {launched}")
    # once a layer a step, and with remat once more as the backward
    # recomputes each layer
    runs = spec.n_layers * args.steps * (2 if spec.remat else 1)
    if len(plain) != runs:
        raise AssertionError(f"train: the plain attention ran {len(plain)} times, "
                             f"expected {runs}")
    batch = train._to_device(state["data"].batch_at(args.steps), state["device"])

    def one_step():
        state["step_fn"](state["params"], state["opt_state"], batch)
        torch.cuda.synchronize()

    # the step's two parts as profiler ranges: the loss with its gradients
    # (forward and backward), and the optimizer's update (clip and AdamW)
    with mock.patch.object(tstep, "value_and_grad",
                           _ranged(TRAIN_RANGES[0], tstep.value_and_grad)), \
            mock.patch.object(topt.Optimizer, "update",
                              _ranged(TRAIN_RANGES[1], topt.Optimizer.update)):
        row["profile"] = profile_by_kind(torch, "train step qwen3-1.7b", one_step,
                                         ranges=TRAIN_RANGES, inference=False)
    del state
    torch.cuda.empty_cache()
    return row


TRAIN_MESH_CHILD = """
import json, math, statistics, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from torch.distributed.tensor import DTensor
from repro_torch.evaluation.model_flops import model_flops
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh

argv, atol = json.loads(sys.argv[1]), float(sys.argv[2])
args = train.build_parser().parse_args(argv)
row = {}

def path(name, mesh=None):
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # the plain path's parameters, for the mesh
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary, state = train.run(args, mesh=mesh)
    steps = summary["step_s"]
    tokens = args.global_batch * args.seq
    flops = model_flops(state["model"].spec, "train", args.global_batch, args.seq)
    steady = statistics.median(steps[1:])
    row[name] = {"losses": summary["losses"], "step_ms": [x * 1e3 for x in steps],
                 "median_step_ms": steady * 1e3, "tok_per_s": tokens / steady,
                 "model_tflop_per_s": flops / steady / 1e12, "wall_s": time.perf_counter() - t0,
                 "max_memory_allocated": torch.cuda.max_memory_allocated(),
                 "held_before": held}
    return summary, state

launches = dict(ops.LAUNCHES)
plain, pstate = path("plain")
want = pstate["params"]  # plain tensors; the module holds the same storage
del pstate["opt_state"]
mesh = make_host_mesh("cuda")
sharded, sstate = path("mesh", mesh)
got, opt = sstate["params"], sstate["opt_state"]
row["mesh_shape"] = list(mesh.shape)
row["mesh_dims"] = list(mesh.mesh_dim_names)
row["backend"] = torch.distributed.get_backend()
row["dtensor_params"] = sum(isinstance(v, DTensor) and v.is_cuda for v in got.values())
row["dtensor_moments"] = sum(isinstance(v, DTensor) and v.is_cuda
                             for m in ("mu", "nu") for v in opt[m].values())
row["n_params"] = len(want)
row["model_parameters_dtensor"] = sum(isinstance(p, DTensor)
                                      for p in sstate["model"].parameters())
row["step_dtensor"] = isinstance(opt["step"], DTensor)
row["losses_equal_bits"] = plain["losses"] == sharded["losses"]
row["loss_max_abs_diff"] = max(abs(a - b) for a, b in zip(plain["losses"], sharded["losses"]))
diffs = {k: float((got[k].to_local() - want[k]).abs().max()) for k in want}
row["params_equal_bits"] = all(torch.equal(got[k].to_local(), want[k]) for k in want)
row["param_max_abs_diff"] = max(diffs.values())
row["param_worst"] = max(diffs, key=diffs.get)
row["atol"] = atol
row["step_ms_ratio"] = row["mesh"]["median_step_ms"] / row["plain"]["median_step_ms"]
row["memory_ratio"] = ((row["mesh"]["max_memory_allocated"] - row["mesh"]["held_before"])
                       / (row["plain"]["max_memory_allocated"] - row["plain"]["held_before"]))
row["kernel_launches"] = {k: n - launches.get(k, 0) for k, n in ops.LAUNCHES.items()
                          if n != launches.get(k, 0)}
print("TRAIN_MESH " + json.dumps(row), flush=True)
bad = []
if not all(math.isfinite(x) for x in plain["losses"] + sharded["losses"]):
    bad.append("a loss is not finite")
if not (row["dtensor_params"] == row["n_params"] == row["model_parameters_dtensor"]
        and row["dtensor_moments"] == 2 * row["n_params"] and row["step_dtensor"]):
    bad.append("not every parameter and moment is a DTensor on the device")
if row["loss_max_abs_diff"] > atol or row["param_max_abs_diff"] > atol:
    bad.append(f"the mesh path differs from the plain one by more than {atol}")
if row["kernel_launches"]:
    bad.append(f"kernels launched in training: {row['kernel_launches']}")
torch.distributed.destroy_process_group()
if bad:
    sys.exit("train_mesh: " + "; ".join(bad))
"""


def train_mesh_phase(torch, ops) -> dict:
    """Sharded training on one card, in a child process (its NCCL group ends
    with it): qwen3-1.7b at full width in fp32, ``TRAIN_MESH_ARGS``'s 4
    steps on the plain path, then the same 4 steps from the same seed
    through ``train.run(mesh=make_host_mesh())``, a (1, 1) mesh over NCCL
    (world size 1) with DTensor parameters and optimizer state.  Prints
    how many parameters and moments are DTensors on the card, each path's
    losses, step ms (host clock ending in a device sync), allocator peak
    and model TFLOP/s (``model_flops`` over the median step), and the
    largest difference of the losses and parameters; raises unless every
    one is a DTensor and the two paths agree to ``TRAIN_MESH_ATOL`` (equal
    bits expected), or a kernel launched."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_MESH_CHILD, json.dumps([*TRAIN_MESH_ARGS, "--device", "cuda"]),
         repr(TRAIN_MESH_ATOL)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("TRAIN_MESH ")]
    if not lines:
        raise AssertionError(f"train_mesh: the child printed no result (exit "
                             f"{proc.returncode}): {proc.stderr[-3000:]}")
    row = {**json.loads(lines[-1].split(" ", 1)[1]), "phase_wall_s": time.perf_counter() - t0}
    print("train_mesh " + json.dumps(row))
    if proc.returncode != 0:
        raise AssertionError(f"train_mesh: exit {proc.returncode}: {proc.stderr[-3000:]}")
    return row


DRYRUN_CHECK_CHILD = """
import json, math, sys
from unittest import mock
import torch
import torch.distributed as dist
from repro_torch.configs import SHAPES, ShapeCell
from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.sharding import default_rules
from repro_torch.hwgen import sharded
from repro_torch.hwgen.collectives import CollectiveCounter, total_collective_bytes
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, mesh as mesh_lib

check, rounding = json.loads(sys.argv[1]), int(sys.argv[2])
cell = ShapeCell("train_4k", "train", check["seq"], check["batch"])
row = {"arch": check["arch"], "layers": check["layers"], "batch": check["batch"],
       "seq": check["seq"]}

with mock.patch.dict(dryrun.SHAPES, {"train_4k": cell}):
    # the dry run on the fake group, on a (1, 1) mesh
    sharded.start_fake_group(256)
    with mock.patch.object(mesh_lib, "make_production_mesh",
                           lambda multi_pod=False, device_type=None:
                           mesh_lib.make_mesh((1, 1), ("data", "model"), device_type)):
        record = dryrun.run_cell(check["arch"], "train_4k", False, n_units=check["layers"])
    dist.destroy_process_group()
    row["dryrun"] = {k: record[k] for k in ("status", "memory", "collective_bytes",
                                            "param_bytes_per_device", "opt_bytes_per_device",
                                            "model_flops", "trace_s")}
    row["dryrun"]["flops"] = record["cost"]["flops"]
    # the same step on the card, on a (1, 1) NCCL mesh
    host = mesh_lib.make_host_mesh("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(mesh_lib, "make_production_mesh",
                           lambda multi_pod=False, device_type=None: host):
        step, args, mesh, meta = dryrun.build_cell(check["arch"], "train_4k", False,
                                                   n_units=check["layers"], device="cuda")
    torch.cuda.synchronize()
    tensors = sharded.local_tensors(args)
    placed = torch.cuda.memory_allocated() - held
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    rounded = sum(-(-t.numel() * t.element_size() // rounding) * rounding for t in tensors)
    # the allocator's block behind each argument's storage: the bytes it was
    # asked for, and the block's size (rounded up to 512, and a large block
    # not split when its remainder would be small)
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for block in seg["blocks"]:
            if block["state"] == "active_allocated":
                blocks[addr] = (block["requested_size"], block["size"])
            addr += block["size"]
    found = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    unfound = sum(ptr not in blocks for ptr in found)
    requested = sum(blocks[ptr][0] for ptr in found if ptr in blocks)
    in_blocks = sum(blocks[ptr][1] for ptr in found if ptr in blocks)
    short = sum(blocks[ptr][1] < -(-n // rounding) * rounding
                for ptr, n in found.items() if ptr in blocks)
    launches = dict(ops.LAUNCHES)
    with sharding_context(mesh, default_rules(mesh)), CollectiveCounter() as counter:
        _, _, metrics = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    row["card"] = {"argument_tensors": len(tensors), "argument_bytes": nbytes,
                   "requested_bytes": requested, "argument_blocks_bytes": in_blocks,
                   "argument_storages_not_in_a_block": unfound,
                   "rounded_argument_bytes": rounded,
                   "blocks_over_rounded_bytes": in_blocks - rounded,
                   "allocated_while_placing": placed,
                   "max_memory_allocated_less_held": peak, "held_before": held,
                   "collective_bytes": total_collective_bytes(counter.stats),
                   "collectives": sum(v["count"] for v in counter.stats.values()),
                   "loss": float(metrics["loss"].full_tensor() if hasattr(
                       metrics["loss"], "full_tensor") else metrics["loss"])}
    row["argument_bytes_equal"] = (row["dryrun"]["memory"]["argument_bytes"] == nbytes
                                   == requested)
    row["blocks_hold_the_rounded_bytes"] = not unfound and not short
    row["memtracker_peak_over_card_peak"] = (row["dryrun"]["memory"]["peak_bytes_per_device"]
                                             / peak)
    row["kernel_launches"] = {k: n - launches.get(k, 0) for k, n in ops.LAUNCHES.items()
                              if n != launches.get(k, 0)}
print("DRYRUN_CHECK " + json.dumps(row), flush=True)
bad = []
if record["status"] != "ok":
    bad.append(f"the dry run's status is {record['status']}")
if not row["argument_bytes_equal"]:
    bad.append(f"argument_bytes {row['dryrun']['memory']['argument_bytes']} differs from the "
               f"card's argument tensors ({nbytes}) or the bytes their blocks were asked "
               f"for ({requested})")
if not row["blocks_hold_the_rounded_bytes"]:
    bad.append(f"{unfound} argument storages in no block, {short} blocks smaller than "
               f"their tensor rounded up to {rounding}")
if row["card"]["collectives"] or not math.isfinite(row["card"]["loss"]):
    bad.append("a collective on one card, or a loss that is not finite")
if row["kernel_launches"]:
    bad.append(f"kernels launched: {row['kernel_launches']}")
dist.destroy_process_group()
if bad:
    sys.exit("dryrun: " + "; ".join(bad))
"""


def _dryrun_cell(arch, shape, mesh, extra, out) -> tuple:
    """``python -m repro_torch.launch.dryrun`` for one cell, started in a
    child process with the cards hidden (the dry run needs none)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh, "--out", out, *extra]
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=str(ROOT))


def dryrun_phase(torch, ops) -> dict:
    """The multi-pod dry run (``repro_torch.launch.dryrun``) under this
    machine's torch.  ``DRYRUN_CELLS`` through the CLI, each in a child
    process with the cards hidden (the fake process group at 256 or 512
    ranks, the model on ``meta``): status, seconds and collective bytes by
    kind of each; raises on any error.  Meanwhile, in another child, the
    dry run held to the card: ``DRYRUN_CHECK``'s train step, its (1, 1)
    record on the fake group, then the same step on a (1, 1) NCCL mesh on
    the card: ``argument_bytes`` must equal the bytes of the card's
    parameters, moments and batch and the bytes the caching allocator was
    asked for them, each in a block of at least its size rounded up to
    ``DRYRUN_ALLOC_ROUND`` (the blocks' total is printed); MemTracker's
    peak over the card's (``max_memory_allocated`` less what was held
    before) and the collectives counted on NCCL (none) are printed."""
    import subprocess
    import tempfile

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as out:
        cells = [_dryrun_cell(*cell, out) for cell in DRYRUN_CELLS]
        check = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CHECK_CHILD, json.dumps(DRYRUN_CHECK),
             str(DRYRUN_ALLOC_ROUND)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=str(ROOT))
        rows, bad = [], []
        for (arch, shape, mesh, extra), (cmd, proc) in zip(DRYRUN_CELLS, cells):
            stdout, stderr = proc.communicate(timeout=600)
            lines = [line for line in stdout.splitlines() if line.startswith("{")]
            rec = json.loads(lines[-1]) if lines else {"status": "no record"}
            flags = [a for a in extra if a != "--no-cost"]
            opts = dict(zip(flags[::2], flags[1::2]))
            suffix = ("__" + opts["--variant"].replace(",", "+")) if "--variant" in opts else ""
            suffix += f"__units{opts['--units']}" if "--units" in opts else ""
            path = Path(out) / f"{arch}__{shape}__{mesh}{suffix}.json"
            kinds = json.loads(path.read_text()).get("collectives", {}) if path.exists() else {}
            row = {"cell": f"{arch}__{shape}__{mesh}", "args": extra, "status": rec.get("status"),
                   "exit": proc.returncode, "trace_s": rec.get("trace_s"),
                   "total_s": rec.get("total_s"), "collective_bytes": rec.get("collective_bytes"),
                   "collective_bytes_by_kind": {k: v["bytes"] for k, v in kinds.items()},
                   "argument_bytes": rec.get("memory", {}).get("argument_bytes"),
                   "peak_bytes_per_device": rec.get("memory", {}).get("peak_bytes_per_device"),
                   "model_flops": rec.get("model_flops"), "flops": rec.get("cost", {}).get("flops")}
            print("dryrun_cell " + json.dumps(row))
            rows.append(row)
            if proc.returncode != 0 or rec.get("status") not in ("ok", "skipped"):
                bad.append(f"{row['cell']} {extra}: {rec.get('status')} (exit "
                           f"{proc.returncode}): {stderr[-2000:]}")
        stdout, stderr = check.communicate(timeout=600)
    lines = [line for line in stdout.splitlines() if line.startswith("DRYRUN_CHECK ")]
    checked = json.loads(lines[-1].split(" ", 1)[1]) if lines else None
    row = {"torch": torch.__version__, "cells": rows, "check": checked,
           "phase_wall_s": time.perf_counter() - t0}
    print("dryrun " + json.dumps(row))
    if check.returncode != 0 or checked is None:
        bad.append(f"the check against the card: exit {check.returncode}: {stderr[-3000:]}")
    if bad:
        raise AssertionError("dryrun: " + "; ".join(bad))
    return row


POD_NAS_CHILD = """
import importlib.util, json, math, sys, time
import torch
from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.sharding import default_rules
from repro_torch.hwgen import sharded
from repro_torch.hwgen.collectives import CollectiveCounter, total_collective_bytes
from repro_torch.hwgen.generator import TorchGenerator
from repro_torch.hwgen.targets import TargetSpec, get_target
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM

path, trials, layers, batch, seq, rounding = sys.argv[1], *map(int, sys.argv[2:])
loader = importlib.util.spec_from_file_location("hw_in_loop_nas_lm", path)
ex = importlib.util.module_from_spec(loader)
loader.loader.exec_module(ex)
launches = dict(ops.LAUNCHES)

# the study on h100_pod: 256 fake ranks, every candidate on meta
rows = []
t0 = time.perf_counter()
study = ex.run_study(TorchGenerator(get_target("h100_pod")), trials, batch, seq,
                     log=lambda line: rows.append(json.loads(line.split(" ", 1)[1])))
out = {"trials": rows, "study_s": time.perf_counter() - t0,
       "states": [t.state.value for t in study.trials]}
best = study.best_trial
out["best"] = {"number": best.number, "params": best.params}

# its best candidate cut to `layers`, counted on a (1, 1) mesh of the fake group
spec = ex.with_depth(ex.spec_from_params(best.params), layers)
one = TargetSpec(name="h100_1x1", chip=get_target("h100_pod").chip, mesh_shape=(1, 1),
                 mesh_axes=("data", "model"), measurement="roofline", device="cpu")
fn, args, shardings = ex.sharded_program(spec, one, batch, seq)
counted = TorchGenerator(one).generate(fn, args, shardings)

# the same layout on the card, on a (1, 1) NCCL mesh: weights and tokens drawn there
mesh = make_host_mesh("cuda")
torch.cuda.synchronize()
torch.cuda.empty_cache()
held = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
gen = torch.Generator("cuda").manual_seed(0)
model = LM(spec).init(gen, torch.bfloat16)
tokens = torch.randint(0, spec.vocab, (batch, seq), dtype=torch.int32, device="cuda",
                       generator=gen)
placed = sharded.distribute(({k: p.detach() for k, p in model.named_parameters()}, tokens),
                            shardings, mesh)
torch.cuda.synchronize()
tensors = sharded.local_tensors(placed)
nbytes = sum(t.numel() * t.element_size() for t in tensors)
blocks = {}
for seg in torch.cuda.memory_snapshot():
    addr = seg["address"]
    for block in seg["blocks"]:
        if block["state"] == "active_allocated":
            blocks[addr] = (block["requested_size"], block["size"])
        addr += block["size"]
found = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
unfound = sum(ptr not in blocks for ptr in found)
requested = sum(blocks[ptr][0] for ptr in found if ptr in blocks)
short = sum(blocks[ptr][1] < -(-n // rounding) * rounding
            for ptr, n in found.items() if ptr in blocks)
t0 = time.perf_counter()
with torch.no_grad(), sharding_context(mesh, default_rules(mesh)), \\
        CollectiveCounter() as counter:
    logits = fn(*placed)
    logits = logits.to_local() if hasattr(logits, "to_local") else logits
    finite = bool(torch.isfinite(logits).all())
torch.cuda.synchronize()
out["check"] = {
    "params": best.params, "layers": layers, "batch": batch, "seq": seq,
    "counted": {"argument_bytes": counted.memory["argument_bytes"],
                "peak_bytes_per_device": counted.memory["peak_bytes_per_device"],
                "collective_bytes": counted.collective_bytes, "flops": counted.flops},
    "card": {"argument_tensors": len(tensors), "argument_bytes": nbytes,
             "requested_bytes": requested, "storages_not_in_a_block": unfound,
             "blocks_below_rounded": short, "forward_s": time.perf_counter() - t0,
             "max_memory_allocated_less_held": torch.cuda.max_memory_allocated() - held,
             "collectives": sum(v["count"] for v in counter.stats.values()),
             "logits_shape": list(logits.shape), "logits_finite": finite}}
out["check"]["argument_bytes_equal"] = (counted.memory["argument_bytes"] == nbytes
                                        == requested)
out["check"]["counted_peak_over_card_peak"] = (
    counted.memory["peak_bytes_per_device"]
    / out["check"]["card"]["max_memory_allocated_less_held"])
out["kernel_launches"] = {k: n - launches.get(k, 0) for k, n in ops.LAUNCHES.items()
                          if n != launches.get(k, 0)}
torch.distributed.destroy_process_group()
print("POD_NAS " + json.dumps(out), flush=True)
"""


def _pod_child():
    """The mode-2 search's child process (``POD_NAS_CHILD``), started: its
    study on ``h100_pod`` on the host, then its best candidate on the card."""
    import subprocess

    return subprocess.Popen(
        [sys.executable, "-c", POD_NAS_CHILD, str(POD_EXAMPLE), str(POD_TRIALS),
         str(POD_CHECK_LAYERS), str(POD_BATCH), str(POD_SEQ), str(DRYRUN_ALLOC_ROUND)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=str(ROOT))


def _pod_measured(torch, ops) -> dict:
    """``POD_MEASURED_TRIALS`` trials of the mode-2 search's ``h100`` branch
    on the card (sequence 128, batch 2, fp32 weights from seed 0, each
    placed, run and timed), with the kernels they launched."""
    from repro_torch.hwgen.generator import TorchGenerator
    from repro_torch.hwgen.targets import get_target

    example = _example("hw_in_loop_nas_lm")
    before = dict(ops.LAUNCHES)
    rows = []
    t0 = time.perf_counter()
    study = example.run_study(TorchGenerator(get_target("h100")), POD_MEASURED_TRIALS, 2, 128,
                              log=lambda line: rows.append(json.loads(line.split(" ", 1)[1])))
    torch.cuda.synchronize()
    return {"study": study, "rows": rows, "measured_s": time.perf_counter() - t0,
            "launched": _launched_since(ops, before)}


def pod_nas_phase(torch, ops, measured=None, child=None) -> dict:
    """The paper's mode-2 LM search (``examples/torch/hw_in_loop_nas_lm.py``,
    the reference's search space and objective).  A child process
    (``_pod_child``) runs its study on ``h100_pod`` for ``POD_TRIALS``
    trials (the fake process group stays in that process) and holds its
    best candidate, cut to ``POD_CHECK_LAYERS`` layers, to the card: the
    counted ``argument_bytes`` on a (1, 1) mesh must equal the bytes of
    its parameters and tokens laid out on a (1, 1) NCCL mesh and the bytes
    the allocator was asked for them, each in a block of at least its size
    rounded up to ``DRYRUN_ALLOC_ROUND``; the forward there must give
    finite logits and issue no collective.  ``POD_MEASURED_TRIALS`` trials
    of the study's ``h100`` branch run on the card here
    (``_pod_measured``), before the child starts: their forwards are
    host-bound, and the child's counting would share the host with them.
    ``measured`` and ``child`` are those when the caller ran and started
    them (the main path runs the child beside the dryrun phase's).  Every
    trial must complete, and no kernel launch anywhere (the backbones run
    the plain math, as the reference's default ``impl`` does)."""
    t_phase = time.perf_counter()
    if measured is None:
        measured = _pod_measured(torch, ops)
        torch.cuda.empty_cache()
    if child is None:
        child = _pod_child()
    try:
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    study, launched = measured["study"], measured["launched"]
    for row in measured["rows"]:
        print("pod_nas_measured_trial " + json.dumps(row))
    lines = [line for line in stdout.splitlines() if line.startswith("POD_NAS ")]
    counted = json.loads(lines[-1].split(" ", 1)[1]) if lines else None
    bad = []
    if child.returncode != 0 or counted is None:
        bad.append(f"the child: exit {child.returncode}: {stderr[-3000:]}")
    else:
        for row in counted["trials"]:
            print("pod_nas_trial " + json.dumps(row))
        print("pod_nas_check " + json.dumps(counted["check"]))
        check = counted["check"]
        if counted["states"] != ["complete"] * POD_TRIALS:
            bad.append(f"pod trials {counted['states']}")
        if not check["argument_bytes_equal"] or check["card"]["storages_not_in_a_block"] \
                or check["card"]["blocks_below_rounded"]:
            bad.append(f"argument bytes: counted {check['counted']['argument_bytes']}, on "
                       f"the card {check['card']}")
        if check["card"]["collectives"] or not check["card"]["logits_finite"] \
                or check["card"]["logits_shape"] != [POD_BATCH, POD_SEQ, 32000]:
            bad.append(f"the forward on the card: {check['card']}")
        if counted["kernel_launches"]:
            bad.append(f"kernels launched in the child: {counted['kernel_launches']}")
    states = [t.state.value for t in study.trials]
    if states != ["complete"] * POD_MEASURED_TRIALS:
        bad.append(f"measured trials {states}")
    if launched:
        bad.append(f"kernels launched: {launched}")
    row = {"phase_s": time.perf_counter() - t_phase, "measured_s": measured["measured_s"],
           "study_s": counted and counted["study_s"], "best": counted and counted["best"],
           "measured_best": {"number": study.best_trial.number,
                             "params": study.best_trial.params} if study.best_trial else None,
           "kernel_launches": launched}
    print("pod_nas " + json.dumps(row))
    if bad:
        raise AssertionError("pod_nas: " + "; ".join(bad))
    return row


def _adamw64_first_step(torch, p, g, lr, cfg) -> dict:
    """The reference's AdamW first step (moments from zero, the global-norm
    clip, weight decay on every parameter) in float64, written out here:
    the yardstick of the port's fp32 step."""
    norm = torch.sqrt(sum(x.double().square().sum() for x in g.values()))
    scale = torch.clamp(cfg.grad_clip_norm / norm.clamp_min(1e-9), max=1.0)
    out = {}
    for k, w in p.items():
        gc = g[k].double() * scale
        mu, nu = (1 - cfg.b1) * gc, (1 - cfg.b2) * gc.square()
        delta = (mu / (1 - cfg.b1)) / (torch.sqrt(nu / (1 - cfg.b2)) + cfg.eps) \
            + cfg.weight_decay * w.double()
        out[k] = w.double() - lr * delta
    return out, scale


def train_check_phase(torch, ops) -> dict:
    """qwen3-1.7b at its published widths cut to ``TRAIN_CHECK_DEPTH``
    layers (a float64 copy of all 28 would not fit beside the fp32 run),
    one batch of ``TRAIN_ARGS``'s shape: the loss and every gradient of the
    fp32 step against the same step in float64 from the same weights,
    within ``TRAIN_GRAD_REL`` of each tensor's max |float64 gradient|; the
    parameters after the fp32 AdamW step against the float64 step's,
    within ``TRAIN_OPT_REL`` of the tensor's max |parameter| plus what the
    held gradient error can move an AdamW first update (lr times
    min(2, 2 TRAIN_GRAD_REL max|g| / (|g| + eps)) an element); the fp32
    AdamW arithmetic alone (float64 AdamW on the fp32 gradients) within
    ``TRAIN_OPT_REL``; and a microbatch-4 SGD step against the single
    step, as ``tests/test_train_infra.py::test_grad_accumulation_equivalence``
    holds them."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.train import _to_device
    from repro_torch.models.lm import LM
    from repro_torch.train.optimizer import Optimizer, OptimizerConfig, cosine_schedule
    from repro_torch.train.step import make_loss_fn, make_train_step, param_dict, value_and_grad

    full = get_arch("qwen3-1.7b").spec()
    spec = dataclasses.replace(full, layers=full.layers[:TRAIN_CHECK_DEPTH])
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    seq = int(TRAIN_ARGS[TRAIN_ARGS.index("--seq") + 1])
    batch_size = int(TRAIN_ARGS[TRAIN_ARGS.index("--global-batch") + 1])
    before = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    model = LM(spec).init(torch.Generator(device="cuda").manual_seed(0))
    batch = _to_device(SyntheticLMData(spec.vocab, seq, batch_size).batch_at(0),
                       model.embed.device)
    loss_fn = make_loss_fn(model)
    base = {k: v.clone() for k, v in param_dict(model).items()}
    p64 = {k: v.double() for k, v in base.items()}
    t0 = time.perf_counter()
    l32, g32 = value_and_grad(loss_fn, param_dict(model), batch)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    l64, g64 = value_and_grad(loss_fn, p64, batch)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    grad_over = {k: ((g32[k].double() - g64[k]).abs().max()
                     / (TRAIN_GRAD_REL * g64[k].abs().max())).item() for k in g64}
    worst_grad = max(grad_over, key=grad_over.get)

    cfg = OptimizerConfig(name="adamw", learning_rate=cosine_schedule(1e-3, 1, steps))
    opt = Optimizer(cfg)
    p32 = {k: v.clone() for k, v in base.items()}
    _, state, metrics = opt.update(g32, opt.init(p32), p32)
    lr = float(metrics["lr"])
    want, scale = _adamw64_first_step(torch, p64, g64, lr, cfg)
    arith, _ = _adamw64_first_step(torch, p64, {k: v.double() for k, v in g32.items()}, lr, cfg)
    step_over, arith_over, flips = {}, {}, 0
    for k, w in want.items():
        gc = (g64[k] * scale).abs()
        moved = lr * torch.clamp(2 * TRAIN_GRAD_REL * gc.max() / (gc + cfg.eps), max=2.0)
        bound = TRAIN_OPT_REL * w.abs().max() + moved
        step_over[k] = ((p32[k].double() - w).abs() / bound).max().item()
        arith_over[k] = ((p32[k].double() - arith[k]).abs().max()
                         / (TRAIN_OPT_REL * arith[k].abs().max())).item()
        flips += int(((p32[k].double() - p64[k]).sign() != (w - p64[k]).sign()).sum())
    worst_step = max(step_over, key=step_over.get)
    worst_arith = max(arith_over, key=arith_over.get)
    del g32, g64, want, arith, p64

    sgd = Optimizer(OptimizerConfig(name="sgd", learning_rate=0.1, grad_clip_norm=None,
                                    weight_decay=0.0))
    mb = {}
    for n in (1, 4):
        p = {k: v.clone() for k, v in base.items()}
        mb[n] = make_train_step(model, sgd, microbatches=n)(p, sgd.init(p), batch)
    mb_diff = max((mb[1][0][k] - mb[4][0][k]).abs().max().item() for k in base)
    mb_loss_rel = abs(float(mb[1][2]["loss"]) - float(mb[4][2]["loss"])) / float(mb[1][2]["loss"])
    launched = _launched_since(ops, before)
    row = {
        "arch": spec.name, "layers": f"{len(spec.layers)} of {full.n_layers} (cut: depth)",
        "d_model": spec.d_model, "vocab": spec.vocab, "batch": [batch_size, seq],
        "loss_fp32": float(l32), "loss_float64": float(l64),
        "loss_rel_err": abs(float(l32) - float(l64)) / abs(float(l64)),
        "grad_tol": f"{TRAIN_GRAD_REL} of each tensor's max |float64 gradient|",
        "grad_max_err_over_tol": grad_over[worst_grad], "grad_worst": worst_grad,
        "grad_median_err_over_tol": statistics.median(grad_over.values()),
        "step_tol": (f"{TRAIN_OPT_REL} max|float64 param| + lr min(2, 2 {TRAIN_GRAD_REL} "
                     f"max|g| / (|g| + eps)) per element"),
        "step_max_err_over_tol": step_over[worst_step], "step_worst": worst_step,
        "update_sign_flips": flips, "update_elements": sum(v.numel() for v in base.values()),
        "adamw_arith_tol": f"{TRAIN_OPT_REL} of max |param| (float64 AdamW on the fp32 gradients)",
        "adamw_arith_max_err_over_tol": arith_over[worst_arith],
        "lr": lr, "clip_scale": scale.item(),
        "microbatch4_max_abs_param_diff": mb_diff, "microbatch4_tol": TRAIN_MB_ATOL,
        "microbatch4_loss_rel": mb_loss_rel,
        "fp32_grad_s": fp32_s, "float64_grad_s": f64_s, "kernel_launches": launched}
    print("train_check " + json.dumps(row))
    del model, base, mb, state, p32
    torch.cuda.empty_cache()
    if max(grad_over.values()) > 1 or max(step_over.values()) > 1 or max(arith_over.values()) > 1:
        raise AssertionError(f"train_check: fp32 misses the float64 step: {row}")
    if mb_diff > TRAIN_MB_ATOL or mb_loss_rel > 1e-5 or launched:
        raise AssertionError(f"train_check: microbatches or launches: {row}")
    return row


def _sigterm_after(n):
    """A ``PreemptionHandler`` class whose instance sends this process
    SIGTERM when it is polled the ``n``-th time (after step ``n``): the
    trainer's own handler then sets the flag, as a scheduler's SIGTERM
    would."""
    import signal

    from repro_torch.distributed.fault import PreemptionHandler

    class Handler(PreemptionHandler):
        polls = 0

        @property
        def preempted(self):
            Handler.polls += 1
            if Handler.polls == n:
                os.kill(os.getpid(), signal.SIGTERM)
                for _ in range(1000):  # the handler runs in the main thread
                    if self._requested:
                        break
                    time.sleep(0.001)
            return super().preempted

    return Handler


def train_resume_phase(torch, ops) -> dict:
    """The train CLI at ``--smoke`` on the card, with and without
    ``--compression``: 12 steps checkpointing every 5, then a rerun to 20,
    which must print "resumed from step 10"; an uninterrupted 20-step run;
    and a 20-step run preempted by SIGTERM after step 10 (the flush saves
    step 10), then rerun.  The reference's cosine schedule spans
    ``--steps``, so the 12-then-20 sequence trains its first 10 steps on
    another schedule than the 20-step run and ends elsewhere (both
    printed); the preempted-and-resumed run shares the schedule and must
    end on the uninterrupted run's loss, bit for bit where the card's
    backward is deterministic, else within ``RESUME_REL``.  With
    compression the error-feedback residual is not part of a checkpoint
    (as in the reference), so there it must come within
    ``RESUME_COMPRESSION_REL``."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import train

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            summary, _ = train.run(train.build_parser().parse_args(argv))
        return summary, out.getvalue()

    before, rows = dict(ops.LAUNCHES), {}
    for compression in (False, True):
        base = TRAIN_RESUME_ARGS + ["--compression"] * compression
        with tempfile.TemporaryDirectory() as tmp:
            ck = ["--ckpt-dir", os.path.join(tmp, "a"), "--ckpt-every", "5"]
            run(base + ["--steps", "12"] + ck)
            again, text = run(base + ["--steps", "20"] + ck)
            whole, _ = run(base + ["--steps", "20"])
            ck = ["--ckpt-dir", os.path.join(tmp, "b"), "--ckpt-every", "50"]
            with mock.patch.object(train, "PreemptionHandler", _sigterm_after(10)):
                first, flushed = run(base + ["--steps", "20"] + ck)
            resumed, resumed_text = run(base + ["--steps", "20"] + ck)
        rel = abs(resumed["final_loss"] - whole["final_loss"]) / abs(whole["final_loss"])
        row = {
            "compression": compression,
            "resumed_from_step_10": "[train] resumed from step 10" in text,
            "resumed_12_then_20_final_loss": again["final_loss"],
            "uninterrupted_20_final_loss": whole["final_loss"],
            "preempted_after": len(first["losses"]),
            "preemption_flushed": "preemption: flushing checkpoint" in flushed,
            "preempted_resumed_from": resumed["start_step"],
            "preempted_then_resumed_final_loss": resumed["final_loss"],
            "first_10_losses_equal": first["losses"] == whole["losses"][:10],
            "bit_for_bit": resumed["losses"] == whole["losses"][10:],
            "final_loss_rel_diff": rel,
            "tol": RESUME_COMPRESSION_REL if compression else RESUME_REL}
        rows["compression" if compression else "plain"] = row
        print("train_resume " + json.dumps(row))
        if not (row["resumed_from_step_10"] and row["preemption_flushed"]
                and row["preempted_after"] == 10 and resumed["start_step"] == 10
                and "resumed from step 10" in resumed_text
                and all(math.isfinite(x) for x in (again["final_loss"], resumed["final_loss"]))):
            raise AssertionError(f"train_resume: {row}")
        if rel > row["tol"]:
            raise AssertionError(f"train_resume: the resumed run's final loss misses the "
                                 f"uninterrupted run's: {row}")
    launched = _launched_since(ops, before)
    if launched:
        raise AssertionError(f"train_resume: kernels launched: {launched}")
    return rows


def _example(name: str):
    """The port's ``examples/torch/<name>.py``, loaded as a module."""
    import importlib.util

    loader = importlib.util.spec_from_file_location(f"example_{name}",
                                                    ROOT / "examples" / "torch" / f"{name}.py")
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module


def val_accuracy_phase(torch, ops) -> dict:
    """The paper's Listing 3 through ``examples/torch/nas_conv1d.py``'s own
    wiring on the card: its space and data, the param budget (hard, 2e6),
    ``val_accuracy`` (``LISTING3_STEPS`` steps, objective) and
    ``latency_s`` at target h100 (batch 8, soft 0.050 s, weight 0.5), TPE
    (seed 0, 5 startup trials) with successive halving, ``LISTING3_TRIALS``
    trials; training and latency on the card.  Then the best trial's
    estimator again on the CPU from the same initial weights: its accuracy
    within one validation sample of the card's, its last loss within
    ``VAL_LOSS_REL``.  Then the example's deploy of the winner (its
    latency measured on the card, the counted FLOPs, whether its measured
    peak fits the card).  No kernel may launch."""
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.space import parse_search_space
    from repro_torch.evaluation.estimators import TrainedAccuracyEstimator
    from repro_torch.hwgen.generator import TorchGenerator

    example = _example("nas_conv1d")
    runs = {}  # signature -> the card's initial weights (on the host) and last loss

    class Recording(TrainedAccuracyEstimator):
        def _weights(self, candidate):
            weights = super()._weights(candidate)
            runs.setdefault(candidate.arch.signature(), {})["weights"] = {
                n: {k: v.to("cpu", copy=True) for k, v in leaves.items()}
                for n, leaves in weights.items()}
            return weights

        def fit(self, candidate, data, trial=None):
            params, loss = super().fit(candidate, data, trial)
            runs[candidate.arch.signature()]["loss"] = loss
            return params, loss

    space = parse_search_space(example.SPACE)
    generator = TorchGenerator("h100")
    builder = ModelBuilder(space.input_shape, space.output_dim)
    data = example.make_data()
    runner = example.make_runner("h100", LISTING3_STEPS, "cuda",
                                 accuracy=Recording(steps=LISTING3_STEPS))
    models = {}
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    study = example.run_study(space, builder, runner, data, LISTING3_TRIALS,
                              allowed=generator.supported_ops(), storage=None,
                              name="nas-conv1d-h100", models=models)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trials = [{"trial": t.number, "state": t.state.value,
               "val_accuracy": t.user_attrs.get("val_accuracy"),
               "latency_s": t.user_attrs.get("latency_s"),
               "n_params": t.user_attrs.get("n_params"),
               "intermediate": {str(k): v for k, v in t.intermediate.items()},
               "signature": t.user_attrs.get("signature")} for t in study.trials]
    for row in trials:
        print("val_accuracy_trial " + json.dumps(row))
    best = study.best_trial
    model, sig = models[best.number], best.user_attrs["signature"]
    card_acc, card_loss = best.user_attrs["val_accuracy"], runs[sig]["loss"]

    class SameWeights(TrainedAccuracyEstimator):
        def _weights(self, candidate):
            return {n: {k: v.clone() for k, v in leaves.items()}
                    for n, leaves in runs[sig]["weights"].items()}

    cpu = SameWeights(steps=LISTING3_STEPS, device="cpu")
    params, cpu_loss = cpu.fit(model, data)
    cpu_acc = cpu.accuracy(model, params, data["x_val"], data["y_val"])
    deployed = example.deploy(space, builder, generator, best)
    launched = _launched_since(ops, before)
    n_val = len(data["y_val"])
    row = {
        "trials": len(study.trials), "wall_s": wall,
        "states": [t["state"] for t in trials],
        "best": {"trial": best.number, "value": best.values[0], "val_accuracy": card_acc,
                 "latency_s": best.user_attrs.get("latency_s"), "signature": sig},
        "best_on_cpu": {"val_accuracy": cpu_acc, "last_loss": cpu_loss},
        "best_last_loss_card": card_loss,
        "accuracy_diff": abs(card_acc - cpu_acc), "accuracy_tol": 1.0 / n_val,
        "loss_rel_diff": abs(card_loss - cpu_loss) / abs(cpu_loss),
        "loss_tol": VAL_LOSS_REL, "kernel_launches": launched}
    print("val_accuracy " + json.dumps(row))
    print("val_accuracy_deploy " + json.dumps(deployed))
    if len(study.trials) != LISTING3_TRIALS or not any(t["state"] == "complete" for t in trials):
        raise AssertionError(f"val_accuracy: trials {trials}")
    if row["accuracy_diff"] > 1.0 / n_val + 1e-9 or row["loss_rel_diff"] > VAL_LOSS_REL:
        raise AssertionError(f"val_accuracy: the CPU rerun of the best trial disagrees: {row}")
    if not (deployed["latency_s"] > 0 and deployed["flops"] > 0 and deployed["fits_memory"]):
        raise AssertionError(f"val_accuracy: the deployed winner {deployed}")
    if launched:
        raise AssertionError(f"val_accuracy: kernels launched: {launched}")
    return {**row, "deploy": deployed}


def _quickstart_example(torch) -> dict:
    """``examples/torch/quickstart.py`` at target h100 and at host_cpu in
    this process: the same trials and best trial (the criteria are
    analytic); the winner's weights drawn on the card, its output there
    against the same weights' on the CPU."""
    from repro_torch import Explorer

    example = _example("quickstart")
    t0 = time.perf_counter()
    card = Explorer.from_spec(example.experiment("h100"), device="cuda")
    report = card.run(save_report=False)
    host = Explorer.from_spec(example.experiment("host_cpu"), device="cpu")
    host_report = host.run(save_report=False)

    def trials(explorer):
        return [(t.number, t.state.value, t.values, t.user_attrs.get("signature"))
                for t in explorer.study.trials]

    model = card.best_model()
    y = example.run_winner(model, "cuda")
    y_cpu = example.run_winner(model.to("cpu"), "cpu")
    err = (y.cpu() - y_cpu).abs().max().item()
    tol = QUICKSTART_OUT_REL * y_cpu.abs().max().item()
    row = {"wall_s": time.perf_counter() - t0, "trials": len(card.study.trials),
           "best": {k: report.best[k] for k in ("number", "values", "signature")},
           "best_host_cpu": {k: host_report.best[k] for k in ("number", "values", "signature")},
           "trials_equal": trials(card) == trials(host), "output_shape": list(y.shape),
           "output_max_abs_err": err, "output_tol": tol, "n_params": model.n_params}
    print("examples_quickstart " + json.dumps(row))
    if not row["trials_equal"] or row["best"] != row["best_host_cpu"]:
        raise AssertionError(f"examples quickstart: h100 and host_cpu disagree: {row}")
    if tuple(y.shape) != (2, 4) or not bool(torch.isfinite(y).all()) or err > tol:
        raise AssertionError(f"examples quickstart: the winner's output on the card: {row}")
    return row


def _nas_parallel_example(torch) -> dict:
    """``examples/torch/nas_parallel.py --tiny --trials 8 --workers 2`` with
    the thread backend on the card (the example asserts that the serial
    and thread runs find the same best), and again at host_cpu: the same
    candidates sampled in each run."""
    example = _example("nas_parallel")
    argv = ["--tiny", "--trials", "8", "--workers", "2", "--backend", "thread"]
    out = {}
    for device in ("cuda", "cpu"):
        args = example.build_parser().parse_args(argv + ["--device", device])
        args.target = example.default_target(device)
        t0 = time.perf_counter()
        sx, serial, px, par = example.run(args)
        summary = example.summarize(args, serial, par)
        out[device] = {"wall_s": time.perf_counter() - t0,
                       "best": {k: summary["parallel"]["best"][k] for k in ("number", "values")},
                       "signatures": [[t.user_attrs.get("signature") for t in x.study.trials]
                                      for x in (sx, px)]}
    row = {"card": out["cuda"]["best"], "card_wall_s": out["cuda"]["wall_s"],
           "host_cpu": out["cpu"]["best"],
           "signatures_equal": out["cuda"]["signatures"] == out["cpu"]["signatures"]}
    print("examples_nas_parallel " + json.dumps(row))
    if not row["signatures_equal"]:
        raise AssertionError(f"examples nas_parallel: the card's runs sampled other "
                             f"candidates than the CPU's: {out}")
    return row


def _train_lm_example(torch, work: str) -> dict:
    """``examples/torch/train_lm.py --full --steps 100`` on the card (the
    ~100M model, fp32), then ``--steps 110`` on the same checkpoint
    directory, which must resume from step 100."""
    example = _example("train_lm")
    ckpt = os.path.join(work, "train_lm_ckpt")
    first = example.main(["--full", "--steps", "100", "--ckpt-dir", ckpt])
    lines = []

    def log(line):
        print(line)
        lines.append(line)

    resumed = example.train(example.build_parser().parse_args(
        ["--full", "--steps", "110", "--ckpt-dir", ckpt]), log=log)
    logged = {r["step"]: r["loss"] for r in first["logged"]}
    row = {"n_params": first["n_params"], "losses": logged, "step_ms": first["step_ms"],
           "tokens_per_s": first["tokens_per_s"],
           "max_memory_allocated": first["max_memory_allocated"],
           "resumed_from": resumed["start_step"], "resumed_steps": sorted(resumed["losses"]),
           "resumed_final_loss": resumed["final_loss"], "resumed_step_ms": resumed["step_ms"]}
    print("examples_train_lm " + json.dumps(row))
    losses = [logged.get(step, math.nan) for step in (25, 50, 75, 100)]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"examples train_lm: losses {logged}")
    if ("resumed from step 100" not in lines or resumed["start_step"] != 100
            or sorted(resumed["losses"]) != list(range(101, 111))
            or not math.isfinite(resumed["final_loss"])):
        raise AssertionError(f"examples train_lm: the resumed run {row}")
    return row


def _elastic_example(torch, work: str) -> dict:
    """``examples/torch/elastic_restart.py`` on the card: both phases on a
    (1, 1) NCCL mesh, the restart at step 10 with the restored parameters
    equal to the saved ones bit for bit, and no process group left."""
    import torch.distributed as dist

    example = _example("elastic_restart")
    t0 = time.perf_counter()
    out = example.run("cuda", ckpt_dir=os.path.join(work, "elastic_ckpt"))
    equal = (out["saved"].keys() == out["restored"].keys()
             and all(torch.equal(out["saved"][k], out["restored"][k]) for k in out["saved"]))
    row = {"wall_s": time.perf_counter() - t0, "loss_phase_1": out["loss_a"],
           "loss_phase_2": out["loss_b"], "restart_step": out["restart_step"],
           "mesh_a": out["mesh_a"], "mesh_b": out["mesh_b"],
           "restored_equal_saved": equal, "group_left": dist.is_initialized()}
    print("examples_elastic_restart " + json.dumps(row))
    if (out["restart_step"] != 10 or not equal or row["group_left"]
            or not all(math.isfinite(x) for x in (out["loss_a"], out["loss_b"]))):
        raise AssertionError(f"examples elastic_restart: {row}")
    return row


def examples_phase(torch, ops) -> dict:
    """The port's copies of the reference's examples on the card, in a
    scratch directory (they write ``results/`` and checkpoints): quickstart,
    ``nas_parallel --tiny``, ``train_lm --full`` and its resume,
    ``elastic_restart``.  None of their paths reaches a kernel (conv and
    linear candidates; training on the plain math): no kernel may launch."""
    import contextlib
    import tempfile

    before = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="examples-") as work, contextlib.chdir(work):
        rows = {"quickstart": _quickstart_example(torch),
                "nas_parallel": _nas_parallel_example(torch),
                "train_lm": _train_lm_example(torch, work),
                "elastic_restart": _elastic_example(torch, work)}
    launched = _launched_since(ops, before)
    if launched:
        raise AssertionError(f"examples: kernels launched: {launched}")
    torch.cuda.empty_cache()
    return {**rows, "kernel_launches": launched}


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
# the training phases, by name
TRAIN_PHASES = {
    "train": train_phase,
    "train_check": train_check_phase,
    "train_resume": train_resume_phase,
    "val_accuracy": val_accuracy_phase,
    "train_mesh": train_mesh_phase,
    "dryrun": dryrun_phase,
    "pod_nas": pod_nas_phase,
    "examples": examples_phase,
}
SUBSET_PHASES = ("flash", "ssm", "nas", "modelled", "explore", "cascade", "sweep",
                 "serving", "report_boot", "remote", "mlstm", *MODEL_PHASES,
                 *TRAIN_PHASES)


def main(argv=None) -> int:
    import argparse

    t_script = time.perf_counter()
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
        swept = None  # the remote phase compares with the sweep phase's kernel sweep
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
            elif name == "sweep":
                swept = sweep_phase(torch, ops, ref, nas)
            elif name == "serving":
                serving_phase(torch, ops)
            elif name == "report_boot":
                report_boot_phase(torch, ops, ref)
            elif name == "remote":
                remote_phase(torch, ops, swept and swept["kernel_cells"])
            elif name == "mlstm":
                mlstm_phase(torch, ops, ref, gen)
            elif name in MODEL_PHASES:
                MODEL_PHASES[name](torch, ops, ref, serve)
            elif name in TRAIN_PHASES:
                TRAIN_PHASES[name](torch, ops)
        return 0

    # each phase's wall seconds, printed before the result: what the
    # script's time limit is spent on
    spent = {"build": round(time.perf_counter() - t0, 1)}

    def timed(label, phase, *args):
        t_phase = time.perf_counter()
        try:
            return phase(*args)
        finally:
            spent[label] = round(time.perf_counter() - t_phase, 1)

    # -- 3. kernel against plain version ----------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rule_check(ops)
    kernel_rows = timed("flash", flash_phase, torch, ops, gen)

    # -- 3b. the SSD scan against its plain version -------------------------
    ssm_rows = timed("ssm", ssm_phase, torch, ops, ref, gen)

    # -- 4. serve at full width -------------------------------------------
    t_serve = time.perf_counter()
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

    spent["serve"] = round(time.perf_counter() - t_serve, 1)

    # -- 6. the NAS loop at zamba2-2.7b's widths ---------------------------
    del decode_cache, engine, model
    torch.cuda.empty_cache()
    nas = timed("nas", nas_phase, torch, ops, ref)

    # -- 6b. metric: modelled over the nas phase's candidates ----------------
    timed("modelled", modelled_phase, torch, ops, nas)

    # -- 6c. the Explorer facade with the kernel-schedule tuner -------------
    torch.cuda.empty_cache()
    explore = timed("explore", explore_phase, torch, ops)

    # -- 6d. the fidelity cascade: a synflow screen before the measurement --
    torch.cuda.empty_cache()
    cascade = timed("cascade", cascade_phase, torch, ops)

    # -- 6e. sweeps: three targets; the kernels through run_sweep; hw_parallel
    torch.cuda.empty_cache()
    sweep = timed("sweep", sweep_phase, torch, ops, ref, nas)

    # -- 6f. the traffic-shaped serving estimators: modelled, nothing runs ----
    timed("serving", serving_phase, torch, ops)

    # -- 6g. deploy-best: an exploration's winner booted from the store ------
    torch.cuda.empty_cache()
    booted = timed("report_boot", report_boot_phase, torch, ops, ref)

    # -- 6h. the remote worker pool: daemons measuring candidates ------------
    torch.cuda.empty_cache()
    remote = timed("remote", remote_phase, torch, ops, sweep["kernel_cells"])

    # -- 7. the mLSTM scan against its plain version -----------------------
    mlstm_rows = timed("mlstm", mlstm_phase, torch, ops, ref, gen)

    # -- 8. the xlstm-1.3b forward through the kernel -----------------------
    xfwd = timed("xlstm_forward", xlstm_forward_phase, torch, ops, ref, serve)
    xfwd16 = timed("xlstm_forward_bf16", xlstm_forward_bf16_phase, torch, ops, ref, serve)

    # -- 9. serving xlstm-1.3b ----------------------------------------------
    xserve = timed("xlstm_serve", lm_serve_phase, torch, ops, ref, serve, "xlstm",
                   XLSTM_SERVE_ARGS)

    # -- 10. zamba2-2.7b: its forward, then serving it -----------------------
    zfwd = timed("zamba2_forward", zamba2_forward_phase, torch, ops, ref, serve)
    zserve = timed("zamba2_serve", lm_serve_phase, torch, ops, ref, serve, "zamba2",
                   ZAMBA2_SERVE_ARGS)

    # -- 11. dbrx-132b at its published widths, one layer ---------------------
    moe = timed("moe_forward", moe_forward_phase, torch, ops, ref, serve)

    # -- 12. paligemma-3b: its forward with a patch prefix, then serving it ----
    pfwd = timed("paligemma_forward", paligemma_forward_phase, torch, ops, ref, serve)
    pserve = timed("paligemma_serve", lm_serve_phase, torch, ops, ref, serve, "paligemma",
                   PALIGEMMA_SERVE_ARGS)

    # -- 13. whisper-medium: encoder, decoder, the cached path ----------------
    wfwd = timed("whisper_forward", whisper_forward_phase, torch, ops, ref, serve)

    # -- 14. training: qwen3-1.7b at full width, fp32 vs float64, resume ----
    torch.cuda.empty_cache()
    trained = timed("train", train_phase, torch, ops)
    checked = timed("train_check", train_check_phase, torch, ops)
    resumed = timed("train_resume", train_resume_phase, torch, ops)

    # -- 14b. sharded training: the same CLI on a (1, 1) NCCL mesh -------------
    torch.cuda.empty_cache()
    meshed = timed("train_mesh", train_mesh_phase, torch, ops)

    # -- 14c. the paper's mode-2 LM search's h100 trials, alone on the host;
    # then the multi-pod dry run (its counts held to the card) beside the
    # search's pod study and card check in a child -------------------------
    torch.cuda.empty_cache()
    pod_measured = timed("pod_nas_measured", _pod_measured, torch, ops)
    torch.cuda.empty_cache()
    pod_child = _pod_child()
    try:
        dried = timed("dryrun", dryrun_phase, torch, ops)
        pod = timed("pod_nas", pod_nas_phase, torch, ops, pod_measured, pod_child)
    finally:
        if pod_child.poll() is None:
            pod_child.kill()
            pod_child.wait()

    # -- 15. the paper's Listing 3 with val_accuracy on the card ---------------
    listing3 = timed("val_accuracy", val_accuracy_phase, torch, ops)

    # -- 15b. the reference's other examples on the port ----------------------
    examples = timed("examples", examples_phase, torch, ops)
    trained_paths = {"train": trained["kernel_launches"],
                     "train_check": checked["kernel_launches"],
                     "train_mesh": meshed["kernel_launches"],
                     "dryrun": dried["check"]["kernel_launches"],
                     "pod_nas": pod["kernel_launches"],
                     "val_accuracy": listing3["kernel_launches"],
                     "examples": examples["kernel_launches"]}

    # -- 16. result --------------------------------------------------------
    print("phase_seconds " + json.dumps({**spent, "total": round(
        time.perf_counter() - t_script, 1)}))
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
                             **{f"sweep_{cell}": n.get("flash_attention", 0)
                                for cell, n in sweep["launches"].items()},
                             "zamba2_forward": zfwd["launches"].get("flash_attention", 0),
                             "zamba2_serve": zserve["flash_attention_launches"],
                             "moe_forward": moe["launches"].get("flash_attention", 0),
                             "paligemma_forward": pfwd["launches"].get("flash_attention", 0),
                             "paligemma_serve": pserve["flash_attention_launches"],
                             "whisper_forward": wfwd["launches"].get("flash_attention", 0),
                             "whisper_prefill":
                                 wfwd["cached"]["prefill_launches"].get("flash_attention", 0),
                             "report_boot_explore":
                                 booted["explore"]["launches"].get("flash_attention", 0),
                             "report_boot_served":
                                 booted["warm"]["launches"].get("flash_attention", 0),
                             **{f"remote_{run}": n.get("flash_attention", 0)
                                for run, n in remote.items()},
                             **{path: n.get("flash_attention", 0)
                                for path, n in trained_paths.items()}},
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
                             **{f"sweep_{cell}": n.get("ssm_scan", 0)
                                for cell, n in sweep["launches"].items()},
                             "zamba2_forward": zfwd["launches"].get("ssm_scan", 0),
                             "zamba2_serve": zserve["ssm_scan_launches"],
                             "report_boot_explore":
                                 booted["explore"]["launches"].get("ssm_scan", 0),
                             "report_boot_served": booted["warm"]["launches"].get("ssm_scan", 0),
                             **{f"remote_{run}": n.get("ssm_scan", 0)
                                for run, n in remote.items()},
                             **{path: n.get("ssm_scan", 0)
                                for path, n in trained_paths.items()}},
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
                                for dtype, r in explore["mlstm"].items()},
                             **{path: n.get("mlstm_scan", 0)
                                for path, n in trained_paths.items()}},
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
