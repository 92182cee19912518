"""End-to-end training CLI, the JAX package's ``launch/train.py`` on the
port, flag for flag::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --steps 200 --ckpt-dir ckpt

Mechanics:
  * ``--mesh single|multi``: parameters and optimizer state sharded as
    DTensors by the logical-axis resolver onto the production mesh
    ((16, 16) or (2, 16, 16) ranks; the process group starts from the
    ``torchrun`` environment, NCCL on ``cuda`` and gloo on ``cpu``); the
    batch enters replicated and the model's ``constrain`` shards it.
    ``--mesh host`` (the default) is the one device with plain tensors
  * parameters and optimizer state updated in place (the reference
    donates both buffers); AdamW with a cosine schedule
  * microbatch gradient accumulation, optional gradient compression
  * async checkpointing + retention + resume (picks up after kill -9)
  * preemption handler (SIGTERM -> final checkpoint -> clean exit)
  * straggler monitor + prefetching data pipeline

The weights are drawn from a generator seeded 0 on the device, in fp32.
Training runs on CUDA; ``--device cpu`` asks for the CPU, and without a
card nothing runs.  Each step's
time is taken on the host clock after a device sync, so the straggler
monitor sees the step, not its enqueueing.  The last line printed is the
reference's ``{"final_loss": ..., "straggler_flags": ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import Prefetcher, SyntheticLMData
from repro_torch.device import NoCudaCardError, resolve_device
from repro_torch.distributed.api import replicate, sharding_context
from repro_torch.distributed.compression import GradientCompressor
from repro_torch.distributed.fault import PreemptionHandler, StragglerMonitor
from repro_torch.distributed.sharding import (default_rules, distribute_model, placements_tree,
                                               replicate_tree)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import Optimizer, OptimizerConfig, cosine_schedule
from repro_torch.train.step import make_train_step, param_dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--compression", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to train (default cuda; there is no fallback)")
    return p


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``; integer arrays (tokens, labels) as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.to(device, dtype=torch.long if not t.is_floating_point() else None)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_process_group(device: torch.device) -> bool:
    """Start the process group from the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or a group of one
    rank without it; NCCL on ``cuda``, gloo on ``cpu``.  Returns whether it
    started one (False when one was running)."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    else:
        mesh_lib.start_single_process_group(device.type)
    return True


def production_mesh(kind: str, device: torch.device):
    """``make_production_mesh`` for ``--mesh single|multi`` (looked up when
    called, so a caller may swap in a small mesh), in the process group
    of :func:`_start_process_group`; a group it started ends when the
    mesh cannot be built."""
    started = _start_process_group(device)
    try:
        return mesh_lib.make_production_mesh(multi_pod=kind == "multi",
                                             device_type=device.type)
    except BaseException:
        if started:
            dist.destroy_process_group()
        raise


def _scalar(x) -> float:
    return float(replicate(x).to_local() if hasattr(x, "to_local") else x)


def run(args, mesh=None) -> tuple:
    """Train as the arguments say.  Returns (summary, state): the summary
    holds the final loss, the straggler flags, the step it resumed from,
    and each step's loss and seconds; the state holds the model, the
    parameters and optimizer state it left, the step function and the
    data.

    ``mesh`` (a ``DeviceMesh`` the caller built) trains sharded on it;
    without one ``--mesh single|multi`` builds the production mesh, and
    ``--mesh host`` trains plain tensors on one device."""
    device = resolve_device(args.device)
    if mesh is None and args.mesh != "host":
        mesh = production_mesh(args.mesh, device)
    arch = get_arch(args.arch)
    spec = arch.smoke_spec_fn() if args.smoke else arch.spec()
    model = LM(spec).init(torch.Generator(device=device).manual_seed(0), dtype=torch.float32)
    if mesh is not None:
        rules = default_rules(mesh)
        params = distribute_model(model, mesh, rules)
        context = sharding_context(mesh, rules)
    else:
        params = param_dict(model)
        context = contextlib.nullcontext()
    with context:
        return _train(args, spec, model, params, device, mesh)


def _train(args, spec, model, params, device, mesh) -> tuple:
    main = mesh is None or dist.get_rank() == 0

    optimizer = Optimizer(OptimizerConfig(
        name="adamw",
        learning_rate=cosine_schedule(args.lr, warmup=max(1, args.steps // 20),
                                      total=args.steps),
    ))
    opt_state = optimizer.init(params)

    compressor = GradientCompressor() if args.compression else None
    compress_state = compressor.init_state(params) if compressor else None
    step_fn = make_train_step(model, optimizer, microbatches=args.microbatches,
                              compressor=compressor)

    data = SyntheticLMData(spec.vocab, args.seq, args.global_batch)
    ckpt = Checkpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        like = {"params": params, "opt": opt_state}
        start_step, restored = ckpt.restore(
            like=like, device=device,
            shardings=None if mesh is None else placements_tree(like))
        model.load_state_dict(restored["params"], assign=True)
        params, opt_state = param_dict(model), restored["opt"]
        if main:
            print(f"[train] resumed from step {start_step}", flush=True)

    prefetch = Prefetcher(data, start_step=start_step)
    preempt = PreemptionHandler()
    straggler = StragglerMonitor()
    metrics: Dict[str, Any] = {}
    losses, step_s = [], []
    try:
        for _ in range(start_step, args.steps):
            t0 = time.perf_counter()
            step_idx, batch = prefetch.next()
            batch = _to_device(batch, device)
            if mesh is not None:  # enters replicated; the model's constrain shards it
                batch = replicate_tree(batch, mesh)
            if compressor:
                params, opt_state, metrics, compress_state = step_fn(
                    params, opt_state, batch, compress_state)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            _sync(device)
            dt = time.perf_counter() - t0
            slow = straggler.record(dt)
            losses.append(metrics["loss"])
            step_s.append(dt)
            if main and (step_idx + 1) % args.log_every == 0:
                loss = _scalar(metrics["loss"])
                print(f"[train] step {step_idx + 1} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms{' STRAGGLER' if slow else ''})", flush=True)
            if ckpt is not None and (step_idx + 1) % args.ckpt_every == 0:
                ckpt.save_async(step_idx + 1, {"params": params, "opt": opt_state})
            if preempt.preempted:
                if main:
                    print("[train] preemption: flushing checkpoint", flush=True)
                if ckpt is not None:
                    ckpt.save(step_idx + 1, {"params": params, "opt": opt_state})
                break
        if ckpt is not None:
            ckpt.wait()
    finally:
        prefetch.close()
        preempt.restore()
    summary = {"final_loss": _scalar(metrics.get("loss", float("nan"))),
               "straggler_flags": straggler.flags, "start_step": start_step,
               "losses": [_scalar(x) for x in losses], "step_s": step_s,
               "arch": spec.name, "device": str(device), "main": main}
    state = {"model": model, "params": params, "opt_state": opt_state,
             "step_fn": step_fn, "data": data, "device": device, "mesh": mesh}
    return summary, state


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    owned = not dist.is_initialized()
    try:
        summary, _ = run(args)
    except NoCudaCardError as e:
        raise SystemExit(f"train: {e}") from None
    finally:
        if owned and dist.is_initialized():  # the group this run started
            dist.destroy_process_group()
    if summary["main"]:
        print(json.dumps({"final_loss": summary["final_loss"],
                          "straggler_flags": summary["straggler_flags"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
