"""Multi-pod dry run, the JAX package's ``launch/dryrun.py`` on the port:
every (arch x shape x mesh) cell's step laid out on the production mesh
and counted, without a card::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--opt]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
        --shape train_4k --units 8   # the first 8 of its 40 layers

The reference spoofs 512 host devices and lowers and compiles each cell's
``jax.jit`` step.  The port compiles nothing (the counting is
:mod:`repro_torch.hwgen.sharded`, which the generator's sharded path
shares): :func:`main` starts the fake
process group (``torch.testing._internal.distributed.fake_pg``, every
collective returns at once) at 256 or 512 ranks, this process being rank
0, builds ``make_production_mesh`` on it, lays the model out on the
``meta`` device in bf16 (no memory is allocated), places parameters,
AdamW state, the batch of ``input_specs`` and the decode cache
(``cache_axes``) as DTensors with the resolver's placements, and runs the
train, prefill or decode step of ``train/step.py`` once inside
``sharding_context``.  DTensor issues its collectives and its local ops
as it would on 256 cards; counters below watch them.

How each count of the record is taken, and what it cannot match:

* ``memory.argument_bytes``: the bytes of every argument's local shard
  (parameters, optimizer state, batch, cache), exact.
  ``param_bytes_per_device`` and ``opt_bytes_per_device`` split it.
* ``memory.peak_bytes_per_device``: the peak of
  ``torch.distributed._tools.mem_tracker.MemTracker`` over the step, on
  ``meta``: every tensor alive at once, arguments included.  XLA's
  memory analysis (arguments + outputs + temporaries, buffers reused
  after its scheduling) has no DTensor twin.
* ``collectives``, ``collective_bytes``:
  :class:`repro_torch.hwgen.collectives.CollectiveCounter`, operand bytes
  by kind, as the reference's HLO parser counts them.  DTensor chooses
  other collectives than XLA's SPMD partitioner: a ``(Partial,
  Partial)`` result is replicated by two all-reduces, and a reshard
  between two ``Shard`` dims on a ``cpu`` mesh (every mesh over the fake
  group) is an all-gather and a chunk, not the all-to-all NCCL would run:
  ``alltoall_as_allgather`` counts those in a record.
* ``cost.flops``: the local ops' operations by
  ``torch.utils.flop_counter``'s formulas (matrix products, attention),
  counted once on the local shards: an op on DTensors is passed down to
  the local ops DTensor runs, which are the ones counted (a
  ``FlopCounterMode`` around a DTensor step counts both the global op and
  its local one).  ``cost.bytes_accessed``: each local op's inputs read
  and outputs written once (views and ``empty`` move nothing), an
  unfused upper bound where XLA fuses.  ``cost.transcendentals``: the
  output elements of exp, log, tanh, sigmoid and the like.  Every layer
  is counted (``cost_mode: "full"``); the reference lowers two depths and
  extrapolates, because XLA's unrolled compiles are slow.  The port
  extrapolates only where an sLSTM time loop makes full depth too slow on
  the host (:func:`run_cell`).

``trace_s`` (placing and running the step) stands where the reference has
``lower_s`` and ``compile_s``; ``model_flops`` is
``evaluation/model_flops.py``'s global count for the cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs
from repro_torch.distributed.sharding import (default_rules, distribute_model,
                                               shapes_shardings_from_axes)
from repro_torch.evaluation.model_flops import model_flops
from repro_torch.hwgen.collectives import total_collective_bytes
from repro_torch.hwgen import sharded
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import Optimizer, OptimizerConfig
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

DEFAULT_OUT = "results/dryrun"

# per-arch microbatch counts for the train_4k cell (activation memory)
TRAIN_MICROBATCHES = {
    "nemotron-4-340b": 8,
    "dbrx-132b": 4,
    "arctic-480b": 4,
    "whisper-medium": 2,
}

# Layer-pattern period (archs whose layer list repeats in units > 1:
# zamba2 = 6 mamba + 1 shared attn; xlstm = 7 mLSTM + 1 sLSTM).
PATTERN_UNITS = {
    "zamba2-2.7b": 7,
    "xlstm-1.3b": 8,
}

def _cell_id(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def _slice_units(spec, arch_name: str, k: int):
    """Keep the first k layer-pattern units (a cut for tests)."""
    unit = PATTERN_UNITS.get(arch_name, 1)
    layers = tuple(spec.layers[: unit * k])
    enc = tuple(spec.encoder_layers[:k]) if spec.encoder_layers else ()
    return dataclasses.replace(spec, layers=layers, encoder_layers=enc)


def _map_sub_cfg(layers, kinds, **fields):
    out = []
    for layer in layers:
        subs = tuple(
            dataclasses.replace(s, cfg=dataclasses.replace(s.cfg, **fields))
            if s.kind in kinds else s
            for s in layer.subs
        )
        out.append(dataclasses.replace(layer, subs=subs))
    return tuple(out)


def _map_attention_cfg(layers, **fields):
    return _map_sub_cfg(layers, ("attention",), **fields)


def _map_moe_cfg(layers, **fields):
    return _map_sub_cfg(layers, ("moe",), **fields)


def apply_variant(spec, variant):
    """§Perf hillclimb knobs, applied on top of the baseline spec.

    Comma-separated flags: chunked_attn | remat_dots | no_remat | moe_2d |
    seq_shard | kvcN.  (chunked_loss, last_logit and mbN are step knobs
    handled in build_cell.)
    """
    if "chunked_attn" in variant:
        spec = dataclasses.replace(
            spec,
            layers=_map_attention_cfg(spec.layers, impl="xla_chunked"),
            encoder_layers=_map_attention_cfg(spec.encoder_layers, impl="xla_chunked"),
        )
    if "remat_dots" in variant:
        spec = dataclasses.replace(spec, remat_policy="dots")
    if "no_remat" in variant:
        spec = dataclasses.replace(spec, remat=False)
    if "moe_2d" in variant:
        spec = dataclasses.replace(spec, layers=_map_moe_cfg(spec.layers, shard_ff=True))
    if "seq_shard" in variant:
        spec = dataclasses.replace(
            spec,
            layers=_map_attention_cfg(spec.layers, seq_shard=True),
            encoder_layers=_map_attention_cfg(spec.encoder_layers, seq_shard=True),
        )
    for flag in variant.split(","):
        if flag.startswith("kvc") and flag[3:].isdigit():
            kvc = int(flag[3:])
            spec = dataclasses.replace(
                spec,
                layers=_map_attention_cfg(spec.layers, kv_chunk=kvc),
                encoder_layers=_map_attention_cfg(spec.encoder_layers, kv_chunk=kvc),
            )
    return spec


def _distribute(tree, axes_tree, mesh, rules):
    """A tree (dicts, lists) of ``meta`` tensors as DTensors with the
    placements their logical axes resolve to on ``mesh``."""
    return sharded.distribute(tree, shapes_shardings_from_axes(tree, axes_tree, mesh, rules),
                              mesh)


def _drawn(t, vocab: int, generator):
    """A ``meta`` input as values on the generator's device: token ids
    below ``vocab``, activations from a normal; ``t`` itself without one."""
    if generator is None:
        return t
    if t.is_floating_point():
        return torch.randn(t.shape, dtype=t.dtype, device=generator.device, generator=generator)
    return torch.randint(0, vocab, t.shape, dtype=t.dtype, device=generator.device,
                         generator=generator)


def build_cell(arch_name: str, shape_name: str, multi_pod: bool, *, overrides=None,
               n_units=None, variant="", device="meta"):
    """(step_fn, args, mesh, meta): the cell's step and its arguments placed
    on the production mesh as DTensors over ``meta`` tensors.  Needs a
    process group of at least the mesh's ranks (:func:`repro_torch.hwgen.sharded.start_fake_group`).
    Another ``device`` (a card, to hold the counts against it) draws the
    weights and the batch there from a generator seeded 0."""
    arch = get_arch(arch_name)
    cell = SHAPES[shape_name]
    spec = arch.spec(long_context=cell.long_context)
    if variant:
        spec = apply_variant(spec, variant)
    if n_units is not None:
        spec = _slice_units(spec, arch_name, n_units)
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    # typed as the cards' mesh, so that DTensor issues the collectives it
    # would issue over NCCL (on a cpu mesh a Shard -> Shard reshard is an
    # all-gather and a chunk, as the CPU groups have no all-to-all)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    rules = default_rules(mesh)
    # the skeleton on meta in bf16, as the reference's model.init(dtype=bfloat16)
    gen = None if device == "meta" else torch.Generator(device).manual_seed(0)
    model = LM(spec).init(gen, torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    meta = {"n_params": n_params, "mesh_shape": tuple(int(n) for n in mesh.shape),
            "seq": cell.seq, "batch": cell.batch, "kind": cell.kind,
            "model_flops": model_flops(spec, cell.kind, cell.batch, cell.seq)}

    cache = None
    if cell.kind == "decode":
        enc_out = None
        if arch.batch_kind == "encdec":
            enc_out = _drawn(torch.empty((cell.batch, arch.enc_context, spec.d_model),
                                         dtype=torch.bfloat16, device="meta"), spec.vocab, gen)
        with torch.no_grad():
            cache = model.init_cache(cell.batch, cell.seq, torch.bfloat16, enc_out=enc_out)
        cache = _distribute(cache, model.cache_axes(), mesh, rules)
    params = distribute_model(model, mesh, rules)
    meta["param_bytes_per_device"] = sharded.local_bytes(params)
    batch, batch_axes = input_specs(arch, cell, spec)
    batch = _distribute({k: _drawn(v, spec.vocab, gen) for k, v in batch.items()},
                        batch_axes, mesh, rules)

    if cell.kind == "train":
        microbatches = TRAIN_MICROBATCHES.get(arch_name, 1)
        for flag in variant.split(","):
            if flag.startswith("mb") and flag[2:].isdigit():
                microbatches = int(flag[2:])
        opt = Optimizer(OptimizerConfig(name="adamw"))
        opt_state = opt.init(params)
        meta["opt_bytes_per_device"] = sharded.local_bytes(opt_state)
        loss_chunk = 1024 if "chunked_loss" in variant else 0
        step = make_train_step(model, opt, microbatches=microbatches, loss_chunk=loss_chunk)
        meta["microbatches"] = microbatches
        return step, (params, opt_state, batch), mesh, meta

    if cell.kind == "prefill":
        step = make_prefill_step(model, last_only="last_logit" in variant)
        return step, (params, batch), mesh, meta

    step = make_decode_step(model)
    return step, (params, cache, batch["tokens"], cell.seq - 1), mesh, meta


def _count(step, args, mesh, with_cost: bool) -> dict:
    """:func:`repro_torch.hwgen.sharded.count` as the dry run's records
    have it: with DTensor's one-time sharding propagation ops (ROADMAP)."""
    return sharded.count(step, args, mesh, with_cost, _with_propagation=True)


def _time_loop(arch_name: str, shape_name: str) -> bool:
    """Whether the cell runs an sLSTM time loop over a whole sequence (a
    train or prefill step of a spec with sLSTM blocks): some 20 ops a step
    on the host, each a Python meta kernel, for 4,096 or 32,768 steps a
    layer, which makes the full depth too slow to count (tens of minutes
    a layer)."""
    cell = SHAPES[shape_name]
    spec = get_arch(arch_name).spec(long_context=cell.long_context)
    return cell.kind != "decode" and any(
        sub.kind == "slstm" for layer in spec.layers for sub in layer.subs)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, *, with_cost: bool = True,
             overrides=None, variant: str = "", n_units=None) -> dict:
    """The cell's record (see the module docstring).  Needs a process group
    of at least the mesh's ranks (:func:`repro_torch.hwgen.sharded.start_fake_group`).

    Every layer is counted (``cost_mode: "full"``), but in a cell with an
    sLSTM time loop (:func:`_time_loop`) at full depth: there the step runs
    at 0 and 1 layer-pattern units and its counts are extrapolated, as the
    reference extrapolates its cost lowering (per-unit counts are exactly
    additive): q(units) = q(0) + units * (q(1) - q(0)).  Its peak is the
    one-unit step's peak plus the arguments the other units add
    (``peak_mode``), since a peak does not add up by layer."""
    mesh_name = "multi" if multi_pod else "single"
    record = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "cell": _cell_id(arch_name, shape_name, mesh_name),
        "variant": variant or "baseline",
    }
    arch = get_arch(arch_name)
    cell = SHAPES[shape_name]
    ok, reason = arch.cell_supported(cell)
    if not ok:
        record.update(status="skipped", reason=reason)
        return record

    t0 = time.time()
    kwargs = dict(overrides=overrides, variant=variant)
    step, args, mesh, meta = build_cell(arch_name, shape_name, multi_pod, n_units=n_units,
                                        **kwargs)
    record.update(meta)
    argument_bytes = sharded.local_bytes(args)
    if n_units is not None or not _time_loop(arch_name, shape_name):
        counted = _count(step, args, mesh, with_cost)
        record["cost_mode"] = "full"
        peak = counted["peak"]
    else:
        unit = PATTERN_UNITS.get(arch_name, 1)
        units = len(arch.spec(long_context=cell.long_context).layers) // unit
        del step, args
        measures = []
        for k in (0, 1):
            step, args, mesh, _ = build_cell(arch_name, shape_name, multi_pod, n_units=k,
                                             **kwargs)
            measures.append(_count(step, args, mesh, with_cost))
            one_unit_args = sharded.local_bytes(args)
            del step, args

        m0, m1 = measures
        counted = sharded.extrapolate(m0, m1, units)
        record["cost_mode"] = f"extrapolated(k=(0,1),units={units},unit={unit})"
        peak = m1["peak"] + argument_bytes - one_unit_args
        record["peak_mode"] = "one unit's peak plus the other units' arguments"
    record["trace_s"] = round(time.time() - t0, 2)
    record["memory"] = {"argument_bytes": argument_bytes, "peak_bytes_per_device": peak}
    record["collectives"] = counted["collectives"]
    record["collective_bytes"] = total_collective_bytes(counted["collectives"])
    if with_cost:
        record["cost"] = counted["cost"]
    record["status"] = "ok"
    record["total_s"] = round(time.time() - t0, 2)
    return record


def optimized_variant(arch_name: str, shape_name: str) -> str:
    """The beyond-paper optimized configuration per cell kind (§Perf):
    derived from the three hillclimbs and applied table-wide."""
    cell = SHAPES[shape_name]
    v = []
    if cell.kind == "train":
        v += ["chunked_loss", "remat_dots", "seq_shard"]
    elif cell.kind == "prefill":
        v += ["chunked_attn", "last_logit", "seq_shard"]
    if get_arch(arch_name).family == "moe":
        v.append("moe_2d")
    return ",".join(v)


def all_cells():
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                yield arch, shape, mesh


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Multi-pod dry run: place and count every (arch x shape x mesh) cell")
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=[*SHAPES, None])
    p.add_argument("--mesh", default="single", choices=["single", "multi"])
    p.add_argument("--all", action="store_true", help="run every cell via subprocesses (resumable)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--no-cost", action="store_true")
    p.add_argument("--variant", default="", help="comma-separated §Perf knobs: chunked_attn,chunked_loss,remat_dots,seq_shard,moe_2d,last_logit,mbN,kvcN")
    p.add_argument("--opt", action="store_true",
                   help="with --all: use the optimized per-kind variant for every cell")
    p.add_argument("--timeout", type=int, default=3600)
    p.add_argument("--units", type=int, default=None,
                   help="count only the first N layer-pattern units (a depth cut)")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)

    if args.all:
        failures = 0
        for arch, shape, mesh in all_cells():
            if args.opt and mesh == "multi":
                continue  # optimized table is single-pod (§Roofline)
            variant = optimized_variant(arch, shape) if args.opt else args.variant
            suffix = f"__{variant.replace(',', '+')}" if variant else ""
            path = os.path.join(args.out, _cell_id(arch, shape, mesh) + suffix + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh, "--out", args.out]
            if variant:
                cmd += ["--variant", variant]
            # §Roofline is single-pod only; the multi-pod pass proves the
            # "pod" axis shards (placement, collectives, memory), so skip
            # the cost counters there.
            if args.no_cost or mesh == "multi":
                cmd.append("--no-cost")
            print(f"[dryrun] {arch} x {shape} x {mesh}", flush=True)
            try:
                r = subprocess.run(cmd, timeout=args.timeout)
                if r.returncode != 0:
                    failures += 1
            except subprocess.TimeoutExpired:
                failures += 1
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                               "status": "timeout"}, f)
        print(f"[dryrun] complete, failures={failures}")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        p.error("--arch/--shape required (or --all)")
    suffix = f"__{args.variant.replace(',', '+')}" if args.variant else ""
    suffix += f"__units{args.units}" if args.units is not None else ""
    path = os.path.join(args.out, _cell_id(args.arch, args.shape, args.mesh) + suffix + ".json")
    import torch.distributed as dist

    try:
        sharded.start_fake_group(512 if args.mesh == "multi" else 256)
        try:
            record = run_cell(args.arch, args.shape, args.mesh == "multi",
                              with_cost=not args.no_cost, variant=args.variant,
                              n_units=args.units)
        finally:
            dist.destroy_process_group()
    except Exception:
        record = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "status": "error", "traceback": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    status = record.get("status")
    print(json.dumps({k: v for k, v in record.items() if k not in ("collectives", "traceback")},
                     default=str))
    if status == "error":
        print(record["traceback"][-2000:], file=sys.stderr)
    return 0 if status in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
