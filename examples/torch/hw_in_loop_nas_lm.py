"""Hardware-in-the-loop NAS over LM backbones for an H100 pod (the JAX
package's ``examples/hw_in_loop_nas_lm.py`` on the port).

The paper's §VI mode-2 workflow scaled to the assigned architectures: the
search space ranges over pod-scale LM backbones (block kind, depth, width,
experts), the generator lays every candidate out on the production mesh
(bf16 parameters sharded by the default rules, the token batch over
``data``), and the counted per-device peak and roofline feed back into the
study: the peak against the card's 80 GB is a hard constraint, the
roofline bound per token the objective.

    PYTHONPATH=src python examples/torch/hw_in_loop_nas_lm.py --trials 8
    PYTHONPATH=src python examples/torch/hw_in_loop_nas_lm.py --target h100_2pod
    PYTHONPATH=src python examples/torch/hw_in_loop_nas_lm.py --target h100 --trials 4

``h100_pod`` (256 cards, the default) and ``h100_2pod`` (512) need no
card: the program runs once on the ``meta`` device over the fake process
group (``TorchGenerator.generate(in_shardings=)``), counted at 1 and 2
layers and extrapolated to the candidate's depth
(``TorchGenerator.generate_by_units``, which equals the count of every
layer for each block kind: ``tests/test_torch_pod.py``).  The reference needs 256 spoofed devices for its pod target and
falls back to a host target on a reduced shape without them; ``--target
h100`` is that fallback on the card: sequence 128, batch 2, the candidate
drawn from seed 0 in fp32, placed, run and timed (CUDA events), its
measured latency per token the objective.  There a candidate whose fp32
parameters alone pass the card's memory ends by the hard constraint
before anything is placed.

Each trial prints a ``trial {...}`` JSON line; the last line is the best
trial's JSON.
"""
import argparse
import dataclasses
import json
import time

import torch

from repro_torch.distributed.sharding import (default_rules, params_shardings,
                                               shapes_shardings_from_axes)
from repro_torch.hwgen.generator import HardwareManager, TorchGenerator
from repro_torch.hwgen.targets import get_target
from repro_torch.models.lm import LM
from repro_torch.models.specs import LayerSpec, ModelSpec, SubBlock, moe_layer, transformer_layer
from repro_torch.nn.ssm import Mamba2Config
from repro_torch.search.samplers import TPESampler
from repro_torch.search.study import HardConstraintViolated, Study
from repro_torch.train.step import call, param_dict

# the reference's search space
D_MODELS = (1024, 2048, 4096)
DEPTHS = (8, 16, 24)
VOCAB = 32000


def sample_spec(trial, d_models=D_MODELS, depths=DEPTHS, vocab=VOCAB) -> ModelSpec:
    """The reference's ``sample_spec``: the same suggestions in the same
    order (``d_models``, ``depths`` and ``vocab`` cut the space for a test
    at narrow widths)."""
    d_model = trial.suggest_categorical("d_model", list(d_models))
    n_layers = trial.suggest_categorical("n_layers", list(depths))
    kind = trial.suggest_categorical("block_kind", ["dense", "moe", "mamba2"])
    heads = max(d_model // 128, 1)
    if kind == "dense":
        ff_mult = trial.suggest_categorical("ff_mult", [3, 4])
        layer = transformer_layer(d_model, heads, max(heads // 2, 1), ff_mult * d_model)
    elif kind == "moe":
        experts = trial.suggest_categorical("experts", [8, 16])
        layer = moe_layer(d_model, heads, max(heads // 2, 1), 2 * d_model,
                          n_experts=experts, top_k=2)
    else:
        layer = LayerSpec(subs=(SubBlock("mamba2", Mamba2Config(d_model)),))
    return ModelSpec(name=f"nas-{kind}", d_model=d_model, vocab=vocab,
                     layers=(layer,) * n_layers,
                     positional="none" if kind == "mamba2" else "rope")


class _Answers:
    """A trial that answers each suggestion from a finished trial's params."""

    def __init__(self, params):
        self.params = params

    def suggest_categorical(self, name, choices):
        return self.params[name]


def spec_from_params(params, **cut) -> ModelSpec:
    """The backbone a trial with these params sampled (the winner, rebuilt)."""
    return sample_spec(_Answers(params), **cut)


def with_depth(spec: ModelSpec, n_layers: int) -> ModelSpec:
    return dataclasses.replace(spec, layers=spec.layers[:1] * n_layers)


def sharded_program(spec: ModelSpec, target, batch: int, seq: int):
    """``(fn, example_args, in_shardings)``: the LM's forward on ``meta``
    (bf16 parameters, int32 tokens, as the reference's
    ``eval_shape(init, dtype=bfloat16)``), each parameter's
    ``PartitionSpec`` from its logical axes and the tokens' from
    ``("batch", None)`` under the default rules of the target's mesh."""
    model = LM(spec).init(None, torch.bfloat16)
    params = param_dict(model)
    mesh = dict(zip(target.mesh_axes, target.mesh_shape))
    rules = default_rules(mesh)
    tokens = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    tok_sh = shapes_shardings_from_axes({"t": tokens}, {"t": ("batch", None)}, mesh, rules)["t"]
    return ((lambda p, t: call(model, p, "forward", t)), (params, tokens),
            (params_shardings(model, mesh, rules), tok_sh))


def counted(gen: TorchGenerator, spec: ModelSpec, batch: int, seq: int):
    """The candidate's artifact on a pod target, counted on the host at 1
    and 2 layers and extrapolated to its depth."""
    return gen.generate_by_units(
        lambda n: sharded_program(with_depth(spec, n), gen.target, batch, seq),
        units=len(spec.layers))


def measured(gen: TorchGenerator, spec: ModelSpec, batch: int, seq: int):
    """(artifact, latency_s) on the card: fp32 weights drawn from seed 0,
    placed, run once (the peak) and timed.  Refused by the hard constraint
    before anything is placed when the parameters alone pass the card's
    memory."""
    weights = sum(p.numel() * p.element_size()
                  for p in LM(spec).init(None, torch.float32).parameters())
    if weights > gen.target.chip.hbm_bytes:
        raise HardConstraintViolated("peak_bytes", weights, gen.target.chip.hbm_bytes)
    device = torch.device(gen.target.device)
    model = LM(spec).init(torch.Generator(device).manual_seed(0), torch.float32)
    tokens = torch.zeros((batch, seq), dtype=torch.int32)
    artifact = gen.generate(model, (tokens,))
    return artifact, HardwareManager().benchmark(artifact)["latency_s"]


def make_objective(gen: TorchGenerator, batch: int, seq: int, value=None,
                   sample=sample_spec, log=print):
    """The study's objective: sample a backbone, count (pod targets) or
    measure (``h100``) it, record what it holds and costs, enforce the hard
    memory constraint and return ``value(artifact)``; by default the
    modelled (pod) or measured (``h100``) step latency per token."""
    pod = gen.target.measurement == "roofline"

    def objective(trial):
        spec = sample(trial)
        t0 = time.perf_counter()
        if pod:
            artifact = counted(gen, spec, batch, seq)
            latency_s, dominant = artifact.roofline.bound_s, artifact.roofline.dominant
        else:
            artifact, latency_s = measured(gen, spec, batch, seq)
            dominant = "measured"
        peak = artifact.memory.get("peak_bytes_per_device", 0)
        row = {"number": trial.number, "params": trial.params,
               "seconds": time.perf_counter() - t0, "peak_gb": peak / 2**30,
               "latency_ms": latency_s * 1e3, "dominant": dominant}
        if pod:
            r = artifact.roofline
            row.update(argument_gb=artifact.memory["argument_bytes"] / 2**30,
                       collective_bytes=artifact.collective_bytes, flops=artifact.flops,
                       bytes_accessed=artifact.bytes_accessed, compute_s=r.compute_s,
                       memory_s=r.memory_s, collective_s=r.collective_s)
        for key in ("peak_gb", "latency_ms", "dominant"):
            trial.set_user_attr(key, row[key])
        log("trial " + json.dumps(row))
        if peak > gen.target.chip.hbm_bytes:
            raise HardConstraintViolated("peak_bytes", peak, gen.target.chip.hbm_bytes)
        if value is not None:
            return value(artifact)
        return latency_s / (batch * seq)

    return objective


def run_study(gen: TorchGenerator, trials: int, batch: int, seq: int, **kwargs) -> Study:
    study = Study(name="hil-lm", sampler=TPESampler(seed=0, n_startup=4))
    study.optimize(make_objective(gen, batch, seq, **kwargs), trials)
    return study


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--target", default="h100_pod", choices=("h100_pod", "h100_2pod", "h100"))
    args = p.parse_args(argv)

    if args.target == "h100":
        args.seq, args.batch = 128, 2
        print("NOTE: target h100; measured on the card at a reduced shape")
    study = run_study(TorchGenerator(get_target(args.target)), args.trials, args.batch, args.seq)
    best = study.best_trial
    if best is None:
        print("no feasible candidate found")
        return 1
    print(json.dumps({
        "best_params": best.params,
        "latency_ms": best.user_attrs["latency_ms"],
        "peak_gb": best.user_attrs["peak_gb"],
        "dominant_term": best.user_attrs["dominant"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
