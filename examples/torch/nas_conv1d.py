"""Paper-faithful end-to-end NAS (Listing 3 of the paper) on the port: the
JAX package's ``examples/nas_conv1d.py``.  A 1-D conv classifier over a
sensor stream, with the pre-processing design space searched jointly,
staged criteria (hard param budget -> accuracy objective + hardware-in-
the-loop latency soft constraint), TPE sampler + successive-halving
pruning, and final deployment through the generator pipeline.

    PYTHONPATH=src python examples/torch/nas_conv1d.py --trials 15               # on the card
    PYTHONPATH=src python examples/torch/nas_conv1d.py --device cpu --trials 4 --train-steps 20

Training (``val_accuracy``) runs on ``--device``, the latency on the
target's device (``--target``: ``h100`` on the card, ``host_cpu`` with
``--device cpu``); the study is stored in
``results/nas_conv1d_study.jsonl``.  The search space is the reference's
``SPACE_YAML`` as a mapping (the card's machine has no PyYAML;
``tests/test_torch_examples.py`` holds the two equal).  The winner is
rebuilt, its weights drawn from a generator seeded 0, generated for the
target and timed (``HardwareManager.benchmark``); its FLOPs are the
counted forward's (``program_cost``), and whether it fits the chip's
memory is read from the peak the generate measured on the card, or the
counted peak on the CPU, which keeps no allocator statistics.

``main(argv)`` returns what it printed as a dict; ``make_runner``,
``run_study`` and ``deploy`` take other estimators or a study for the
tests.
"""
import argparse

import torch

from repro_torch.core.builder import ModelBuilder
from repro_torch.core.space import parse_search_space
from repro_torch.core.translate import sample_architecture
from repro_torch.data.pipeline import SyntheticClassificationData
from repro_torch.evaluation import (
    CompiledLatencyEstimator,
    CriteriaRunner,
    OptimizationCriteria,
    ParamCountEstimator,
    TrainedAccuracyEstimator,
)
from repro_torch.hwgen.generator import HardwareManager, TorchGenerator, program_cost
from repro_torch.search.pruners import SuccessiveHalvingPruner
from repro_torch.search.samplers import TPESampler
from repro_torch.search.study import Study

# Listing 3, with the paper's pre-processing space (§IV-E) attached.
SPACE = {
    "input": [4, 1250],
    "output": 6,
    "sequence": [
        {"block": "features", "op_candidates": "conv-block",
         "type_repeat": {"type": "vary_all", "depth": [1, 2, 3, 4, 5, 6]}},
        {"block": "head", "op_candidates": "linear", "linear": {"width": [32, 64, 128]}},
    ],
    "default_op_params": {"conv1d": {"kernel_size": [3, 5], "out_channels": [8, 16]}},
    "composites": {"conv-block": {"sequence": [
        {"block": "conv", "op_candidates": "conv1d"},
        {"block": "pool", "op_candidates": ["maxpool", "identity"]},
    ]}},
    "preprocessing": {"normalize": {"kind": ["zscore", "minmax"]},
                      "downsample": {"factor": [1, 2]}},
}
STORAGE = "results/nas_conv1d_study.jsonl"


def default_target(device: str) -> str:
    return "host_cpu" if device == "cpu" else "h100"


def make_data():
    return SyntheticClassificationData(n=480, length=1250, channels=4, classes=6).split()


def make_runner(target: str, train_steps: int, device: str, accuracy=None,
                latency=None) -> CriteriaRunner:
    """The reference's staged criteria: parameters (hard, 2e6), the trained
    validation accuracy (objective, maximized) and the latency at batch 8
    on ``target`` (soft, 0.050 s, weight 0.5).  ``accuracy`` and
    ``latency`` replace the two estimators."""
    return CriteriaRunner([
        OptimizationCriteria(ParamCountEstimator(), kind="hard_constraint", limit=2e6),
        OptimizationCriteria(accuracy or TrainedAccuracyEstimator(steps=train_steps,
                                                                  device=device),
                             kind="objective", direction="maximize", weight=1.0),
        OptimizationCriteria(latency or CompiledLatencyEstimator(target, batch=8),
                             kind="soft_constraint", limit=0.050, weight=0.5),
    ])


def run_study(space, builder, runner, data, trials: int, allowed=None, storage=STORAGE,
              name: str = "nas-conv1d", models=None) -> Study:
    """TPE (seed 0, 5 startup trials) with successive halving over
    ``space``, sampling only the ``allowed`` ops; ``models`` (a dict), if
    given, receives each trial's built candidate by number."""
    def objective(trial):
        arch = sample_architecture(space, trial, allowed_ops=allowed)
        model = builder.build(arch)
        if models is not None:
            models[trial.number] = model
        trial.set_user_attr("signature", arch.signature())
        return runner.evaluate(model, context={"data": data, "trial": trial}, trial=trial)

    study = Study(
        name=name,
        sampler=TPESampler(seed=0, n_startup=5),
        pruner=SuccessiveHalvingPruner(min_resource=20, reduction_factor=2),
        storage=storage,
    )
    study.optimize(objective, trials)
    return study


def deploy(space, builder, generator: TorchGenerator, best) -> dict:
    """Paper §VI mode 1: the winner rebuilt, its weights drawn from a
    generator seeded 0 on the target's device, generated and timed at
    batch 8."""
    model = builder.build(sample_architecture(space, best))
    device = generator.target.device
    model.init(torch.Generator(device).manual_seed(0), device=device)
    x = torch.zeros((8, 1250, 4))
    artifact = generator.generate(model, (x,))
    bench = HardwareManager().benchmark(artifact)
    cost = program_cost(model, (x,))
    peak = artifact.memory.get("peak_bytes_per_device", cost.peak_bytes)
    return {"latency_s": bench["latency_s"], "flops": cost.flops, "peak_bytes": peak,
            "fits_memory": peak <= generator.target.chip.hbm_bytes}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=12)
    p.add_argument("--train-steps", type=int, default=40)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--target", default=None,
                   help="default h100 on the card, host_cpu with --device cpu")
    args = p.parse_args(argv)
    target = args.target or default_target(args.device)

    space = parse_search_space(SPACE)
    # reflection (paper §VI): only ops the deployment backend supports
    generator = TorchGenerator(target)
    allowed = generator.supported_ops()
    builder = ModelBuilder(space.input_shape, space.output_dim)
    runner = make_runner(target, args.train_steps, args.device)
    study = run_study(space, builder, runner, make_data(), args.trials, allowed=allowed)

    best = study.best_trial
    print(f"\nbest trial #{best.number}: score={best.values[0]:.4f} "
          f"acc={best.user_attrs.get('val_accuracy'):.3f} "
          f"latency={best.user_attrs.get('latency_s', float('nan')) * 1e3:.2f} ms")
    print("arch:", best.user_attrs["signature"])

    deployed = deploy(space, builder, generator, best)
    print(f"deployed artifact: measured latency {deployed['latency_s'] * 1e3:.2f} ms, "
          f"flops={deployed['flops']:,.0f}, fits_memory={deployed['fits_memory']}")
    return {"target": target, "best": {"number": best.number, "values": list(best.values),
                                       "user_attrs": dict(best.user_attrs)},
            "deployed": deployed}


if __name__ == "__main__":
    main()
