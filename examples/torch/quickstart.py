"""Quickstart: one experiment -> Explorer.run() -> report + best model (the
JAX package's ``examples/quickstart.py`` on the port).

    PYTHONPATH=src python examples/torch/quickstart.py                # on the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

The declarative front door (paper's unified interface): the experiment
file ``examples/experiments/quickstart.yaml`` names the search space,
sampler, criteria and budget; the Explorer composes the layered API
(``parse_search_space`` + ``ModelBuilder`` + estimators +
``CriteriaRunner`` + ``ParallelStudy`` + executor).  ``hand_wired()`` is
that wiring by hand, which the facade reproduces trial for trial at the
same seed.

The file names no target, so it means ``host_cpu``, whose candidates run
on the CPU; on the card the example sets ``target: h100`` (``--target``)
and goes through ``Explorer.from_spec``.  Both criteria are analytic
(FLOPs and parameters, counted from the architecture), so the trials and
the best trial are the same on either target.  The winner is rebuilt with
``best_model()``, its weights drawn from a ``torch.Generator`` seeded 0 on
the device, and run on ``ones(2, 256, 3)``.

``main(argv)`` returns what it printed as a dict.
"""
import argparse
import copy
import os

import torch

from repro_torch import Explorer, ExperimentSpec

EXPERIMENT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                          "experiments", "quickstart.yaml")

# quickstart.yaml as a mapping, for a machine without PyYAML (the card's);
# tests/test_torch_examples.py holds it equal to the file
QUICKSTART = {
    "name": "quickstart",
    "search_space": {
        "input": [3, 256],
        "output": 4,
        "sequence": [
            {"block": "features", "op_candidates": "conv1d",
             "type_repeat": {"type": "repeat_op", "depth": [1, 2, 3]}},
            {"block": "head", "op_candidates": "linear", "linear": {"width": [16, 32, 64]}},
        ],
        "default_op_params": {"conv1d": {"kernel_size": [3, 5], "out_channels": [8, 16, 32],
                                         "stride": [1, 2]}},
    },
    "sampler": {"name": "tpe", "seed": 0},
    "executor": {"backend": "serial"},
    "criteria": [
        {"estimator": "flops", "kind": "objective", "weight": 1.0},
        {"estimator": "n_params", "kind": "objective", "weight": 0.1},
    ],
    "budget": {"n_trials": 25},
    "report_dir": "results",
}


def experiment_doc() -> dict:
    """``quickstart.yaml``'s mapping: read with PyYAML where it is
    installed, else :data:`QUICKSTART`."""
    try:
        import yaml
    except ImportError:
        return copy.deepcopy(QUICKSTART)
    with open(EXPERIMENT) as f:
        return yaml.safe_load(f)


def default_target(device: str) -> str:
    return "host_cpu" if device == "cpu" else "h100"


def experiment(target: str) -> ExperimentSpec:
    """The experiment at ``target`` (the file's own, ``host_cpu``, unless
    another is named)."""
    doc = experiment_doc()
    if target != "host_cpu":
        doc["target"] = target
    return ExperimentSpec.from_dict(doc)


def hand_wired(trials: int = None):
    """The same experiment through the layered API: the reference wiring
    the facade is sugar over.  Returns the finished study."""
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.space import parse_search_space
    from repro_torch.core.translate import sample_architecture
    from repro_torch.evaluation import FlopsEstimator, ParamCountEstimator
    from repro_torch.search.samplers import TPESampler
    from repro_torch.search.study import Study

    raw = experiment_doc()
    space = parse_search_space(raw["search_space"])
    builder = ModelBuilder(space.input_shape, space.output_dim)
    flops, nparams = FlopsEstimator(), ParamCountEstimator()

    def objective(trial):
        arch = sample_architecture(space, trial)
        model = builder.build(arch)
        trial.set_user_attr("signature", arch.signature())
        # minimize FLOPs subject to an (implicit) param budget via weighted sum
        return flops.estimate(model) + 0.1 * nparams.estimate(model)

    study = Study(name="quickstart", sampler=TPESampler(seed=0))
    study.optimize(objective, raw["budget"]["n_trials"] if trials is None else trials)
    return study


def run_winner(model, device: str, seed: int = 0) -> torch.Tensor:
    """The winner's output on ``ones(2, 256, 3)``; its weights drawn from a
    generator seeded ``seed`` on ``device`` unless it already holds some."""
    if any(p.is_meta for p in model.parameters()):
        model.init(torch.Generator(device).manual_seed(seed), device=device)
    with torch.inference_mode():
        return model(torch.ones((2, 256, 3), device=device))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--target", default=None,
                   help="default h100 on the card, host_cpu with --device cpu")
    args = p.parse_args(argv)
    target = args.target or default_target(args.device)

    explorer = Explorer.from_spec(experiment(target), device=args.device)
    report = explorer.run()

    best = report.best
    print(f"best score {best['values'][0]:,.0f} — {best['signature']}")
    print(f"per-criterion: {report.criteria_values}")
    print(f"report artifact: {report.artifact}")

    # rebuild + run the winning architecture
    model = explorer.best_model()
    y = run_winner(model, args.device)
    print("output:", tuple(y.shape), "| params:", f"{model.n_params:,}")
    print(model.summary())
    return {"target": target, "best": best, "criteria_values": report.criteria_values,
            "artifact": report.artifact, "output_shape": list(y.shape),
            "n_params": model.n_params, "summary": model.summary()}


if __name__ == "__main__":
    main()
