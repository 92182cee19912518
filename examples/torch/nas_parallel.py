"""Parallel, cache-aware hardware-in-the-loop NAS via the Explorer facade
(the JAX package's ``examples/nas_parallel.py`` on the port).

The same staged-criteria search runs twice, serial and then on a
parallel executor backend, from two :class:`ExperimentSpec`s that differ
only in their ``executor:`` block, and the two
:class:`ExplorationReport`s are compared:

  * the facade composes ``ParallelStudy`` + the executor + one shared
    ``EvaluationCache`` from the spec, so the latency and memory
    estimators generate each distinct candidate once, across all workers;
  * with ``--cache-dir`` the values also persist to a disk store, so a
    re-run (or the process workers, which each build their own in-memory
    cache) generates each architecture at most once per host;
  * at a fixed seed both runs must find the identical best trial
    (per-trial sampler RNG streams, tell-in-trial-order): asserted.

    PYTHONPATH=src python examples/torch/nas_parallel.py --trials 24 --workers 4   # on the card
    PYTHONPATH=src python examples/torch/nas_parallel.py --device cpu --tiny --trials 8
    PYTHONPATH=src python examples/torch/nas_parallel.py --backend process \\
        --trials 12 --workers 2 --cache-dir results/cache

The reference's spec names ``target: host_cpu``; here the target is
``h100`` on the card and ``host_cpu`` with ``--device cpu``
(``--target``).  The latency is ``metric: modelled`` (counted on
``meta``, nothing run); ``peak_bytes`` is measured on the card and
counted on the CPU.  ``--backend process`` spawns its workers, which
start with the parent's fp32 numerics flags
(``search/executors.py::numerics_flags``).  The search spaces are the
reference's ``SPACE_YAML`` and ``TINY_SPACE_YAML`` as mappings (the
card's machine has no PyYAML; ``tests/test_torch_examples.py`` holds
them equal).

``main(argv)`` returns what it printed as a dict.
"""
import argparse

from repro_torch import Explorer, ExperimentSpec

SPACE = {
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
        {"block": "pool", "op_candidates": ["maxpool", "identity"]},
    ]}},
    "preprocessing": {"normalize": {"kind": ["zscore", "minmax"]}},
}

# compact variant for smoke runs
TINY_SPACE = {
    "input": [2, 128],
    "output": 4,
    "sequence": [
        {"block": "features", "op_candidates": "conv1d",
         "conv1d": {"kernel_size": [3, 5], "out_channels": [8]}},
        {"block": "head", "op_candidates": "linear", "linear": {"width": [16, 32]}},
    ],
}


def default_target(device: str) -> str:
    return "host_cpu" if device == "cpu" else "h100"


def make_spec(args, tag: str, backend: str, n_workers: int,
              n_trials: int = None, seed: int = None) -> ExperimentSpec:
    """One declarative experiment; serial and parallel runs differ only
    in the ``executor`` block (and their name/report artifact)."""
    return ExperimentSpec.from_dict({
        "name": f"nas-parallel-{tag}",
        "search_space": TINY_SPACE if args.tiny else SPACE,
        "sampler": {"name": "random", "seed": args.seed if seed is None else seed},
        "executor": {"backend": backend, "n_workers": n_workers},
        # sliding_window streams tells as evaluations finish (no batch
        # barrier); with the random sampler "auto" picks it anyway
        "schedule": {"mode": args.schedule, "tell_order": "completion"},
        # hard memory budget -> latency objective; the shared cache means
        # the two compiled estimators generate ONE artifact per candidate
        "criteria": [
            {"estimator": "n_params", "kind": "hard_constraint", "limit": 1e6},
            {"estimator": "peak_bytes", "kind": "soft_constraint",
             "limit": 64e6, "weight": 0.1, "params": {"batch": 8}},
            {"estimator": "latency_s", "kind": "objective",
             "params": {"batch": 8, "metric": "modelled"}},
        ],
        "target": args.target,
        "cache": {"dir": args.cache_dir},
        "budget": {"n_trials": args.trials if n_trials is None else n_trials},
        "report_dir": "results",
    })


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=24)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=("serial", "thread", "process"), default="thread",
                   help="executor backend for the parallel run")
    p.add_argument("--cache-dir", default=None,
                   help="disk-persistent value store (e.g. results/cache); "
                        "re-runs and process workers then skip every generate "
                        "the host already paid for")
    p.add_argument("--schedule", choices=("auto", "batch", "sliding_window"),
                   default="auto",
                   help="trial scheduler: sliding_window streams asks/tells "
                        "as slots free; batch re-creates the legacy barrier")
    p.add_argument("--tiny", action="store_true",
                   help="use the compact smoke-test search space")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--target", default=None,
                   help="default h100 on the card, host_cpu with --device cpu")
    return p


def run(args):
    """The untimed warm-up, then the serial and the parallel exploration:
    ``(serial_explorer, serial_report, parallel_explorer, parallel_report)``."""
    # untimed warmup so the serial run doesn't absorb one-time imports,
    # allocator and library start-up, and skew the speedup
    Explorer.from_spec(make_spec(args, "warmup", "serial", 1, n_trials=1, seed=999),
                       device=args.device).run(save_report=False)
    sx = Explorer.from_spec(make_spec(args, "serial", "serial", 1), device=args.device)
    serial = sx.run()
    px = Explorer.from_spec(make_spec(args, args.backend, args.backend, args.workers),
                            device=args.device)
    par = px.run()
    return sx, serial, px, par


def summarize(args, serial, par) -> dict:
    """Print the two runs side by side and assert that they found the same
    best trial; returns what was printed."""
    print(f"\nserial:   {serial.n_trials} trials in {serial.wall_clock_s:.1f}s "
          f"({serial.n_trials / serial.wall_clock_s:.2f} trials/s, "
          f"cache {serial.cache})")
    print(f"{args.backend}: {par.n_trials} trials in {par.wall_clock_s:.1f}s "
          f"({par.n_trials / par.wall_clock_s:.2f} trials/s, cache {par.cache})")
    caveat = (
        "cache-assisted: both runs share the persistent store, so this measures "
        "disk-cache reuse, not the executor backend"
        if args.cache_dir else
        "same-process runs share warm allocator and library state"
    )
    speedup = serial.wall_clock_s / par.wall_clock_s
    print(f"speedup: {speedup:.2f}x with {args.workers} {args.backend} workers ({caveat})")

    bs, bp = serial.best, par.best
    print(f"\nserial best        #{bs['number']}: score={bs['values'][0]:.3e}")
    print(f"{args.backend} best #{bp['number']}: score={bp['values'][0]:.3e}")
    assert bs["values"] == bp["values"], "fixed seed + modelled latency must reproduce"
    print("arch:", bp["signature"])
    print("reports:", serial.artifact, "+", par.artifact)
    return {"target": args.target, "backend": args.backend,
            "serial": {"n_trials": serial.n_trials, "wall_clock_s": serial.wall_clock_s,
                       "cache": serial.cache, "best": bs, "artifact": serial.artifact},
            "parallel": {"n_trials": par.n_trials, "wall_clock_s": par.wall_clock_s,
                         "cache": par.cache, "best": bp, "artifact": par.artifact},
            "speedup": speedup}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.trials < 1:
        raise SystemExit("--trials must be >= 1")
    args.target = args.target or default_target(args.device)
    _, serial, _, par = run(args)
    return summarize(args, serial, par)


if __name__ == "__main__":
    main()
