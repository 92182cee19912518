"""Run a YAML experiment from the shell, on the port::

    PYTHONPATH=src python -m repro_torch.explorer spec.yaml            # on the card
    PYTHONPATH=src python -m repro_torch.explorer \
        examples/experiments/quickstart.yaml --device cpu
    PYTHONPATH=src python -m repro_torch.explorer --list-components

Candidates run on CUDA unless ``--device cpu`` is given, and the spec's
target must run on that device (``h100``: cuda, ``host_cpu``: cpu).
Overrides exist for the knobs CI and quick local smoke runs need to
shrink without editing the experiment file.  Sweeps
(``python -m repro.explorer sweep`` in the JAX package) are not ported
yet.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def _run_experiment(argv: List[str]) -> int:
    from repro_torch.explorer.experiment import ExperimentSpec
    from repro_torch.explorer.explorer import Explorer

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explorer",
        description="Run a declarative NAS experiment (YAML) through the Explorer facade.",
    )
    p.add_argument("experiment", help="path to the experiment YAML")
    p.add_argument("--trials", type=int, default=None, help="override budget.n_trials")
    p.add_argument("--backend", default=None, help="override executor.backend")
    p.add_argument("--workers", type=int, default=None, help="override executor.n_workers")
    p.add_argument("--schedule", default=None,
                   choices=("auto", "batch", "sliding_window"),
                   help="override schedule.mode")
    p.add_argument("--tell-order", default=None, choices=("trial", "completion"),
                   help="override schedule.tell_order")
    p.add_argument("--report-dir", default=None, help="override report_dir")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where candidates run (default cuda); must be the "
                        "spec target's device")
    args = p.parse_args(argv)

    spec = ExperimentSpec.from_yaml(args.experiment)
    if args.trials is not None:
        spec.budget.n_trials = max(1, args.trials)
    if args.backend is not None:
        spec.executor.backend = args.backend
    if args.workers is not None:
        spec.executor.n_workers = max(1, args.workers)
    if args.schedule is not None:
        spec.schedule.mode = args.schedule
    if args.tell_order is not None:
        spec.schedule.tell_order = args.tell_order
    if args.report_dir is not None:
        spec.report_dir = args.report_dir

    report = Explorer.from_spec(spec, device=args.device).run()
    best = report.best
    print(f"experiment {report.experiment!r}: {report.n_trials} trials "
          f"({report.states}) in {report.wall_clock_s:.1f}s "
          f"on {report.backend}/{report.n_workers} "
          f"(schedule={report.schedule['mode']})")
    if best is not None:
        print(f"best trial #{best['number']}: values={best['values']} "
              f"arch={best['signature']}")
    if report.cache:
        print(f"cache: {report.cache}")
    print(f"report: {report.artifact}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--list-components" in argv:
        from repro_torch.explorer.docgen import list_components_text

        print(list_components_text(), end="")
        return 0
    if argv and argv[0] == "sweep":
        from repro_torch.explorer.experiment import NOT_PORTED, NotPortedError

        raise NotPortedError(NOT_PORTED["sweep"])
    return _run_experiment(argv)


if __name__ == "__main__":
    raise SystemExit(main())
