"""Run a YAML experiment — or fan one across a sweep — from the shell,
on the port::

    PYTHONPATH=src python -m repro_torch.explorer spec.yaml            # on the card
    PYTHONPATH=src python -m repro_torch.explorer \
        examples/experiments/quickstart.yaml --device cpu
    PYTHONPATH=src python -m repro_torch.explorer sweep \
        src/repro_torch/experiments/sweep_small.yaml    # on a card, with PyYAML
    PYTHONPATH=src python -m repro_torch.explorer sweep \
        examples/experiments/sweep_small.yaml \
        --axis targets=host_cpu,edge_npu --device cpu
    PYTHONPATH=src python -m repro_torch.explorer --list-components

Candidates run on CUDA unless ``--device cpu`` is given, and the spec's
target must run on that device (``h100``: cuda, ``host_cpu``: cpu).  A
sweep runs each cell on its target's device; with ``--device cpu`` a
cell whose target runs on CUDA is refused.  Overrides exist for the
knobs CI and quick local smoke runs need to shrink without editing the
experiment/sweep file.
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


def _run_sweep(argv: List[str]) -> int:
    from repro_torch.explorer.sweep import AXIS_ALIASES, SweepError, SweepSpec, run_sweep

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.explorer sweep",
        description="Fan one experiment across axes and merge the reports.",
    )
    p.add_argument("sweep", help="path to the sweep YAML")
    p.add_argument("--axis", action="append", default=[], metavar="KEY=V1,V2",
                   help="replace one axis with comma-separated scalar values "
                        "(e.g. --axis target=host_cpu,edge_npu); repeatable")
    p.add_argument("--trials", type=int, default=None,
                   help="override every cell's budget.n_trials")
    p.add_argument("--workers", type=int, default=None,
                   help="override every cell's executor.n_workers")
    p.add_argument("--report-dir", default=None, help="override report_dir")
    p.add_argument("--no-resume", action="store_true",
                   help="re-run every cell even when a completed report exists")
    p.add_argument("--cell-workers", default=None, metavar="HOST:PORT,...",
                   help="fan cells across worker daemons: not ported yet "
                        "(ROADMAP.md Queue 1 item 12), refused")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the device asked for (default cuda); each cell runs "
                        "on its target's, and cpu refuses a cell on cuda")
    args = p.parse_args(argv)

    spec = SweepSpec.from_yaml(args.sweep)
    for override in args.axis:
        key, eq, values = override.partition("=")
        if not eq or not values:
            p.error(f"--axis expects KEY=V1[,V2...], got {override!r}")
        spec.axes[AXIS_ALIASES.get(key, key)] = [
            v for v in (s.strip() for s in values.split(",")) if v]
    # shrink knobs are applied AFTER each cell's axis values, so they win
    # even over a whole-section `budget:`/`executor:` axis
    overrides = {}
    if args.trials is not None:
        overrides["budget.n_trials"] = max(1, args.trials)
        spec.axes.pop("budget.n_trials", None)  # now-constant axis
    if args.workers is not None:
        overrides["executor.n_workers"] = max(1, args.workers)
        spec.axes.pop("executor.n_workers", None)
    if args.report_dir is not None:
        spec.report_dir = args.report_dir

    try:
        report = run_sweep(spec, resume=not args.no_resume,
                           overrides=overrides or None,
                           workers=None if args.cell_workers is None
                           else args.cell_workers.split(","),
                           device=args.device)
    except SweepError as e:
        p.error(str(e))
    print(f"sweep {report.sweep!r}: {report.n_cells} cells "
          f"({report.n_resumed} resumed) in {report.wall_clock_s:.1f}s")
    for cell in report.cells:
        best = cell["best"] or {}
        tag = " (resumed)" if cell["resumed"] else ""
        print(f"  {cell['name']}: best #{best.get('number')} "
              f"values={best.get('values')}{tag}")
    for profile, ranked in report.target_rankings.items():
        if ranked:
            order = " > ".join(r["target"] for r in ranked)
            print(f"  wins[{profile}]: {order}")
    if report.cache:
        print(f"  cache: {report.cache}")
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
        return _run_sweep(argv[1:])
    return _run_experiment(argv)


if __name__ == "__main__":
    raise SystemExit(main())
