"""Runs one of the JAX package's example scripts for
``test_torch_examples.py`` in a process of its own (not collected: the
name has no ``test_``).  ``nas_conv1d`` and ``nas_parallel`` generate
through ``XLAGenerator``, whose process-wide count ``tests/test_cascade.py``
reads in the same test worker, so they run here.

    python torch_examples_reference.py nas_conv1d LATENCY_S ARGS...
        ``examples/nas_conv1d.py`` with ``CompiledLatencyEstimator``'s
        estimate pinned to LATENCY_S (a measured time cannot be held
        across packages); prints its study's trials.
    python torch_examples_reference.py nas_parallel - ARGS...
        ``examples/nas_parallel.py``; prints the serial and the parallel
        exploration's trials.

The last line printed is one JSON object: ``{"studies": [[trial, ...],
...]}``, a trial as ``{number, state, params, values, user_attrs,
intermediate}`` (without the facade's ``worker`` record).  Run it from the directory the script may write
``results/`` in.
"""
import json
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _trials(study):
    return [{"number": t.number, "state": t.state.value, "params": t.params,
             "values": None if t.values is None else list(t.values),
             "user_attrs": {k: v for k, v in t.user_attrs.items() if k != "worker"},
             "intermediate": {str(k): v for k, v in t.intermediate.items()}}
            for t in study.trials]


def main():
    name, latency, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
    studies = []
    if name == "nas_conv1d":
        import repro.search
        from repro.evaluation import CompiledLatencyEstimator

        CompiledLatencyEstimator.estimate = lambda self, candidate, context=None: float(latency)
        base = repro.search.Study

        class Recorded(base):
            def optimize(self, *args, **kwargs):
                studies.append(self)
                return super().optimize(*args, **kwargs)

        repro.search.Study = Recorded
    elif name == "nas_parallel":
        from repro.explorer.explorer import Explorer

        run = Explorer.run

        def recorded(self, *args, **kwargs):
            report = run(self, *args, **kwargs)
            studies.append(self.study)
            return report

        Explorer.run = recorded
    else:
        raise SystemExit(f"unknown example {name!r}")
    sys.argv = [name] + argv
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    print(json.dumps({"studies": [_trials(s) for s in studies]}))


if __name__ == "__main__":
    main()
