"""The :class:`Explorer` facade: one entry point from search space to
deployment report (the JAX package's ``explorer/explorer.py`` on the
port).

Composes exactly what the hand-wired examples build by hand —
``parse_search_space`` + ``ModelBuilder`` + estimators +
``CriteriaRunner`` + ``EvaluationCache`` + ``ParallelStudy`` + an
executor backend — from a declarative
:class:`~repro_torch.explorer.experiment.ExperimentSpec`::

    from repro_torch import Explorer

    report = Explorer.from_yaml("examples/experiments/quickstart.yaml").run()
    print(report.best)

The facade is sugar *over* the layered API, not a replacement: every
subsystem stays independently importable, and ``Explorer`` holds no
state the layers don't already expose (the composed ``Study`` is
available as ``.study`` after ``run()``).

Determinism contract: for a fixed sampler seed the facade reproduces the
hand-wired wiring trial-for-trial on every executor backend (the
objective, scalarization order, and sampler RNG streams are identical),
and the JAX package's facade on the same spec; see
``tests/test_torch_explorer.py``.

The device: candidates run where the spec's target says (``h100`` on
CUDA, ``host_cpu`` on the CPU).  :class:`Explorer` takes the device the
caller asked for (CUDA unless told otherwise, as every entry point of the
port) and refuses a target that runs elsewhere, so nothing quietly runs
on the CPU in place of the card; the zero-cost proxies of a ``fidelity``
section run there too.  Not ported yet: the report's ``artifacts``
summary (the executable store, ROADMAP.md Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.explorer.experiment import ExperimentError, ExperimentSpec
from repro_torch.explorer.registry import TARGETS


def _canonical_spec_key(spec_dict: Dict[str, Any]) -> str:
    return json.dumps(spec_dict, sort_keys=True, separators=(",", ":"))


def _check_device(spec: ExperimentSpec, device: str) -> torch.device:
    """The device asked for (``resolve_device``: CUDA unless the caller
    asked for the CPU, and CUDA only with a card), which must be the one
    the spec's target runs its candidates on."""
    dev = resolve_device(device)
    target = TARGETS.get(spec.target)
    if torch.device(target.device).type != dev.type:
        raise ExperimentError(
            f"target {target.name!r} runs its candidates on {target.device}, but the "
            f"exploration was asked to run on {dev.type}: name a target of that "
            f"device (h100 for cuda, host_cpu for cpu) or ask for {target.device} "
            f"(--device {target.device})")
    return dev


# Per-process lazy state keyed by (canonical spec, run token): the
# objective below holds only a JSON dict plus the token, so it pickles
# across the process boundary; each spawn worker re-imports this module
# and composes its own space/builder/runner, sharing compiled values via
# the spec's disk cache.  The token is fresh per Explorer.run(), so a
# second run of the same spec in one process rebuilds its cache/tuner
# instead of inheriting the previous run's cumulative counters (which
# would misreport e.g. a warm run's tune count as the cold run's).
_PROCESS_STATE: Dict[Any, Any] = {}


class SpecObjective:
    """Picklable study objective compiled from an :class:`ExperimentSpec`.

    Rebuilds the evaluation pipeline lazily once per process and per
    spec.  Each trial records the candidate's full architecture
    ``signature`` plus a ``worker`` attr (evaluating pid + cumulative
    cache counters) so the parent can aggregate cache behaviour across
    worker processes it cannot otherwise observe."""

    def __init__(self, spec_dict: Dict[str, Any], run_token: Optional[str] = None):
        self.spec_dict = spec_dict
        self.run_token = run_token
        self._key = (_canonical_spec_key(spec_dict), run_token)

    def _state(self):
        state = _PROCESS_STATE.get(self._key)
        if state is None:
            from repro_torch.core.builder import ModelBuilder
            from repro_torch.core.space import parse_search_space
            from repro_torch.evaluation.api import CriteriaRunner, OptimizationCriteria
            from repro_torch.evaluation.cache import EvaluationCache
            from repro_torch.evaluation.cascade import CascadeRunner, FidelityStage, KeepRule

            spec = ExperimentSpec.from_dict(self.spec_dict)
            space = parse_search_space(dict(spec.search_space))
            builder = ModelBuilder(space.input_shape, space.output_dim)
            cache = EvaluationCache(disk=spec.cache.dir)
            target = TARGETS.get(spec.target)

            tuner = None
            kt = spec.kernel_tuning
            if kt is not None and kt.mode == "cached":
                from repro_torch.hwgen.autotune import ScheduleTuner

                # the tuner shares the experiment cache, so tuned
                # schedules persist in the same flock-safe disk store as
                # measured values: warm restart = zero re-tuning
                tuner = ScheduleTuner(target, cache=cache,
                                      budget=kt.budget, overrides=kt.kernels)

            def build_criterion(c):
                # the target's device is the one the Explorer was asked
                # for (Explorer checks it): the proxies run there too
                return OptimizationCriteria(
                    c.build_estimator(target=target, cache=cache, tuner=tuner,
                                      device=target.device, serving=spec.serving),
                    kind=c.kind, direction=c.direction,
                    weight=c.weight, limit=c.limit,
                )

            criteria = [build_criterion(c) for c in spec.criteria]
            if spec.fidelity is not None:
                # screening stages from the fidelity section, the
                # top-level criteria as the implicit final stage
                stages = [
                    FidelityStage(s.name, [build_criterion(c) for c in s.criteria],
                                  keep=KeepRule(**s.keep.to_dict()))
                    for s in spec.fidelity.stages
                ]
                stages.append(FidelityStage("final", criteria))
                runner = CascadeRunner(stages, cache=cache)
            else:
                runner = CriteriaRunner(criteria, cache=cache)
            # a prior run's state for the same spec is dead weight now —
            # its counters must not leak into this run's report
            for stale in [k for k in _PROCESS_STATE
                          if k[0] == self._key[0] and k != self._key]:
                del _PROCESS_STATE[stale]
            state = _PROCESS_STATE[self._key] = (
                spec, space, builder, runner, cache, tuner)
        return state

    @property
    def cache(self):
        return self._state()[4]

    @property
    def tuner(self):
        return self._state()[5]

    def build_model(self, trial):
        """Rebuild the (already sampled) model for ``trial`` — used by
        :meth:`Explorer.best_model` to hand back the winning network."""
        from repro_torch.core.translate import sample_architecture

        _, space, builder, _, _, _ = self._state()
        return builder.build(sample_architecture(space, trial))

    def screen_cohort(self, trials):
        """Fidelity-cascade screen hook for ``ParallelStudy.optimize``:
        sample each cohort trial's architecture *in the parent* (so the
        distribution registry is complete before any worker runs), build
        the candidates (weights unset), and let the cascade's screening
        stages decide who gets promoted to the executor."""
        from repro_torch.core.translate import sample_architecture
        from repro_torch.search.parallel import ScreenDecision

        _, space, builder, runner, _, _ = self._state()
        models = []
        for trial in trials:
            arch = sample_architecture(space, trial)
            trial.set_user_attr("signature", arch.signature())
            models.append(builder.build(arch))
        result = runner.screen_cohort(models, trials=trials)
        return ScreenDecision(
            promoted=[trials[i] for i in result.promoted],
            screened=[(trials[i], stage) for i, stage in result.screened.items()],
            infeasible=[(trials[i], stage, exc)
                        for i, (stage, exc) in result.infeasible.items()],
        )

    def _suggest_schedules(self, spec, model, trial):
        """``kernel_tuning.mode: search``: expose each discovered kernel's
        schedule fields as categorical trial parameters, so the sampler
        co-optimizes architecture × schedule.  Spec-pinned kernels pass
        through fixed — they are constraints, not search dimensions.  The
        kernels are discovered by a forward on the ``meta`` device (the
        reference's ``jax.eval_shape``)."""
        from repro_torch.hwgen.autotune import discover_kernel_calls
        from repro_torch.kernels.schedule import KERNEL_FIELDS, SEARCH_CHOICES

        kt = spec.kernel_tuning
        l, c = model.input_shape[-1], model.input_shape[0]
        x = torch.empty((1, l, c), dtype=torch.float32, device="meta")
        calls = discover_kernel_calls(model, (x,))
        schedules: Dict[str, Dict[str, Any]] = {}
        for entry in calls.values():
            kernel = entry["kernel"]
            if kernel in schedules:
                continue
            if kernel in kt.kernels:
                schedules[kernel] = dict(kt.kernels[kernel])
                continue
            schedules[kernel] = {
                field: trial.suggest_categorical(
                    f"schedule:{kernel}:{field}", list(SEARCH_CHOICES[field]))
                for field in KERNEL_FIELDS[kernel]
            }
        return schedules or None

    def __call__(self, trial):
        from repro_torch.core.translate import sample_architecture
        from repro_torch.hwgen.generator import generate_call_count

        spec, space, builder, runner, cache, tuner = self._state()
        arch = sample_architecture(space, trial)
        model = builder.build(arch)
        trial.set_user_attr("signature", arch.signature())
        context: Dict[str, Any] = {"trial": trial}
        if spec.kernel_tuning is not None and spec.kernel_tuning.mode == "search":
            schedules = self._suggest_schedules(spec, model, trial)
            if schedules is not None:
                context["schedules"] = schedules
        if spec.scalarize:
            value = runner.evaluate(model, context=context, trial=trial)
        else:
            value = runner.evaluate_multi(model, context=context, trial=trial)
        # generates: cumulative generator invocations in this process (each
        # places and runs a candidate once); launches: the process's
        # cumulative kernel launches by kernel (the report sums them per pid)
        from repro_torch.kernels.ops import LAUNCHES

        worker = {"pid": os.getpid(), "generates": generate_call_count(),
                  "launches": dict(LAUNCHES), **cache.stats.as_dict()}
        if cache.disk is not None:
            worker.update(cache.disk.stats())
        if tuner is not None:
            worker.update({f"tuner_{k}": v for k, v in tuner.stats().items()})
        trial.set_user_attr("worker", worker)
        return value


def _aggregate_cache_stats(trials) -> Optional[Dict[str, Any]]:
    """Sum each worker process's final cumulative cache counters (keyed
    by pid; counters are monotone, so the elementwise max per pid is that
    worker's total — same discipline as benchmarks/bench_nas.py).  The
    disk tier's compaction counters ride along when a disk store is
    configured."""
    per_pid: Dict[int, Dict[str, Any]] = {}
    counters = ("hits", "disk_hits", "misses",
                "compactions", "dropped_superseded", "dropped_lru")
    for t in trials:
        w = t.user_attrs.get("worker")
        if not isinstance(w, dict) or "pid" not in w:
            continue
        cur = per_pid.setdefault(w["pid"], dict.fromkeys(counters, 0))
        for k in counters:
            cur[k] = max(cur[k], w.get(k, 0))
    if not per_pid:
        return None
    totals: Dict[str, Any] = {k: sum(c[k] for c in per_pid.values()) for k in counters}
    lookups = totals["hits"] + totals["disk_hits"] + totals["misses"]
    totals["hit_rate"] = (totals["hits"] + totals["disk_hits"]) / lookups if lookups else 0.0
    totals["n_workers_seen"] = len(per_pid)
    return totals


def _aggregate_launches(trials) -> Dict[str, int]:
    """Kernel launches by kernel over the run: each worker process's
    cumulative count (its last trial's), summed over processes.  A
    process's count includes whatever it launched before the run."""
    per_pid: Dict[int, Dict[str, int]] = {}
    for t in trials:
        w = t.user_attrs.get("worker")
        if not isinstance(w, dict) or "pid" not in w:
            continue
        cur = per_pid.setdefault(w["pid"], {})
        for kernel, n in (w.get("launches") or {}).items():
            cur[kernel] = max(cur.get(kernel, 0), int(n))
    totals: Dict[str, int] = {}
    for counts in per_pid.values():
        for kernel, n in counts.items():
            totals[kernel] = totals.get(kernel, 0) + n
    return totals


def _spearman(xs: Sequence[float], ys: Sequence[float]) -> Optional[float]:
    """Tie-aware (average-rank) Spearman rank correlation, pure python —
    the report layer must not grow a scipy dependency.  Returns ``None``
    when either side is constant (correlation undefined)."""

    def ranks(vs: Sequence[float]) -> List[float]:
        order = sorted(range(len(vs)), key=lambda i: vs[i])
        out = [0.0] * len(vs)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and vs[order[j + 1]] == vs[order[i]]:
                j += 1
            avg = (i + j) / 2.0 + 1.0
            for k in range(i, j + 1):
                out[order[k]] = avg
            i = j + 1
        return out

    rx, ry = ranks(list(xs)), ranks(list(ys))
    n = len(rx)
    mx, my = sum(rx) / n, sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx <= 0.0 or vy <= 0.0:
        return None
    return cov / math.sqrt(vx * vy)


def _dominates(a: List[float], b: List[float], signs: List[float]) -> bool:
    """True if a is no worse than b on every objective and better on one
    (after sign-normalizing so every objective minimizes)."""
    no_worse = all(sa * va <= sa * vb for sa, va, vb in zip(signs, a, b))
    better = any(sa * va < sa * vb for sa, va, vb in zip(signs, a, b))
    return no_worse and better


def _trial_summary(trial, extra_values: Optional[List[float]] = None) -> Dict[str, Any]:
    return {
        "number": trial.number,
        "values": list(trial.values) if trial.values else None,
        "objective_values": extra_values,
        "params": dict(trial.params),
        "signature": trial.user_attrs.get("signature"),
    }


@dataclasses.dataclass
class ExplorationReport:
    """What an exploration produced, JSON-serializable end to end."""

    experiment: str
    sampler: str
    backend: str
    n_workers: int
    schedule: Dict[str, Any]
    directions: List[str]
    n_trials: int
    states: Dict[str, int]
    best: Optional[Dict[str, Any]]
    criteria_values: Dict[str, float]
    pareto_front: List[Dict[str, Any]]
    cache: Optional[Dict[str, Any]]
    wall_clock_s: float
    toolchain: Dict[str, str]
    # fidelity-cascade funnel (asked/screened/infeasible/promoted/compiled
    # counts, per-stage cut counts, proxy-vs-final Spearman); None when
    # the experiment has no fidelity section
    fidelity: Optional[Dict[str, Any]] = None
    # kernel-schedule tuning summary (mode, schedules chosen for the best
    # trial, tune/cache-hit counters, tune wall-clock); None when the
    # experiment has no kernel_tuning section or mode is off
    kernel_tuning: Optional[Dict[str, Any]] = None
    # full resolved TargetSpec (chip peak FLOPs/bandwidth, mesh, ...):
    # registered constants can be edited later, so the numbers that
    # actually produced this report must travel with it or cross-target
    # comparisons stop being interpretable
    target: Optional[Dict[str, Any]] = None
    # the complete experiment spec, so the report self-describes and a
    # sweep can detect that a persisted cell still matches its spec
    spec: Optional[Dict[str, Any]] = None
    artifact: Optional[str] = None
    # the device the candidates ran on ("cuda", "cpu")
    device: Optional[str] = None
    # CUDA kernel launches by kernel over the run, summed over the worker
    # processes (ops.LAUNCHES; none on the CPU, where the plain versions run)
    kernel_launches: Optional[Dict[str, int]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.artifact = path  # before serializing, so the JSON self-locates
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path


class Explorer:
    """Single front door: ``Explorer.from_yaml(path).run()``."""

    def __init__(self, spec: ExperimentSpec, device: str = "cuda"):
        self.spec = spec
        self.device = _check_device(spec, device)
        self.study = None  # composed ParallelStudy, available after run()
        self._objective: Optional[SpecObjective] = None

    # -- constructors ----------------------------------------------------------

    @classmethod
    def from_yaml(cls, path: str, device: str = "cuda") -> "Explorer":
        return cls(ExperimentSpec.from_yaml(path), device=device)

    @classmethod
    def from_spec(cls, spec: ExperimentSpec, device: str = "cuda") -> "Explorer":
        if not isinstance(spec, ExperimentSpec):
            raise ExperimentError(
                f"from_spec expects an ExperimentSpec, got {type(spec).__name__} "
                f"(use from_dict for raw mappings)"
            )
        return cls(spec, device=device)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any], device: str = "cuda") -> "Explorer":
        return cls(ExperimentSpec.from_dict(raw), device=device)

    # -- run -------------------------------------------------------------------

    def run(self, save_report: bool = True) -> ExplorationReport:
        """Execute the experiment and return (and, by default, persist
        under ``<report_dir>/``) an :class:`ExplorationReport`."""
        from repro_torch.search.parallel import ParallelStudy

        spec = self.spec
        study = ParallelStudy(
            name=spec.name,
            sampler=spec.sampler.build(),
            pruner=spec.pruner.build() if spec.pruner else None,
            directions=spec.directions,
            storage=spec.persistence,
            n_workers=spec.executor.n_workers,
            backend=spec.executor.build(),
            schedule=spec.schedule.mode,
            tell_order=spec.schedule.tell_order,
            window=spec.schedule.window,
        )
        self.study = study
        self._objective = objective = SpecObjective(
            spec.to_dict(), run_token=uuid.uuid4().hex)

        # a faults: section arms the chaos plan for exactly this run —
        # installed in-process for serial/threaded execution, exported
        # through REPRO_FAULTS so spawned process workers inherit the
        # same seeded schedule; both undone afterwards
        restore_env = None
        if spec.faults is not None:
            from repro_torch import faults as _faults

            restore_env = os.environ.get("REPRO_FAULTS")
            plan = _faults.install(spec.faults.plan())
            os.environ["REPRO_FAULTS"] = plan.to_string()

        # persistence resume: already-stored trials count against the budget
        remaining = spec.budget.n_trials - len(study.trials)
        t0 = time.perf_counter()
        try:
            if remaining > 0:
                # budget.timeout_s is enforced inside the scheduler —
                # per-submission under the sliding window, per-batch under the
                # batch scheduler — so a timeout can't overshoot by a whole
                # batch of slow trials
                study.optimize(objective, remaining,
                               n_workers=spec.executor.n_workers,
                               timeout_s=spec.budget.timeout_s,
                               screen=(objective.screen_cohort
                                       if spec.fidelity is not None else None),
                               cohort=(spec.fidelity.generation
                                       if spec.fidelity is not None else None))
        finally:
            if spec.faults is not None:
                from repro_torch import faults as _faults

                _faults.uninstall()
                if restore_env is None:
                    os.environ.pop("REPRO_FAULTS", None)
                else:
                    os.environ["REPRO_FAULTS"] = restore_env
        wall_clock = time.perf_counter() - t0

        report = self._build_report(wall_clock)
        if save_report:
            report.save(os.path.join(spec.report_dir, f"{spec.name}.report.json"))
        return report

    # -- post-run accessors ----------------------------------------------------

    def best_model(self):
        """Rebuild the winning architecture as an executable BuiltModel."""
        if self.study is None or self._objective is None:
            raise ExperimentError("best_model() requires a completed run()")
        best = self.study.best_trial
        if best is None:
            raise ExperimentError("no completed trials — nothing to rebuild")
        return self._objective.build_model(best)

    # -- report assembly -------------------------------------------------------

    def _pareto(self) -> List[Dict[str, Any]]:
        """Non-dominated completed trials over the objective criteria.
        In multi-objective mode the study's own Pareto set is used; in
        scalarized mode the front is recovered from the per-criterion
        values every trial records as user attrs (so even a weighted-sum
        search reports the trade-off surface it explored)."""
        spec, study = self.spec, self.study
        objectives = spec.objective_criteria
        if not spec.scalarize:
            return [_trial_summary(t, list(t.values)) for t in study.best_trials]
        if len(objectives) < 2:
            return []
        names = [c.estimator for c in objectives]
        signs = [1.0 if c.direction == "minimize" else -1.0 for c in objectives]
        # estimator user attrs are recorded under the *estimator instance*
        # name, which matches the registry key for the built-ins
        pts = [
            (t, [float(t.user_attrs[n]) for n in names])
            for t in study.completed_trials
            if all(n in t.user_attrs for n in names)
        ]
        front = [
            (t, vals) for t, vals in pts
            if not any(_dominates(other, vals, signs) for _, other in pts)
        ]
        return [_trial_summary(t, vals) for t, vals in front]

    def _fidelity_report(self) -> Optional[Dict[str, Any]]:
        """Per-stage funnel + proxy-vs-final rank correlation.

        ``compiled`` is how many candidates the run placed and ran once
        (:meth:`TorchGenerator.generate` calls: per-pid max of the
        cumulative ``generates`` counter, summed across workers — same
        discipline as the cache aggregation): with a warm cache it is
        *below* the promoted count, and screened-out candidates never
        contribute.  A final stage of analytic or ``metric: modelled``
        criteria generates nothing, so ``compiled`` is 0 there, where the
        reference counts an XLA compile for each modelled candidate.  ``spearman`` correlates each
        screening stage's scalarized score with the final scalarized
        value over trials that completed the full evaluation — the
        proxy-quality number the cascade's keep rules implicitly bet on."""
        from repro_torch.evaluation.cascade import STAGE_SCORE_ATTR
        from repro_torch.search.trial import TrialState

        spec, study = self.spec, self.study
        if spec.fidelity is None:
            return None
        screened_by_stage: Dict[str, int] = {}
        infeasible_by_stage: Dict[str, int] = {}
        promoted = 0
        for t in study.trials:
            stage = t.user_attrs.get("fidelity_stage")
            if stage is None:
                continue
            if stage == "promoted":
                promoted += 1
            elif t.state == TrialState.SCREENED:
                screened_by_stage[stage] = screened_by_stage.get(stage, 0) + 1
            elif t.state == TrialState.INFEASIBLE:
                infeasible_by_stage[stage] = infeasible_by_stage.get(stage, 0) + 1
        per_pid: Dict[int, int] = {}
        for t in study.trials:
            w = t.user_attrs.get("worker")
            if isinstance(w, dict) and "pid" in w:
                per_pid[w["pid"]] = max(per_pid.get(w["pid"], 0),
                                        int(w.get("generates", 0)))
        spearman: Dict[str, Optional[float]] = {}
        finals = [t for t in study.completed_trials if t.values]
        for s in spec.fidelity.stages:
            key = STAGE_SCORE_ATTR + s.name
            pairs = [(float(t.user_attrs[key]), float(t.values[0]))
                     for t in finals if key in t.user_attrs]
            spearman[s.name] = (_spearman([p[0] for p in pairs],
                                          [p[1] for p in pairs])
                                if len(pairs) >= 3 else None)
        return {
            "generation": spec.fidelity.generation,
            "funnel": {
                "asked": len(study.trials),
                "screened": sum(screened_by_stage.values()),
                "infeasible": sum(infeasible_by_stage.values()),
                "promoted": promoted,
                "compiled": sum(per_pid.values()),
            },
            "screened_by_stage": screened_by_stage,
            "infeasible_by_stage": infeasible_by_stage,
            "spearman": spearman,
        }

    def _kernel_tuning_report(self) -> Optional[Dict[str, Any]]:
        """Schedules chosen (best trial's per-kernel plan), sweep effort
        (tunes / cache hits / tune wall-clock, per-pid max of each
        worker's cumulative counters — same discipline as the cache
        aggregation), and which searched schedule params won."""
        spec, study = self.spec, self.study
        kt = spec.kernel_tuning
        if kt is None or kt.mode == "off":
            return None
        per_pid: Dict[int, Dict[str, Any]] = {}
        counters = ("tuner_tunes", "tuner_cache_hits", "tuner_tune_time_s")
        for t in study.trials:
            w = t.user_attrs.get("worker")
            if not isinstance(w, dict) or "pid" not in w:
                continue
            cur = per_pid.setdefault(w["pid"], dict.fromkeys(counters, 0))
            for k in counters:
                cur[k] = max(cur[k], w.get(k, 0))
        best = study.best_trial
        schedules = None
        if best is not None:
            schedules = best.user_attrs.get("kernel_schedules")
            if schedules is None and kt.mode == "search":
                # reconstruct from the winning trial's schedule params
                schedules = {}
                for name, value in best.params.items():
                    if not name.startswith("schedule:"):
                        continue
                    _, kernel, field = name.split(":", 2)
                    schedules.setdefault(kernel, {})[field] = value
                schedules = schedules or None
        return {
            "mode": kt.mode,
            "budget": kt.budget,
            "overrides": {k: dict(v) for k, v in kt.kernels.items()} or None,
            "schedules": schedules,
            "tunes": sum(c["tuner_tunes"] for c in per_pid.values()),
            "cache_hits": sum(c["tuner_cache_hits"] for c in per_pid.values()),
            "tune_time_s": sum(c["tuner_tune_time_s"] for c in per_pid.values()),
            "records": self._tuning_records(),
        }

    def _tuning_records(self) -> Optional[List[Dict[str, Any]]]:
        """The tuner's records in this process (``kernel_tuning.mode:
        cached``): each (kernel, shape-bucket) with every timed candidate's
        requested, effective and launched schedule and its time, whether
        this process swept it or read it from the cache.  Workers of the
        process backend keep theirs (their counters reach the report
        through the trials); None where this process tuned nothing."""
        tuner = self._objective.tuner if self._objective is not None else None
        if tuner is None:
            return None
        return tuner.records() or None

    def _build_report(self, wall_clock: float) -> ExplorationReport:
        from repro_torch.evaluation.disk_cache import toolchain_versions

        spec, study = self.spec, self.study
        states: Dict[str, int] = {}
        for t in study.trials:
            states[t.state.value] = states.get(t.state.value, 0) + 1
        best = study.best_trial
        criterion_names = [c.estimator for c in spec.criteria]
        criteria_values = {}
        if best is not None:
            criteria_values = {
                n: float(best.user_attrs[n])
                for n in criterion_names if n in best.user_attrs
            }
        return ExplorationReport(
            experiment=spec.name,
            sampler=spec.sampler.name,
            backend=spec.executor.backend,
            n_workers=spec.executor.n_workers,
            schedule=spec.schedule.to_dict(),
            directions=list(spec.directions),
            n_trials=len(study.trials),
            states=states,
            best=_trial_summary(best) if best is not None else None,
            criteria_values=criteria_values,
            pareto_front=self._pareto(),
            cache=_aggregate_cache_stats(study.trials),
            fidelity=self._fidelity_report(),
            kernel_tuning=self._kernel_tuning_report(),
            wall_clock_s=wall_clock,
            toolchain=toolchain_versions(),
            target=TARGETS.get(spec.target).to_dict(),
            spec=spec.to_dict(),
            device=str(self.device),
            kernel_launches=_aggregate_launches(study.trials),
        )
