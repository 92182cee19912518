"""Declarative experiment specification: YAML/dict -> :class:`ExperimentSpec`.

One document describes a whole exploration — the paper's "unified"
interface — instead of hand-wiring six subsystems per script::

    name: quickstart
    search_space:            # inline DSL mapping, or {file: path.yaml}
      input: [3, 256]
      output: 4
      sequence: [...]
    sampler: {name: tpe, seed: 0}
    executor: {backend: process, n_workers: 2}
    schedule: {mode: auto, tell_order: trial}    # or sliding_window / batch
    criteria:
      - {estimator: flops, kind: objective, weight: 1.0}
      - {estimator: n_params, kind: soft_constraint, limit: 1e6, weight: 0.1}
      - estimator: latency_s
        kind: objective
        params: {batch: 8, metric: modelled}   # estimator constructor kwargs
    target: host_cpu
    cache: {dir: results/cache}  # or a bare path; omit for memory-only
    persistence: results/quickstart.jsonl      # resumable study storage
    budget: {n_trials: 25, timeout_s: null}
    pruner: {name: median}                     # optional
    scalarize: true          # false -> multi-objective (Pareto) search
    report_dir: results

Component names resolve through :mod:`repro_torch.explorer.registry`, so a
plugin registered under a new key is immediately addressable from YAML.
Validation is eager and errors name the offending key plus the accepted
alternatives — a typo fails at parse time, not trial 37.

This is the JAX package's ``explorer/experiment.py`` on the port.  A
section whose modules the port does not have yet raises a
:class:`NotPortedError` (a ``NotImplementedError``) at parse time, naming
its ROADMAP.md item: the ``remote`` executor backend.  The JAX package's
TPU targets have no counterpart in the port and are refused by name.
``yaml`` is imported only to read YAML (the machine with the card has no
PyYAML; a dict spec needs none).
"""
from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.core.space import SpaceError, parse_search_space
from repro_torch.explorer.registry import (
    ESTIMATORS,
    EXECUTORS,
    PRUNERS,
    SAMPLERS,
    TARGETS,
    ExplorerError,
)


class ExperimentError(ExplorerError):
    """A spec failed validation (bad key, bad value, unknown component)."""


class NotPortedError(NotImplementedError):
    """A spec uses a section whose modules the port does not have yet; the
    message names the ROADMAP.md item that brings them."""


# what each unported section waits for (ROADMAP.md, Queue 1)
NOT_PORTED = {
    "remote": "the 'remote' executor backend is not ported yet: ROADMAP.md Queue 1 "
              "item 12 (remote)",
}


def _refuse_unported(raw: Mapping[str, Any]) -> None:
    """Raise :class:`NotPortedError` for an unported section of an
    experiment document, before any component is looked up."""
    executor = raw.get("executor")
    backend = executor.get("backend") if isinstance(executor, Mapping) else executor
    if backend == "remote":
        raise NotPortedError(NOT_PORTED["remote"])


def _check_target(name: str) -> None:
    """The target must be registered; a TPU target of the JAX package is
    refused with the reason, which a bare unknown-component error would
    not give."""
    from repro_torch.hwgen.targets import TPU_TARGETS

    if name in TPU_TARGETS:
        raise ExperimentError(
            f"target {name!r} is one of the JAX package's TPU targets "
            f"{list(TPU_TARGETS)}; the port has no TPU targets (it carries no TPU "
            f"rates): name one of {TARGETS.names()}")
    TARGETS.get(name)


CRITERIA_KINDS = ("objective", "soft_constraint", "hard_constraint")
DIRECTIONS = ("minimize", "maximize")


def _require_mapping(raw: Any, where: str) -> Dict[str, Any]:
    if not isinstance(raw, Mapping):
        raise ExperimentError(f"{where} must be a mapping, got {type(raw).__name__}")
    return dict(raw)


def _check_keys(raw: Mapping[str, Any], allowed: Mapping[str, Any] | set, where: str) -> None:
    unknown = sorted(set(raw) - set(allowed))
    if unknown:
        raise ExperimentError(
            f"unknown key(s) {unknown} in {where}; allowed keys: {sorted(allowed)}"
        )


def _check_component_kwargs(factory: Any, options: Dict[str, Any], where: str) -> None:
    """Bind ``options`` against the component constructor so a bad kwarg
    fails at spec-parse time with the constructor's own message."""
    try:
        inspect.signature(factory).bind(**options)
    except TypeError as e:
        raise ExperimentError(f"{where}: {e}") from None


@dataclasses.dataclass
class SamplerSpec:
    name: str = "random"
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # FIELD_DOCS on every spec class is read by repro_torch.explorer.docgen to
    # generate docs/reference/experiment_spec.md — the table lives next
    # to the validator so the two cannot drift
    FIELD_DOCS = {
        "name": "registered sampler key (see `components.md`); a bare "
                "string is shorthand for `{name: ...}`",
        "options": "every other key is passed to the sampler constructor "
                   "and validated against its signature at parse time "
                   "(e.g. `seed`, `population`)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "sampler") -> "SamplerSpec":
        if raw is None:
            return cls()
        if isinstance(raw, str):
            raw = {"name": raw}
        raw = _require_mapping(raw, where)
        options = dict(raw)
        name = options.pop("name", None)
        if name is None:
            raise ExperimentError(
                f"{where}: missing 'name'; registered samplers: {SAMPLERS.names()}"
            )
        factory = SAMPLERS.get(name)  # raises UnknownComponentError with alternatives
        _check_component_kwargs(factory, options, where)
        return cls(name=str(name), options=options)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, **self.options}

    def build(self):
        return SAMPLERS.get(self.name)(**self.options)


@dataclasses.dataclass
class PrunerSpec:
    name: str
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    FIELD_DOCS = {
        "name": "registered pruner key; omit the whole `pruner` section "
                "to disable pruning",
        "options": "remaining keys go to the pruner constructor "
                   "(e.g. `n_startup_trials`, `reduction_factor`)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "pruner") -> Optional["PrunerSpec"]:
        if raw is None:
            return None
        if isinstance(raw, str):
            raw = {"name": raw}
        raw = _require_mapping(raw, where)
        options = dict(raw)
        name = options.pop("name", None)
        if name is None:
            raise ExperimentError(
                f"{where}: missing 'name'; registered pruners: {PRUNERS.names()}"
            )
        factory = PRUNERS.get(name)
        _check_component_kwargs(factory, options, where)
        return cls(name=str(name), options=options)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, **self.options}

    def build(self):
        return PRUNERS.get(self.name)(**self.options)


@dataclasses.dataclass
class ExecutorSpec:
    backend: str = "serial"
    n_workers: int = 1
    workers: Optional[List[str]] = None
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    KEYS = ("backend", "n_workers", "workers", "options")
    FIELD_DOCS = {
        "backend": "registered executor key (`serial`/`thread`/`process`/"
                   "`remote` built in); a bare string is shorthand for "
                   "`{backend: ...}`",
        "n_workers": "worker slots (>= 1); also the default sliding-window "
                     "size.  Defaults to the length of `workers` when a "
                     "worker pool is given, else 1",
        "workers": "worker-daemon addresses (`[\"host:port\", ...]`) for "
                   "the `remote` backend; forwarded to the executor "
                   "constructor, so backends whose constructor takes no "
                   "`workers` reject it at parse time",
        "options": "mapping of extra executor-constructor kwargs, validated "
                   "against the signature at parse time (e.g. `retries`, "
                   "`heartbeat_timeout_s`, `task_timeout_s`, `fallback` "
                   "for `remote`; `mp_context` for `process`)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "executor") -> "ExecutorSpec":
        if raw is None:
            return cls()
        if isinstance(raw, str):
            raw = {"backend": raw}
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        backend = str(raw.get("backend", "serial"))
        factory = EXECUTORS.get(backend)
        workers = raw.get("workers")
        if workers is not None:
            if (not isinstance(workers, (list, tuple)) or not workers
                    or not all(isinstance(w, str) for w in workers)):
                raise ExperimentError(
                    f"{where}: workers must be a non-empty list of "
                    f"'host:port' strings")
            for w in workers:
                host, _, port = w.rpartition(":")
                if not host or not port.isdigit():
                    raise ExperimentError(
                        f"{where}: worker address {w!r} is not host:port")
            workers = [str(w) for w in workers]
        options = raw.get("options")
        options = dict(_require_mapping(options, f"{where}.options")) if options else {}
        # bind workers + options against the constructor: `workers` on a
        # backend that takes none (serial/thread/process) fails here with
        # the constructor's own message
        probe = dict(options)
        if workers is not None:
            probe["workers"] = workers
        _check_component_kwargs(factory, probe, where)
        n_workers = raw.get("n_workers")
        if n_workers is None:
            n_workers = len(workers) if workers else 1
        n_workers = int(n_workers)
        if n_workers < 1:
            raise ExperimentError(f"{where}: n_workers must be >= 1, got {n_workers}")
        return cls(backend=backend, n_workers=n_workers, workers=workers,
                   options=options)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"backend": self.backend, "n_workers": self.n_workers}
        if self.workers is not None:
            out["workers"] = list(self.workers)
        if self.options:
            out["options"] = dict(self.options)
        return out

    def build(self):
        kwargs = dict(self.options)
        if self.workers is not None:
            kwargs["workers"] = list(self.workers)
        return EXECUTORS.get(self.backend)(**kwargs)


@dataclasses.dataclass
class ScheduleSpec:
    """How ``ParallelStudy`` schedules trials: ``mode`` is ``auto``
    (sliding window for order-independent samplers, batch otherwise),
    ``batch``, or ``sliding_window``; ``tell_order`` is ``trial``
    (reorder buffer, deterministic storage order) or ``completion``
    (fastest, run-dependent storage order); ``window`` bounds in-flight
    submissions (default: n_workers)."""

    mode: str = "auto"
    tell_order: str = "trial"
    window: Optional[int] = None

    KEYS = ("mode", "tell_order", "window")
    MODES = ("auto", "batch", "sliding_window")
    TELL_ORDERS = ("trial", "completion")
    FIELD_DOCS = {
        "mode": "one of `auto` | `batch` | `sliding_window`; `auto` picks "
                "sliding for order-independent samplers (random/grid), "
                "batch for history-consulting ones; a bare string is "
                "shorthand for `{mode: ...}`",
        "tell_order": "`trial` (reorder buffer, deterministic storage "
                      "order) or `completion` (fastest; tells land as "
                      "evaluations finish)",
        "window": "max in-flight submissions under the sliding window "
                  "(integer >= 1; default: `n_workers`)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "schedule") -> "ScheduleSpec":
        if raw is None:
            return cls()
        if isinstance(raw, str):
            raw = {"mode": raw}
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        mode = str(raw.get("mode", "auto"))
        if mode not in cls.MODES:
            raise ExperimentError(
                f"{where}: unknown mode {mode!r}; expected one of {cls.MODES}")
        tell_order = str(raw.get("tell_order", "trial"))
        if tell_order not in cls.TELL_ORDERS:
            raise ExperimentError(
                f"{where}: unknown tell_order {tell_order!r}; expected one of "
                f"{cls.TELL_ORDERS}")
        window = raw.get("window")
        if window is not None:
            try:
                window = int(window)
            except (TypeError, ValueError):
                raise ExperimentError(
                    f"{where}: window must be an integer, got {window!r}") from None
            if window < 1:
                raise ExperimentError(f"{where}: window must be >= 1, got {window}")
        return cls(mode=mode, tell_order=tell_order, window=window)

    def to_dict(self) -> Dict[str, Any]:
        return {"mode": self.mode, "tell_order": self.tell_order,
                "window": self.window}


@dataclasses.dataclass
class CriterionSpec:
    estimator: str
    kind: str = "objective"
    direction: str = "minimize"
    weight: float = 1.0
    limit: Optional[float] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    KEYS = ("estimator", "kind", "direction", "weight", "limit", "params")
    FIELD_DOCS = {
        "estimator": "registered estimator key; a bare string is "
                     "shorthand for `{estimator: ...}`; each estimator "
                     "may appear at most once",
        "kind": "one of `objective` | `soft_constraint` | "
                "`hard_constraint`; at least one criterion must be an "
                "objective",
        "direction": "`minimize` (default) or `maximize`",
        "weight": "scalarization weight (float, default 1.0)",
        "limit": "constraint threshold; required for both constraint "
                 "kinds, ignored for objectives",
        "params": "estimator constructor kwargs, validated against its "
                  "signature at parse time (`target`, `cache`, `tuner`, "
                  "`device` and `serving` are injected by the Explorer)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str) -> "CriterionSpec":
        if isinstance(raw, str):
            raw = {"estimator": raw}
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        name = raw.get("estimator")
        if name is None:
            raise ExperimentError(
                f"{where}: missing 'estimator'; registered estimators: "
                f"{ESTIMATORS.names()}"
            )
        factory = ESTIMATORS.get(name)
        kind = str(raw.get("kind", "objective"))
        if kind not in CRITERIA_KINDS:
            raise ExperimentError(
                f"{where}: unknown kind {kind!r}; expected one of {CRITERIA_KINDS}"
            )
        direction = str(raw.get("direction", "minimize"))
        if direction not in DIRECTIONS:
            raise ExperimentError(
                f"{where}: unknown direction {direction!r}; expected one of {DIRECTIONS}"
            )
        limit = raw.get("limit")
        if kind != "objective" and limit is None:
            raise ExperimentError(f"{where}: kind {kind!r} requires a 'limit'")
        params = _require_mapping(raw.get("params") or {}, f"{where}.params")
        # target/cache/tuner/device/serving are injected by the Explorer;
        # everything else must bind against the estimator constructor
        probe = dict(params)
        sig_params = inspect.signature(factory).parameters
        for injected in ("target", "cache", "tuner", "device", "serving"):
            if injected in sig_params:
                probe.setdefault(injected, None)
        _check_component_kwargs(factory, probe, where)
        return cls(
            estimator=str(name), kind=kind, direction=direction,
            weight=float(raw.get("weight", 1.0)),
            limit=None if limit is None else float(limit),
            params=params,
        )

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "estimator": self.estimator, "kind": self.kind,
            "direction": self.direction, "weight": self.weight,
        }
        if self.limit is not None:
            d["limit"] = self.limit
        if self.params:
            d["params"] = dict(self.params)
        return d

    def build_estimator(self, target: Any = None, cache: Any = None,
                        tuner: Any = None, device: Any = None,
                        serving: Any = None):
        """Instantiate the estimator, injecting the experiment's hardware
        target, shared cache, kernel-schedule tuner, device (where the
        zero-cost proxies run) and serving spec wherever the constructor
        accepts them."""
        factory = ESTIMATORS.get(self.estimator)
        kwargs = dict(self.params)
        sig_params = inspect.signature(factory).parameters
        for name, value in (("target", target), ("cache", cache),
                            ("tuner", tuner), ("device", device),
                            ("serving", serving)):
            if name in sig_params and name not in kwargs and value is not None:
                kwargs[name] = value
        return factory(**kwargs)


@dataclasses.dataclass
class CacheSpec:
    dir: Optional[str] = None  # disk store directory; None = memory-only

    FIELD_DOCS = {
        "dir": "disk store directory for the persistent cache tier; a "
               "bare path or `true` (default `results/cache`) are "
               "shorthand; omit the section for a memory-only cache",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "cache") -> "CacheSpec":
        if raw is None or raw is False:
            return cls()
        if raw is True:
            from repro_torch.evaluation.disk_cache import DEFAULT_DIR

            return cls(dir=DEFAULT_DIR)
        if isinstance(raw, (str, os.PathLike)):
            return cls(dir=str(raw))
        raw = _require_mapping(raw, where)
        _check_keys(raw, {"dir"}, where)
        d = raw.get("dir")
        return cls(dir=None if d is None else str(d))

    def to_dict(self) -> Dict[str, Any]:
        return {"dir": self.dir}


@dataclasses.dataclass
class BudgetSpec:
    n_trials: int = 25
    timeout_s: Optional[float] = None

    KEYS = ("n_trials", "timeout_s")
    FIELD_DOCS = {
        "n_trials": "total trial budget (>= 1; resumed trials from "
                    "`persistence` count against it); a bare integer is "
                    "shorthand for `{n_trials: ...}`",
        "timeout_s": "wall-clock deadline, enforced per-submission under "
                     "the sliding window / per-batch under the batch "
                     "scheduler; `null` = no deadline",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "budget") -> "BudgetSpec":
        if raw is None:
            return cls()
        if isinstance(raw, int):
            raw = {"n_trials": raw}
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        n_trials = int(raw.get("n_trials", 25))
        if n_trials < 1:
            raise ExperimentError(f"{where}: n_trials must be >= 1, got {n_trials}")
        timeout = raw.get("timeout_s")
        return cls(n_trials=n_trials,
                   timeout_s=None if timeout is None else float(timeout))

    def to_dict(self) -> Dict[str, Any]:
        return {"n_trials": self.n_trials, "timeout_s": self.timeout_s}


@dataclasses.dataclass
class KeepSpec:
    """Survivor rule for one screening stage — exactly one key."""

    top_k: Optional[int] = None
    top_frac: Optional[float] = None
    threshold: Optional[float] = None

    KEYS = ("top_k", "top_frac", "threshold")
    FIELD_DOCS = {
        "top_k": "keep the k best-ranked candidates of the cohort "
                 "(integer >= 1; lower stage score ranks better, ties "
                 "keep ask order)",
        "top_frac": "keep the best `ceil(frac * cohort)` candidates "
                    "(float in (0, 1]; always at least one)",
        "threshold": "keep candidates whose scalarized stage score is "
                     "<= this value (per-candidate; no cohort ranking)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str) -> "KeepSpec":
        if raw is None:
            raise ExperimentError(
                f"{where}: missing 'keep'; every fidelity stage needs a "
                f"survivor rule (one of {cls.KEYS})")
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        set_keys = [k for k in cls.KEYS if raw.get(k) is not None]
        if len(set_keys) != 1:
            raise ExperimentError(
                f"{where}: exactly one of {cls.KEYS} must be set, "
                f"got {set_keys or 'none'}")
        top_k = raw.get("top_k")
        if top_k is not None:
            top_k = int(top_k)
            if top_k < 1:
                raise ExperimentError(f"{where}: top_k must be >= 1, got {top_k}")
        top_frac = raw.get("top_frac")
        if top_frac is not None:
            top_frac = float(top_frac)
            if not 0.0 < top_frac <= 1.0:
                raise ExperimentError(
                    f"{where}: top_frac must be in (0, 1], got {top_frac}")
        threshold = raw.get("threshold")
        return cls(top_k=top_k, top_frac=top_frac,
                   threshold=None if threshold is None else float(threshold))

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.KEYS
                if getattr(self, k) is not None}


@dataclasses.dataclass
class StageSpec:
    """One screening stage of the fidelity cascade (the *final* stage is
    the experiment's top-level ``criteria`` and needs no declaration)."""

    name: str = ""
    criteria: List[CriterionSpec] = dataclasses.field(default_factory=list)
    keep: KeepSpec = dataclasses.field(default_factory=KeepSpec)

    KEYS = ("name", "criteria", "keep")
    FIELD_DOCS = {
        "name": "stage label, recorded on screened-out trials as "
                "`user_attrs[\"fidelity_stage\"]`; must be unique and not "
                "`final` (reserved for the top-level criteria)",
        "criteria": "criterion entries exactly like the top-level "
                    "`criteria` list (zero-cost proxies `synflow` / "
                    "`grad_norm` and analytic estimators are the natural "
                    "fit); at least one `kind: objective`",
        "keep": "survivor rule (see table below)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str) -> "StageSpec":
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        name = raw.get("name")
        if not name or not isinstance(name, str):
            raise ExperimentError(f"{where}: missing or empty 'name'")
        if name in ("final", "promoted"):
            raise ExperimentError(
                f"{where}: stage name {name!r} is reserved (the top-level "
                f"criteria form the final stage; 'promoted' marks survivors)")
        raw_criteria = raw.get("criteria")
        if not isinstance(raw_criteria, (list, tuple)) or not raw_criteria:
            raise ExperimentError(
                f"{where}: criteria must be a non-empty list of criterion "
                f"entries")
        criteria = [CriterionSpec.from_raw(c, f"{where}.criteria[{i}]")
                    for i, c in enumerate(raw_criteria)]
        if not any(c.kind == "objective" for c in criteria):
            raise ExperimentError(
                f"{where}: a screening stage needs at least one "
                f"kind='objective' criterion to rank the cohort by")
        return cls(name=name, criteria=criteria,
                   keep=KeepSpec.from_raw(raw.get("keep"), f"{where}.keep"))

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name,
                "criteria": [c.to_dict() for c in self.criteria],
                "keep": self.keep.to_dict()}


@dataclasses.dataclass
class FidelitySpec:
    """The multi-fidelity evaluation cascade: candidates are asked a
    *generation* at a time, screened in-process through the declared
    stages (cheapest first), and only survivors are promoted to the
    executor for the full (measured) top-level criteria."""

    stages: List[StageSpec] = dataclasses.field(default_factory=list)
    generation: int = 16

    KEYS = ("stages", "generation")
    FIELD_DOCS = {
        "stages": "**required** — non-empty list of screening stages, "
                  "cheapest first (see table below); the experiment's "
                  "top-level `criteria` are the implicit final stage",
        "generation": "cohort size: how many trials are asked and "
                      "screened together before survivors are promoted "
                      "(integer >= 1, default 16)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "fidelity") -> Optional["FidelitySpec"]:
        if raw is None:
            return None
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        raw_stages = raw.get("stages")
        if not isinstance(raw_stages, (list, tuple)) or not raw_stages:
            raise ExperimentError(
                f"{where}: stages must be a non-empty list of "
                f"{{name, criteria, keep}} entries")
        stages = [StageSpec.from_raw(s, f"{where}.stages[{i}]")
                  for i, s in enumerate(raw_stages)]
        names = [s.name for s in stages]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ExperimentError(
                f"{where}: duplicate stage name(s) {dupes}")
        generation = int(raw.get("generation", 16))
        if generation < 1:
            raise ExperimentError(
                f"{where}: generation must be >= 1, got {generation}")
        return cls(stages=stages, generation=generation)

    def to_dict(self) -> Dict[str, Any]:
        return {"stages": [s.to_dict() for s in self.stages],
                "generation": self.generation}


@dataclasses.dataclass
class KernelTuningSpec:
    """Kernel-schedule tuning: make the kernels' block/chunk parameters a
    per-target search dimension.  ``mode: cached`` attaches a
    :class:`~repro_torch.hwgen.autotune.ScheduleTuner` that sweeps a small
    candidate grid per (kernel, shape-bucket, target) and memoizes the
    winner in the evaluation cache; ``mode: search`` instead exposes the
    schedule fields as extra trial parameters so the sampler co-optimizes
    architecture × schedule."""

    mode: str = "off"
    budget: Optional[int] = None
    kernels: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    KEYS = ("mode", "budget", "kernels")
    MODES = ("off", "cached", "search")
    FIELD_DOCS = {
        "mode": "`off` (default) | `cached` — autotune each kernel per "
                "(shape-bucket, target) and cache the winner, zero "
                "re-tuning on warm restart | `search` — schedule fields "
                "become trial parameters the sampler optimizes; a bare "
                "string is shorthand for `{mode: ...}`",
        "budget": "max schedule candidates timed per kernel/shape-bucket "
                  "sweep (integer >= 1); wins over `REPRO_TUNE_BUDGET`; "
                  "grids are default-first, so 1 degenerates to the "
                  "named `default` schedule",
        "kernels": "per-kernel schedule overrides, e.g. "
                   "`{ssm_scan: {chunk: 64}}` — pinned kernels are never "
                   "tuned (`cached`) or searched (`search`); fields are "
                   "validated against the kernel's legal ranges at parse "
                   "time",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "kernel_tuning"
                 ) -> Optional["KernelTuningSpec"]:
        from repro_torch.kernels.schedule import (KERNEL_FIELDS, ScheduleError,
                                            as_schedule)

        if raw is None:
            return None
        if isinstance(raw, str):
            raw = {"mode": raw}
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        mode = str(raw.get("mode", "off"))
        if mode not in cls.MODES:
            raise ExperimentError(
                f"{where}: unknown mode {mode!r}; expected one of {cls.MODES}")
        budget = raw.get("budget")
        if budget is not None:
            try:
                budget = int(budget)
            except (TypeError, ValueError):
                raise ExperimentError(
                    f"{where}: budget must be an integer, got {budget!r}"
                ) from None
            if budget < 1:
                raise ExperimentError(
                    f"{where}: budget must be >= 1, got {budget}")
        kernels: Dict[str, Dict[str, Any]] = {}
        for kernel, fields in _require_mapping(raw.get("kernels") or {},
                                               f"{where}.kernels").items():
            if kernel not in KERNEL_FIELDS:
                raise ExperimentError(
                    f"{where}.kernels: unknown kernel {kernel!r}; "
                    f"schedulable kernels: {sorted(KERNEL_FIELDS)}")
            fields = _require_mapping(fields, f"{where}.kernels.{kernel}")
            try:
                as_schedule(kernel, fields)
            except ScheduleError as e:
                raise ExperimentError(f"{where}.kernels.{kernel}: {e}") from None
            kernels[kernel] = dict(fields)
        return cls(mode=mode, budget=budget, kernels=kernels)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"mode": self.mode}
        if self.budget is not None:
            d["budget"] = self.budget
        if self.kernels:
            d["kernels"] = {k: dict(v) for k, v in self.kernels.items()}
        return d


@dataclasses.dataclass
class FaultsSpec:
    """Deterministic fault injection (chaos testing a run on purpose).

    The section validates into a :class:`repro_torch.faults.FaultPlan`;
    :meth:`Explorer.run` installs it for the run's duration and exports
    it through ``REPRO_FAULTS`` so spawned process workers inherit the
    same seeded schedule."""

    seed: int = 0
    rules: List[str] = dataclasses.field(default_factory=list)

    KEYS = ("seed", "rules")
    FIELD_DOCS = {
        "seed": "seed for the plan's per-rule RNG streams — the same "
                "seed reproduces the same fault schedule on every run "
                "and every backend (default 0)",
        "rules": "non-empty list of `site:action[@k=v,...]` rule strings "
                 "or `{site, action, p, times, after, delay_s, key}` "
                 "mappings (see `docs/architecture.md` for the site and "
                 "action tables); a bare string section is shorthand for "
                 "the whole `REPRO_FAULTS` spec string",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "faults"
                 ) -> Optional["FaultsSpec"]:
        from repro_torch.faults import FaultPlan

        if raw is None:
            return None
        try:
            if isinstance(raw, str):
                plan = FaultPlan.from_string(raw)
            else:
                plan = FaultPlan.from_spec(_require_mapping(raw, where))
        except ValueError as e:
            raise ExperimentError(f"{where}: {e}") from None
        if not plan.rules:
            raise ExperimentError(
                f"{where}: needs at least one rule (omit the section to "
                f"run without injection)")
        return cls(seed=plan.seed, rules=[r.to_string() for r in plan.rules])

    def plan(self):
        """The validated, installable :class:`repro_torch.faults.FaultPlan`."""
        from repro_torch.faults import FaultPlan

        return FaultPlan.from_spec({"seed": self.seed, "rules": list(self.rules)})

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"rules": list(self.rules)}
        if self.seed:
            d["seed"] = self.seed
        return d


@dataclasses.dataclass
class ServingSpec:
    """Traffic-shaped serving criteria: how the engine batches and what
    load it sees.  Injected into estimators that accept a ``serving``
    kwarg (the :mod:`repro_torch.evaluation.serving` family), so sweeps
    rank candidates by p99 latency / throughput *under the declared
    traffic mix* rather than single-request kernel time."""

    traffic: "Any" = None  # TrafficSpec; default built in __post_init__
    max_batch: int = 8
    queue_limit: int = 16
    dtype_bytes: int = 2

    KEYS = ("traffic", "max_batch", "queue_limit", "dtype_bytes")
    FIELD_DOCS = {
        "traffic": "declared traffic mix: seeded arrival process + "
                   "prompt/generation length mixes; replays bit-identically "
                   "at a fixed seed",
        "max_batch": "continuous-batching concurrency limit — the engine "
                     "decodes at most this many requests per step "
                     "(integer >= 1, default 8)",
        "queue_limit": "bounded admission queue depth; arrivals beyond it "
                       "are shed gracefully (integer >= 1, default 16)",
        "dtype_bytes": "bytes per decode-cache element (2 = bf16 default, "
                       "4 = f32); scales `kv_cache_peak_bytes` and the "
                       "decode-state bandwidth term",
    }

    def __post_init__(self):
        from repro_torch.launch.traffic import TrafficSpec

        if self.traffic is None:
            self.traffic = TrafficSpec()

    @classmethod
    def from_raw(cls, raw: Any, where: str = "serving"
                 ) -> Optional["ServingSpec"]:
        from repro_torch.launch.traffic import TrafficError, TrafficSpec

        if raw is None:
            return None
        raw = _require_mapping(raw, where)
        _check_keys(raw, set(cls.KEYS), where)
        try:
            traffic = TrafficSpec.from_raw(raw.get("traffic"),
                                           f"{where}.traffic")
        except TrafficError as e:
            raise ExperimentError(str(e)) from None
        max_batch = int(raw.get("max_batch", 8))
        if max_batch < 1:
            raise ExperimentError(
                f"{where}: max_batch must be >= 1, got {max_batch}")
        queue_limit = int(raw.get("queue_limit", 16))
        if queue_limit < 1:
            raise ExperimentError(
                f"{where}: queue_limit must be >= 1, got {queue_limit}")
        dtype_bytes = int(raw.get("dtype_bytes", 2))
        if dtype_bytes not in (1, 2, 4, 8):
            raise ExperimentError(
                f"{where}: dtype_bytes must be one of (1, 2, 4, 8), "
                f"got {dtype_bytes}")
        return cls(traffic=traffic, max_batch=max_batch,
                   queue_limit=queue_limit, dtype_bytes=dtype_bytes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "traffic": self.traffic.to_dict(),
            "max_batch": self.max_batch,
            "queue_limit": self.queue_limit,
            "dtype_bytes": self.dtype_bytes,
        }


TOP_LEVEL_KEYS = (
    "name", "search_space", "sampler", "executor", "schedule", "criteria",
    "fidelity", "kernel_tuning", "target", "cache", "persistence", "budget",
    "pruner", "scalarize", "report_dir", "faults", "serving",
)

def _resolve_search_space(raw: Any, base_dir: Optional[str]) -> Dict[str, Any]:
    """Inline mapping, inline YAML text, or ``{file: path}`` reference
    (relative paths resolve against the experiment file's directory).
    Always returns the loaded mapping so the spec is self-contained and
    picklable regardless of where it came from."""
    if raw is None:
        raise ExperimentError(
            f"missing 'search_space'; provide an inline space mapping or "
            f"{{file: path.yaml}}"
        )
    if isinstance(raw, Mapping) and set(raw) == {"file"}:
        path = str(raw["file"])
        if base_dir and not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        if not os.path.exists(path):
            raise ExperimentError(f"search_space file not found: {path!r}")
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f.read())
    elif isinstance(raw, str):
        import yaml

        raw = yaml.safe_load(raw)
    if not isinstance(raw, Mapping):
        raise ExperimentError(
            f"search_space must be a mapping (inline DSL or {{file: path}}), "
            f"got {type(raw).__name__}"
        )
    return dict(raw)


@dataclasses.dataclass
class ExperimentSpec:
    """A fully validated, JSON-serializable experiment description."""

    name: str
    search_space: Dict[str, Any]
    criteria: List[CriterionSpec]
    sampler: SamplerSpec = dataclasses.field(default_factory=SamplerSpec)
    executor: ExecutorSpec = dataclasses.field(default_factory=ExecutorSpec)
    schedule: ScheduleSpec = dataclasses.field(default_factory=ScheduleSpec)
    target: str = "host_cpu"
    cache: CacheSpec = dataclasses.field(default_factory=CacheSpec)
    persistence: Optional[str] = None
    budget: BudgetSpec = dataclasses.field(default_factory=BudgetSpec)
    pruner: Optional[PrunerSpec] = None
    fidelity: Optional[FidelitySpec] = None
    kernel_tuning: Optional[KernelTuningSpec] = None
    faults: Optional[FaultsSpec] = None
    serving: Optional[ServingSpec] = None
    scalarize: bool = True
    report_dir: str = "results"

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any],
                  base_dir: Optional[str] = None) -> "ExperimentSpec":
        raw = _require_mapping(raw, "experiment")
        _refuse_unported(raw)
        _check_keys(raw, set(TOP_LEVEL_KEYS), "experiment")

        space_dict = _resolve_search_space(raw.get("search_space"), base_dir)
        try:
            parse_search_space(dict(space_dict))
        except SpaceError as e:
            raise ExperimentError(f"search_space: {e}") from e

        raw_criteria = raw.get("criteria")
        if not isinstance(raw_criteria, (list, tuple)) or not raw_criteria:
            raise ExperimentError(
                "criteria must be a non-empty list of "
                "{estimator, kind, direction, weight, limit, params} entries"
            )
        criteria = [CriterionSpec.from_raw(c, f"criteria[{i}]")
                    for i, c in enumerate(raw_criteria)]
        objectives = [c for c in criteria if c.kind == "objective"]
        if not objectives:
            raise ExperimentError(
                "criteria must include at least one kind='objective' entry "
                "(constraints alone give every candidate the same score)"
            )
        names = [c.estimator for c in criteria]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ExperimentError(
                f"criteria reference estimator(s) {dupes} more than once; "
                f"scores aggregate by estimator name, so duplicates collide"
            )

        fidelity = FidelitySpec.from_raw(raw.get("fidelity"))
        if fidelity is not None:
            # estimator names must be unique across the WHOLE cascade —
            # every stage records values on the trial by estimator name
            cascade_names = list(names)
            for s in fidelity.stages:
                cascade_names.extend(c.estimator for c in s.criteria)
            dupes = sorted({n for n in cascade_names
                            if cascade_names.count(n) > 1})
            if dupes:
                raise ExperimentError(
                    f"fidelity stages and criteria reference estimator(s) "
                    f"{dupes} more than once across the cascade; trial "
                    f"values record by estimator name, so duplicates collide"
                )

        target = str(raw.get("target", "host_cpu"))
        _check_target(target)

        scalarize = bool(raw.get("scalarize", True))
        if not scalarize:
            soft = [c.estimator for c in criteria if c.kind == "soft_constraint"]
            if soft:
                raise ExperimentError(
                    f"scalarize: false ignores soft constraints (multi-objective "
                    f"evaluation only runs hard constraints and objectives), but "
                    f"criteria declare soft_constraint(s) {soft}; use "
                    f"kind: hard_constraint, promote them to objectives, or keep "
                    f"scalarize: true"
                )
        persistence = raw.get("persistence")
        return cls(
            name=str(raw.get("name", "experiment")),
            search_space=space_dict,
            criteria=criteria,
            sampler=SamplerSpec.from_raw(raw.get("sampler")),
            executor=ExecutorSpec.from_raw(raw.get("executor")),
            schedule=ScheduleSpec.from_raw(raw.get("schedule")),
            target=target,
            cache=CacheSpec.from_raw(raw.get("cache")),
            persistence=None if persistence is None else str(persistence),
            budget=BudgetSpec.from_raw(raw.get("budget")),
            pruner=PrunerSpec.from_raw(raw.get("pruner")),
            fidelity=fidelity,
            kernel_tuning=KernelTuningSpec.from_raw(raw.get("kernel_tuning")),
            faults=FaultsSpec.from_raw(raw.get("faults")),
            serving=ServingSpec.from_raw(raw.get("serving")),
            scalarize=scalarize,
            report_dir=str(raw.get("report_dir", "results")),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "ExperimentSpec":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f.read())
        return cls.from_dict(raw, base_dir=os.path.dirname(os.path.abspath(path)))

    @classmethod
    def from_yaml_text(cls, text: str, base_dir: Optional[str] = None) -> "ExperimentSpec":
        import yaml

        return cls.from_dict(yaml.safe_load(text), base_dir=base_dir)

    # -- serialization ---------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able round-trip form: ``from_dict(spec.to_dict())`` is
        equivalent to ``spec`` (search-space file refs come back inlined)."""
        d: Dict[str, Any] = {
            "name": self.name,
            "search_space": dict(self.search_space),
            "sampler": self.sampler.to_dict(),
            "executor": self.executor.to_dict(),
            "schedule": self.schedule.to_dict(),
            "criteria": [c.to_dict() for c in self.criteria],
            "target": self.target,
            "cache": self.cache.to_dict(),
            "budget": self.budget.to_dict(),
            "scalarize": self.scalarize,
            "report_dir": self.report_dir,
        }
        if self.persistence is not None:
            d["persistence"] = self.persistence
        if self.pruner is not None:
            d["pruner"] = self.pruner.to_dict()
        if self.fidelity is not None:
            d["fidelity"] = self.fidelity.to_dict()
        if self.kernel_tuning is not None:
            d["kernel_tuning"] = self.kernel_tuning.to_dict()
        if self.faults is not None:
            d["faults"] = self.faults.to_dict()
        if self.serving is not None:
            d["serving"] = self.serving.to_dict()
        return d

    # -- derived views ---------------------------------------------------------

    @property
    def objective_criteria(self) -> List[CriterionSpec]:
        return [c for c in self.criteria if c.kind == "objective"]

    @property
    def directions(self) -> tuple:
        """Study directions: the scalarized score always minimizes (the
        aggregator folds maximize objectives in by sign); multi-objective
        mode optimizes each objective in its declared direction."""
        if self.scalarize:
            return ("minimize",)
        return tuple(c.direction for c in self.objective_criteria)
