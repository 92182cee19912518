"""Experiment sweeps: fan one :class:`ExperimentSpec` across axes and
merge the per-cell reports into one comparative :class:`SweepReport`.

The paper positions the framework as a *unified* interface across
heterogeneous accelerator platforms; the payoff of that unification is
the cross-target comparison (Once-for-All's train-once/specialize-per-
platform, HW-NAS-Bench's tabular cross-device tables), not any single
run.  A ``SweepSpec`` is the meta-spec for exactly that::

    name: sweep-small
    base: {file: quickstart.yaml}      # or an inline experiment mapping
    axes:
      target: [host_cpu, edge_npu, h100]
      sampler: [{name: random, seed: 0}, {name: tpe, seed: 0}]
      budget.n_trials: [8]             # any dotted key is an axis
    cache: results/cache               # shared disk store for every cell
    report_dir: results

``expand()`` takes the cross product of the axes, applies each
combination to the base experiment as dotted-key overrides, and
validates every child eagerly — a bad axis value fails before anything
runs, naming the axis.  ``run_sweep()`` then drives each cell through
the ordinary :class:`~repro_torch.explorer.explorer.Explorer` (so at a
fixed seed a cell's best trial is identical to running that child spec
standalone) on the device its target runs on, with every cell sharing
one disk cache — values the program determines are scoped by the
target's ``mesh_scope``, so a second target of the same scope
(``edge_npu`` after ``host_cpu``) counts and generates nothing — and
merges the reports: a per-criterion best-value matrix (target x
sampler), the cross-target Pareto union, aggregated cache/compaction
hygiene, and per-criterion target rankings.

**Resume.**  Each cell's report is written under
``<report_dir>/<sweep>.cells/`` before the next cell starts, and a cell
whose persisted report still matches its spec (the report embeds the
full spec) is skipped on re-run — a killed sweep restarts where it
stopped instead of re-paying completed cells.

This is the JAX package's ``explorer/sweep.py`` on the port.  ``yaml`` is
imported only to read YAML (the machine with the card has no PyYAML; a
dict sweep needs none).  With ``workers:`` (or the CLI's
``--cell-workers``) the cells that are not resumed fan out across worker
daemons (``python -m repro_torch.worker``), each run there on its
target's device.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import json
import os
import re
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.explorer.experiment import (
    TOP_LEVEL_KEYS,
    ExperimentError,
    ExperimentSpec,
    _require_mapping,
)
from repro_torch.explorer.registry import TARGETS, ExplorerError


class SweepError(ExplorerError):
    """A sweep spec failed validation (bad axis, bad cell, bad key)."""


# plural conveniences for the common comparison axes; any other axis key
# must be a (dotted) path into the experiment document itself
AXIS_ALIASES = {"targets": "target", "samplers": "sampler",
                "schedules": "schedule", "executors": "executor"}

SWEEP_KEYS = ("name", "base", "axes", "cache", "report_dir", "workers")


def _load_yaml(path: str) -> Any:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f.read())


def _set_dotted(doc: Dict[str, Any], dotted: str, value: Any) -> None:
    """Apply one ``a.b.c = value`` override, creating intermediate
    mappings; a non-mapping intermediate is an axis error."""
    parts = dotted.split(".")
    node = doc
    for part in parts[:-1]:
        child = node.get(part)
        if child is None:
            child = node[part] = {}
        elif not isinstance(child, dict):
            raise SweepError(
                f"axis {dotted!r} descends through {part!r}, which is "
                f"{type(child).__name__}, not a mapping")
        node = child
    node[parts[-1]] = copy.deepcopy(value)


def _axis_label(value: Any) -> str:
    """Short, filesystem-safe label for one axis value (used in cell
    names): component mappings label by their name/mode/backend key, with
    a content hash suffix when extra options would otherwise collide."""
    if isinstance(value, Mapping):
        label = None
        for probe in ("name", "mode", "backend"):
            if probe in value:
                label = str(value[probe])
                extra = {k: v for k, v in value.items() if k != probe}
                break
        if label is None:
            label, extra = "cfg", dict(value)
        if extra and all(isinstance(v, (str, int, float, bool))
                         for v in extra.values()) and len(extra) <= 3:
            # short scalar options read better inline: "tpe-seed0"
            label += "".join(f"-{k}{v}" for k, v in sorted(extra.items()))
        elif extra:
            digest = hashlib.sha1(
                json.dumps(extra, sort_keys=True, default=str).encode()
            ).hexdigest()[:6]
            label = f"{label}-{digest}"
    else:
        label = str(value)
    return re.sub(r"[^A-Za-z0-9._-]+", "-", label) or "value"


@dataclasses.dataclass
class SweepCell:
    """One point of the cross product: a fully validated child spec."""

    name: str
    axes: Dict[str, str]          # axis key -> value label (for humans)
    axis_values: Dict[str, Any]   # axis key -> raw value (for machines)
    spec: ExperimentSpec

    @property
    def report_path(self) -> str:
        return os.path.join(self.spec.report_dir, f"{self.name}.report.json")

    @property
    def device(self) -> str:
        """Where the cell's candidates run: its target's device."""
        return TARGETS.get(self.spec.target).device


@dataclasses.dataclass
class SweepSpec:
    """A validated sweep: base experiment + axes, YAML/dict round-trip.
    Its keys are ``SWEEP_KEYS``."""

    name: str
    base: Dict[str, Any]          # resolved experiment dict (space inlined)
    axes: Dict[str, List[Any]]    # normalized axis key -> values, in order
    cache: Optional[str] = None   # shared disk store forced into every cell
    report_dir: str = "results"
    workers: Optional[List[str]] = None  # worker daemons to fan cells across

    # read by repro_torch.explorer.docgen into the sweep table of
    # docs/reference/torch/experiment_spec.md
    FIELD_DOCS = {
        "name": "sweep name; names `<report_dir>/<name>.sweep.json` and "
                "the per-cell directory `<report_dir>/<name>.cells/` "
                "(default: `sweep`)",
        "base": "**required** — the experiment every cell starts from: an "
                "inline experiment mapping or `{file: experiment.yaml}` "
                "(validated eagerly; search-space refs are inlined)",
        "axes": "**required** — non-empty mapping of axis -> list of "
                "values; `target`/`sampler`/`schedule`/`executor` (or "
                "their plural aliases) override those sections whole, any "
                "other dotted key (e.g. `budget.n_trials`) overrides one "
                "leaf; the cross product of all axes defines the cells",
        "cache": "shared disk-cache directory forced into **every** cell "
                 "(so cells of one mesh scope reuse each other's counts); "
                 "omit to inherit the base experiment's cache section "
                 "unchanged",
        "report_dir": "directory for the merged sweep report and the "
                      "per-cell reports (default `results`)",
        "workers": "worker-daemon addresses (`[\"host:port\", ...]`) to fan "
                   "independent cells across (see `python -m "
                   "repro_torch.worker`); cells are resubmitted on worker "
                   "failure and fall back to local sequential execution when "
                   "no worker is reachable, except a cell whose target runs "
                   "on CUDA under `--device cpu`, which runs only on the "
                   "pool.  Omit (default) to run cells locally",
    }

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any],
                  base_dir: Optional[str] = None) -> "SweepSpec":
        raw = _require_mapping(raw, "sweep")
        unknown = sorted(set(raw) - set(SWEEP_KEYS))
        if unknown:
            raise SweepError(
                f"unknown key(s) {unknown} in sweep; allowed keys: "
                f"{sorted(SWEEP_KEYS)}")

        base_raw = raw.get("base")
        if base_raw is None:
            raise SweepError(
                "missing 'base'; provide an inline experiment mapping or "
                "{file: experiment.yaml}")
        if isinstance(base_raw, Mapping) and set(base_raw) == {"file"}:
            path = str(base_raw["file"])
            if base_dir and not os.path.isabs(path):
                path = os.path.join(base_dir, path)
            if not os.path.exists(path):
                raise SweepError(f"base experiment file not found: {path!r}")
            base_raw = _load_yaml(path)
            base_dir = os.path.dirname(os.path.abspath(path))
        base_raw = _require_mapping(base_raw, "sweep.base")
        try:
            # validate once and keep the *resolved* form: search-space
            # file refs come back inlined and shorthands normalized, so
            # dotted-key overrides always land on mappings
            base = ExperimentSpec.from_dict(base_raw, base_dir=base_dir).to_dict()
        except ExperimentError as e:
            raise SweepError(f"sweep.base: {e}") from e

        axes_raw = raw.get("axes")
        if not isinstance(axes_raw, Mapping) or not axes_raw:
            raise SweepError(
                "axes must be a non-empty mapping of axis -> list of values "
                "(e.g. target: [host_cpu, edge_npu])")
        axes: Dict[str, List[Any]] = {}
        for key, values in axes_raw.items():
            norm = AXIS_ALIASES.get(str(key), str(key))
            head = norm.split(".", 1)[0]
            if head not in TOP_LEVEL_KEYS:
                raise SweepError(
                    f"axis {key!r} does not name an experiment key: "
                    f"{head!r} is not one of {sorted(TOP_LEVEL_KEYS)}")
            if head in ("name", "report_dir"):
                raise SweepError(
                    f"axis {key!r} is not sweepable: the sweep owns cell "
                    f"{head}s (they key resume detection and report paths)")
            if not isinstance(values, (list, tuple)) or not values:
                raise SweepError(
                    f"axis {key!r} must map to a non-empty list of values, "
                    f"got {values!r}")
            if norm in axes:
                raise SweepError(
                    f"axis {key!r} duplicates axis {norm!r} "
                    f"(plural aliases normalize: {AXIS_ALIASES})")
            axes[norm] = list(values)

        cache = raw.get("cache")
        if isinstance(cache, Mapping):
            unknown = sorted(set(cache) - {"dir"})
            if unknown:
                raise SweepError(
                    f"unknown key(s) {unknown} in sweep.cache; allowed: ['dir']")
            cache = cache.get("dir")
        if cache is True:  # same shorthand the experiment-level section takes
            from repro_torch.evaluation.disk_cache import DEFAULT_DIR

            cache = DEFAULT_DIR
        elif cache is False:
            cache = None

        workers = raw.get("workers")
        if workers is not None:
            if (not isinstance(workers, (list, tuple)) or not workers
                    or not all(isinstance(w, str) for w in workers)):
                raise SweepError(
                    "sweep.workers must be a non-empty list of 'host:port' "
                    "strings")
            for w in workers:
                host, _, port = w.rpartition(":")
                if not host or not port.isdigit():
                    raise SweepError(
                        f"sweep.workers address {w!r} is not host:port")
            workers = [str(w) for w in workers]
        return cls(
            name=str(raw.get("name", "sweep")),
            base=base,
            axes=axes,
            cache=None if cache is None else str(cache),
            report_dir=str(raw.get("report_dir", "results")),
            workers=workers,
        )

    @classmethod
    def from_yaml(cls, path: str) -> "SweepSpec":
        return cls.from_dict(_load_yaml(path),
                             base_dir=os.path.dirname(os.path.abspath(path)))

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "base": copy.deepcopy(self.base),
            "axes": {k: copy.deepcopy(v) for k, v in self.axes.items()},
            "report_dir": self.report_dir,
        }
        if self.cache is not None:
            d["cache"] = self.cache
        if self.workers is not None:
            d["workers"] = list(self.workers)
        return d

    # -- expansion -------------------------------------------------------------

    @property
    def cells_dir(self) -> str:
        return os.path.join(self.report_dir, f"{self.name}.cells")

    def expand(self, overrides: Optional[Dict[str, Any]] = None,
               device: Optional[str] = None, pool: bool = False) -> List[SweepCell]:
        """Cross product of the axes -> validated child specs, in a
        deterministic order (axes in declaration order, values in list
        order).  ``overrides`` are dotted-key constants applied to every
        cell AFTER its axis values — they win even over a whole-section
        axis (the CLI's ``--trials``/``--workers`` shrink knobs).  A
        child that fails validation raises a :class:`SweepError` naming
        the offending axis values.  With ``device="cpu"`` a cell whose
        target runs on CUDA is such a failure unless a cell ``pool`` of
        worker daemons will run it: nothing moves to the CPU in its
        place."""
        keys = list(self.axes)
        cells: List[SweepCell] = []
        seen: Dict[str, Dict[str, str]] = {}
        for combo in itertools.product(*(self.axes[k] for k in keys)):
            doc = copy.deepcopy(self.base)
            labels = {k: _axis_label(v) for k, v in zip(keys, combo)}
            for key, value in zip(keys, combo):
                _set_dotted(doc, key, value)
            for key, value in (overrides or {}).items():
                _set_dotted(doc, key, value)
            cell_name = "--".join(
                [re.sub(r"[^A-Za-z0-9._-]+", "-", str(self.base.get("name", "experiment")))]
                + [f"{k}={labels[k]}" for k in keys])
            if cell_name in seen:
                raise SweepError(
                    f"cell name {cell_name!r} is ambiguous: axis values "
                    f"{seen[cell_name]} and {labels} produce the same label — "
                    f"give the colliding components distinguishing names")
            seen[cell_name] = labels
            doc["name"] = cell_name
            doc["report_dir"] = self.cells_dir
            if self.cache is not None:
                doc["cache"] = {"dir": self.cache}
            at = ", ".join(f"{k}={labels[k]}" for k in keys)
            try:
                spec = ExperimentSpec.from_dict(doc)
            except ExplorerError as e:
                raise SweepError(f"cell [{at}]: {e}") from e
            cell = SweepCell(name=cell_name, axes=labels,
                             axis_values=dict(zip(keys, combo)), spec=spec)
            if device is not None and cell.device == "cuda" and not pool \
                    and torch.device(device).type == "cpu":
                raise SweepError(
                    f"cell [{at}]: target {spec.target!r} runs its candidates on "
                    f"cuda, but the sweep was asked to run on cpu: drop it from "
                    f"the axis, run on the card (--device cuda), or fan the cells "
                    f"to daemons on a card (workers:, --cell-workers)")
            cells.append(cell)
        return cells


# ---------------------------------------------------------------------------
# report merging
# ---------------------------------------------------------------------------

def _better(a: float, b: float, direction: str) -> bool:
    return a < b if direction == "minimize" else a > b


def _criteria_directions(base: Dict[str, Any]) -> Dict[str, str]:
    return {c["estimator"]: c.get("direction", "minimize")
            for c in base.get("criteria", [])}


def _objective_names(base: Dict[str, Any]) -> List[str]:
    return [c["estimator"] for c in base.get("criteria", [])
            if c.get("kind", "objective") == "objective"]


def _dominates(a: List[float], b: List[float], signs: List[float]) -> bool:
    no_worse = all(sa * va <= sa * vb for sa, va, vb in zip(signs, a, b))
    better = any(sa * va < sa * vb for sa, va, vb in zip(signs, a, b))
    return no_worse and better


def _cell_axis(cell: Dict[str, Any], axis: str, fallback_key: str,
               base: Dict[str, Any]) -> str:
    """Axis label of a merged cell; cells not fanned over that axis all
    share the base spec's value (one-row / one-column matrix)."""
    label = cell["axes"].get(axis)
    if label is not None:
        return label
    node = base.get(fallback_key)
    return _axis_label(node if node is not None else "default")


@dataclasses.dataclass
class SweepReport:
    """Merged comparative view over every cell, JSON end to end."""

    sweep: str
    axes: Dict[str, List[str]]              # axis -> value labels, in order
    n_cells: int
    n_resumed: int
    cells: List[Dict[str, Any]]             # per-cell summary incl. best trial
    matrix: Dict[str, Dict[str, Dict[str, Optional[float]]]]
    pareto_union: List[Dict[str, Any]]      # cross-target non-dominated union
    target_rankings: Dict[str, List[Dict[str, Any]]]
    cache: Optional[Dict[str, Any]]
    wall_clock_s: float
    toolchain: Dict[str, str]
    spec: Dict[str, Any]                    # the sweep spec that produced this
    artifact: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.artifact = path
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path


def _summarize_cell(cell: SweepCell, report: Dict[str, Any],
                    resumed: bool) -> Dict[str, Any]:
    return {
        "name": cell.name,
        "axes": dict(cell.axes),
        "resumed": resumed,
        "best": report.get("best"),
        "criteria_values": report.get("criteria_values") or {},
        "pareto_front": report.get("pareto_front") or [],
        "n_trials": report.get("n_trials"),
        "states": report.get("states"),
        "wall_clock_s": report.get("wall_clock_s"),
        "cache": report.get("cache"),
        "target": report.get("target"),
        "artifact": report.get("artifact"),
    }


def merge_reports(spec: SweepSpec, summaries: List[Dict[str, Any]],
                  n_resumed: int, wall_clock_s: float) -> SweepReport:
    """Fold per-cell report dicts into the comparative views.  Pure and
    deterministic: same summaries in, same report out, so a resumed sweep
    merges identically to an uninterrupted one."""
    from repro_torch.evaluation.disk_cache import toolchain_versions

    base = spec.base
    directions = _criteria_directions(base)
    objectives = _objective_names(base)
    signs = [1.0 if directions.get(n, "minimize") == "minimize" else -1.0
             for n in objectives]

    # -- per-criterion best-value matrix: target x sampler -------------------
    matrix: Dict[str, Dict[str, Dict[str, Optional[float]]]] = {}
    for crit, direction in directions.items():
        grid: Dict[str, Dict[str, Optional[float]]] = {}
        for cell in summaries:
            t = _cell_axis(cell, "target", "target", base)
            s = _cell_axis(cell, "sampler", "sampler", base)
            value = (cell["criteria_values"] or {}).get(crit)
            row = grid.setdefault(t, {})
            prev = row.get(s)
            if value is not None and (prev is None
                                      or _better(value, prev, direction)):
                row[s] = value
            elif s not in row:
                row[s] = value
        matrix[crit] = grid

    # -- cross-target Pareto union over the objective criteria ---------------
    points: List[Tuple[Dict[str, Any], List[float]]] = []
    for cell in summaries:
        for entry in cell["pareto_front"]:
            values = entry.get("objective_values")
            if values is None or len(values) != len(objectives):
                continue
            tagged = dict(entry)
            tagged["cell"] = cell["name"]
            tagged["target"] = _cell_axis(cell, "target", "target", base)
            tagged["sampler"] = _cell_axis(cell, "sampler", "sampler", base)
            points.append((tagged, [float(v) for v in values]))
    union = [entry for entry, vals in points
             if not any(_dominates(other, vals, signs) for _, other in points)]
    union.sort(key=lambda e: (e.get("objective_values") or [], e["cell"]))

    # -- which target wins under which criterion weighting -------------------
    rankings: Dict[str, List[Dict[str, Any]]] = {}
    profiles = [(crit, lambda c, crit=crit: (c["criteria_values"] or {}).get(crit),
                 directions[crit]) for crit in directions]
    if base.get("scalarize", True):
        # the declared weighting = the scalarized study score itself
        profiles.append(("declared_weights",
                         lambda c: (c["best"] or {}).get("values", [None])[0],
                         "minimize"))
    for profile, extract, direction in profiles:
        per_target: Dict[str, Dict[str, Any]] = {}
        for cell in summaries:
            t = _cell_axis(cell, "target", "target", base)
            value = extract(cell)
            if value is None:
                continue
            cur = per_target.get(t)
            if cur is None or _better(value, cur["value"], direction):
                per_target[t] = {"target": t, "value": float(value),
                                 "cell": cell["name"]}
        ranked = sorted(per_target.values(),
                        key=lambda r: (r["value"] if direction == "minimize"
                                       else -r["value"], r["target"]))
        rankings[profile] = ranked

    # -- aggregated cache / compaction hygiene --------------------------------
    counters = ("hits", "disk_hits", "misses",
                "compactions", "dropped_superseded", "dropped_lru")
    totals: Dict[str, Any] = dict.fromkeys(counters, 0)
    seen_any = False
    for cell in summaries:
        stats = cell.get("cache")
        if not isinstance(stats, dict):
            continue
        seen_any = True
        for k in counters:
            totals[k] += int(stats.get(k, 0))
    if seen_any:
        lookups = totals["hits"] + totals["disk_hits"] + totals["misses"]
        totals["hit_rate"] = ((totals["hits"] + totals["disk_hits"]) / lookups
                              if lookups else 0.0)

    return SweepReport(
        sweep=spec.name,
        axes={k: [_axis_label(v) for v in vs] for k, vs in spec.axes.items()},
        n_cells=len(summaries),
        n_resumed=n_resumed,
        cells=summaries,
        matrix=matrix,
        pareto_union=union,
        target_rankings=rankings,
        cache=totals if seen_any else None,
        wall_clock_s=wall_clock_s,
        toolchain=toolchain_versions(),
        spec=spec.to_dict(),
    )


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _load_completed_cell(cell: SweepCell) -> Optional[Dict[str, Any]]:
    """A persisted report counts as this cell iff it embeds the identical
    spec (so editing the sweep re-runs affected cells) and already holds
    the full trial budget.  The spec is compared in its JSON form, the
    one the report was written in (a traffic mix's integer lengths come
    back from JSON as strings)."""
    try:
        with open(cell.report_path) as f:
            persisted = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if persisted.get("spec") != json.loads(json.dumps(cell.spec.to_dict())):
        return None
    n_trials = persisted.get("n_trials") or 0
    if n_trials < cell.spec.budget.n_trials:
        return None
    return persisted


def _run_cell(spec_dict: Dict[str, Any], device: str) -> Dict[str, Any]:
    """Worker-side cell execution: rebuild the validated spec, run it on
    the cell's ``device``, return the report as a plain dict
    (module-level, so it crosses the wire as a picklable ``("call", ...)``
    task).  The *parent* persists the report — the worker's filesystem
    may not be the submitting host's."""
    from repro_torch.explorer.explorer import Explorer

    spec = ExperimentSpec.from_dict(spec_dict)
    return Explorer.from_spec(spec, device=device).run(save_report=False).to_dict()


def _persist_cell_report(cell: SweepCell, report: Dict[str, Any]) -> None:
    """Write a remotely-computed cell report exactly where a local run
    would have (same path, same shape), so per-cell resume works
    identically whichever side executed the cell."""
    path = cell.report_path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    report["artifact"] = path  # self-locate, like ExplorationReport.save
    with open(path, "w") as f:
        f.write(json.dumps(report, indent=2, sort_keys=True) + "\n")


def _dispatch_cells(addrs: List[str],
                    cells: List[SweepCell]) -> Dict[str, Dict[str, Any]]:
    """Fan independent cells across the worker pool; returns completed
    ``{cell name: report dict}``.  Cells whose workers die are
    resubmitted to siblings by the client; cells that still fail (or a
    pool with zero reachable workers) are simply *absent* from the
    result, and the caller runs them locally — the sweep always
    completes."""
    import pickle
    import queue as queue_module
    import warnings

    from repro_torch.search.remote.client import RemoteClient

    client = RemoteClient(list(addrs))
    done: "queue_module.SimpleQueue" = queue_module.SimpleQueue()
    results: Dict[str, Dict[str, Any]] = {}
    try:
        if not client.connect():
            warnings.warn(
                f"no sweep workers reachable among {list(addrs)}; running "
                f"all cells locally", RuntimeWarning, stacklevel=2)
            return results
        for cell in cells:
            payload = pickle.dumps(
                ("call", (_run_cell, (cell.spec.to_dict(), cell.device), {})),
                protocol=pickle.HIGHEST_PROTOCOL)
            client.submit(cell.name, lambda payload=payload: payload,
                          lambda key, value, error, worker: done.put(
                              (key, value, error)))
        for _ in cells:
            name, value, error = done.get()
            if error is not None or not isinstance(value, dict):
                warnings.warn(
                    f"sweep cell {name!r} failed remotely "
                    f"({error!r}); re-running it locally",
                    RuntimeWarning, stacklevel=2)
                continue
            results[name] = value
    finally:
        client.close()
    return results


def run_sweep(spec: SweepSpec, resume: bool = True, save_report: bool = True,
              overrides: Optional[Dict[str, Any]] = None,
              workers: Optional[List[str]] = None,
              device: str = "cuda") -> SweepReport:
    """Expand (applying any post-axis ``overrides``), run every cell
    through :class:`Explorer` (skipping cells a previous run already
    completed, when ``resume``), merge, and persist
    ``<report_dir>/<name>.sweep.json``.

    ``device`` is the device asked for (CUDA unless the caller asks for
    the CPU, and CUDA only with a card).  Each cell runs on its target's
    device (``h100`` on CUDA; ``host_cpu`` and ``edge_npu`` on the CPU); a
    sweep asked to run on the CPU refuses at expansion a cell whose target
    runs on CUDA, unless a pool of worker daemons is given: such a cell
    then runs only on the pool, and a pool that cannot complete it raises
    a :class:`SweepError` before any cell runs here.

    With ``workers`` (argument wins over ``spec.workers``), cells that
    are not resumed fan out across the worker-daemon pool as independent
    tasks, each run on its target's device there: cells already carry
    resume fingerprints and share the disk cache, which is what makes
    them safely resubmittable on worker failure.  Completed-cell reports
    are persisted by the parent at the exact local paths, so a remote
    sweep resumes the same as a local one; cells the pool cannot complete
    fall back to local execution.  Merged summaries stay in deterministic
    cell order regardless of remote completion order."""
    from repro_torch.explorer.explorer import Explorer

    host = resolve_device(device)
    pool = workers if workers is not None else spec.workers
    cells = spec.expand(overrides, device=device, pool=bool(pool))
    summaries: List[Dict[str, Any]] = []
    n_resumed = 0
    t0 = time.perf_counter()

    resumed: Dict[str, Dict[str, Any]] = {}
    pending: List[SweepCell] = []
    for cell in cells:
        persisted = _load_completed_cell(cell) if resume else None
        if persisted is not None:
            resumed[cell.name] = persisted
        else:
            pending.append(cell)

    remote: Dict[str, Dict[str, Any]] = {}
    if pool and pending:
        remote = _dispatch_cells(list(pool), pending)
    stranded = [c.name for c in pending
                if c.name not in remote and c.device == "cuda" and host.type == "cpu"]
    if stranded:
        raise SweepError(
            f"cells {stranded} run on cuda, which this host has not, and the pool "
            f"{list(pool)} did not complete them; they are not run here in its place")

    for cell in cells:
        if cell.name in resumed:
            n_resumed += 1
            summaries.append(_summarize_cell(cell, resumed[cell.name],
                                             resumed=True))
            continue
        report_dict = remote.get(cell.name)
        if report_dict is not None:
            _persist_cell_report(cell, report_dict)
        else:  # no pool, unreachable pool, or a cell the pool failed
            report_dict = Explorer.from_spec(cell.spec, device=cell.device).run(
                save_report=True).to_dict()
        summaries.append(_summarize_cell(cell, report_dict, resumed=False))
    wall_clock = time.perf_counter() - t0

    merged = merge_reports(spec, summaries, n_resumed, wall_clock)
    if save_report:
        merged.save(os.path.join(spec.report_dir, f"{spec.name}.sweep.json"))
    return merged
