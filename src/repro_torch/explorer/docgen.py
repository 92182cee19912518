"""Generate the port's reference docs from the code that enforces them
(the JAX package's ``explorer/docgen.py`` on the port).

The YAML surface (experiment/sweep keys, registered components, REPRO_*
environment knobs) is large enough that hand-maintained prose drifts.
This module walks the *actual* sources of truth — the spec dataclasses'
fields + ``FIELD_DOCS``/``KEYS`` validation metadata, the component
registries (with constructor signatures), and the
:data:`repro_torch.envvars.ENV_VARS` registry — and renders markdown.

The port's surface is not the reference's: its targets are ``h100``,
``host_cpu``, ``edge_npu`` and the pods ``h100_pod``/``h100_2pod`` (a spec
naming a TPU target is refused at parse time), every target names the
device its candidates run on, and its estimators, executors and knobs
are its own.  So it renders its own reference,
``docs/reference/torch/*.md``, beside the JAX package's
``docs/reference/*.md``, which stay the reference's.

Consumers:

* ``scripts/gen_docs_torch.py`` writes/checks ``docs/reference/torch/*.md``;
* ``python -m repro_torch.explorer --list-components`` prints the
  component walk as text.

``scripts/gen_docs_torch.py --check`` fails when a change to the YAML
surface, a registry or an env knob was not regenerated.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List

GENERATED_BANNER = (
    "<!-- GENERATED FILE — do not edit by hand.\n"
    "     Regenerate with: PYTHONPATH=src python scripts/gen_docs_torch.py -->\n"
)

# ---------------------------------------------------------------------------
# component walk (registries)
# ---------------------------------------------------------------------------

def _constructor_signature(obj: Any) -> str:
    """``(seed=None, gamma=0.25, ...)`` for classes; '' for instances."""
    if not inspect.isclass(obj):
        return ""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return ""
    params = [str(p) for name, p in sig.parameters.items()
              if name not in ("self", "args", "kwargs")]
    return f"({', '.join(params)})"


def _summary(obj: Any) -> str:
    # the class's OWN docstring only: an inherited one describes the base
    # class machinery, not the registered component
    cls = obj if inspect.isclass(obj) else type(obj)
    doc = (cls.__dict__.get("__doc__") or "").strip()
    if not doc or doc.startswith(f"{cls.__name__}("):
        return ""  # absent, or a dataclass-autogenerated signature
    return doc.splitlines()[0].strip()


def walk_components() -> Dict[str, List[Dict[str, Any]]]:
    """Every registry kind -> its entries, resolved from the live
    registries (plugins included, if imported)."""
    from repro_torch.explorer.registry import REGISTRIES, ensure_builtins

    ensure_builtins()
    out: Dict[str, List[Dict[str, Any]]] = {}
    for kind in sorted(REGISTRIES):
        registry = REGISTRIES[kind]
        entries: List[Dict[str, Any]] = []
        for name in registry.names():
            obj = registry.get(name)
            entry: Dict[str, Any] = {
                "name": name,
                "class": (obj.__name__ if inspect.isclass(obj)
                          else type(obj).__name__),
                "signature": _constructor_signature(obj),
                "summary": _summary(obj),
            }
            if kind == "target":  # instances: surface the chip constants
                entry["target"] = obj.to_dict()
            entries.append(entry)
        out[kind] = entries
    return out


def list_components_text() -> str:
    """Human-readable walk for ``--list-components``."""
    lines: List[str] = []
    for kind, entries in walk_components().items():
        lines.append(f"{kind} ({len(entries)}):")
        for e in entries:
            sig = f" {e['signature']}" if e["signature"] else ""
            lines.append(f"  {e['name']:<20} {e['class']}{sig}")
            if e["summary"]:
                lines.append(f"  {'':<20} {e['summary']}")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def components_markdown() -> str:
    parts = [GENERATED_BANNER, "# Component reference (the PyTorch port)", "",
             "Every string key addressable from experiment/sweep YAML run by",
             "`python -m repro_torch.explorer`, as registered in",
             "`repro_torch/explorer/registry.py`.  Plugins added via",
             "`@register_component(kind, name)` join these tables at runtime.",
             ""]
    for kind, entries in walk_components().items():
        parts.append(f"## `{kind}`")
        parts.append("")
        if kind == "target":
            parts.append("| key | chip | peak FLOP/s (bf16) | HBM B/s | "
                         "link B/s | HBM bytes | mesh | measurement | device |")
            parts.append("|---|---|---|---|---|---|---|---|---|")
            for e in entries:
                t = e["target"]
                chip = t["chip"]
                mesh = "x".join(str(s) for s in t["mesh_shape"])
                parts.append(
                    f"| `{e['name']}` | {chip['name']} | "
                    f"{chip['peak_flops_bf16']:.3g} | "
                    f"{chip['hbm_bandwidth']:.3g} | "
                    f"{chip['ici_bandwidth']:.3g} | "
                    f"{chip['hbm_bytes']} | {mesh} | {t['measurement']} | "
                    f"{t['device']} |")
        else:
            parts.append("| key | class | constructor | summary |")
            parts.append("|---|---|---|---|")
            for e in entries:
                sig = (f"`{e['signature'].replace('|', chr(92) + '|')}`"
                       if e["signature"] else "—")
                summary = e["summary"].replace("|", "\\|")
                parts.append(f"| `{e['name']}` | `{e['class']}` | {sig} | "
                             f"{summary} |")
        parts.append("")
    return "\n".join(parts).rstrip() + "\n"


# ---------------------------------------------------------------------------
# experiment / sweep spec walk (validation metadata)
# ---------------------------------------------------------------------------

def _spec_rows(cls: Any) -> List[Dict[str, str]]:
    """One row per declared key of a spec dataclass: name, default (from
    the dataclass field), description (from FIELD_DOCS)."""
    docs: Dict[str, str] = getattr(cls, "FIELD_DOCS", {})
    fields = {f.name: f for f in dataclasses.fields(cls)}
    keys = list(getattr(cls, "KEYS", fields))
    # SamplerSpec/PrunerSpec carry free-form options; document them too
    for extra in docs:
        if extra not in keys:
            keys.append(extra)
    rows = []
    for key in keys:
        f = fields.get(key)
        if f is None or f.default is dataclasses.MISSING:
            if f is not None and f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                default = repr(f.default_factory())
            else:
                default = "—"
        else:
            default = repr(f.default)
        desc = docs.get(key)
        if desc is None:
            raise AssertionError(
                f"{cls.__name__}.FIELD_DOCS is missing key {key!r} — the "
                f"generated reference would silently omit it")
        rows.append({"key": key, "default": default, "description": desc})
    return rows


def _spec_table(title: str, cls: Any, note: str = "") -> List[str]:
    parts = [f"## `{title}`", ""]
    if note:
        parts += [note, ""]
    parts += ["| key | default | description |", "|---|---|---|"]
    for row in _spec_rows(cls):
        parts.append(f"| `{row['key']}` | `{row['default']}` | "
                     f"{row['description']} |")
    parts.append("")
    return parts


def fidelity_markdown() -> str:
    """The experiment reference's three ``fidelity`` tables (the section,
    a stage, a stage's keep rule), as the reference renders them into
    ``docs/reference/experiment_spec.md``."""
    from repro_torch.explorer.experiment import FidelitySpec, KeepSpec, StageSpec

    parts = _spec_table(
        "fidelity", FidelitySpec,
        note="The multi-fidelity evaluation cascade: cohorts are screened "
             "in-process through the declared stages (cheapest first) and "
             "only survivors reach the executor for the compiled top-level "
             "criteria.  Screened-out trials end in state `screened` with "
             "`user_attrs[\"fidelity_stage\"]` naming the cutting stage.")
    parts += _spec_table(
        "fidelity.stages[i]", StageSpec,
        note="One screening stage; estimator names must be unique across "
             "all stages *and* the top-level criteria.")
    parts += _spec_table(
        "fidelity.stages[i].keep", KeepSpec,
        note="Exactly one of the three keys; stage scores scalarize "
             "through the experiment aggregator, lower = better.")
    return "\n".join(parts).rstrip() + "\n"


def serving_markdown() -> str:
    """The experiment reference's ``serving`` and ``serving.traffic``
    tables, as the reference renders them."""
    from repro_torch.explorer.experiment import ServingSpec
    from repro_torch.launch.traffic import TrafficSpec

    parts = _spec_table(
        "serving", ServingSpec,
        note="The serving section the traffic-shaped estimators "
             "(`prefill_latency_s`, `decode_latency_s`, "
             "`kv_cache_peak_bytes`, `throughput_tok_s`, `p99_latency_s`) "
             "evaluate candidates under, and the configuration "
             "`python -m repro_torch.launch.serve --from-report` boots with.  "
             "Omitting the section leaves the defaults.")
    parts += _spec_table(
        "serving.traffic", TrafficSpec,
        note="A declared, seeded traffic mix: the same seed replays the "
             "same arrivals, lengths and prompt tokens on every backend, so "
             "fixed-seed sweeps rank serving criteria deterministically.")
    return "\n".join(parts).rstrip() + "\n"


def experiment_spec_markdown() -> str:
    from repro_torch.explorer.experiment import (
        TOP_LEVEL_DOCS,
        TOP_LEVEL_KEYS,
        BudgetSpec,
        CacheSpec,
        CriterionSpec,
        ExecutorSpec,
        FaultsSpec,
        KernelTuningSpec,
        PrunerSpec,
        SamplerSpec,
        ScheduleSpec,
    )
    from repro_torch.explorer.sweep import SWEEP_KEYS, SweepSpec

    missing = sorted(set(TOP_LEVEL_KEYS) - set(TOP_LEVEL_DOCS))
    if missing:
        raise AssertionError(
            f"TOP_LEVEL_DOCS is missing experiment key(s) {missing}")

    parts = [GENERATED_BANNER, "# Experiment & sweep YAML reference (the PyTorch port)", "",
             "What `python -m repro_torch.explorer` accepts.  Validation is",
             "eager: unknown keys name the allowed set, unknown component",
             "names list the registered alternatives, and component options",
             "are bound against the constructor at parse time — a typo fails",
             "before trial 0, not at trial 37.  The JAX package's TPU",
             "targets are refused: the port carries no TPU rates.  A file",
             "ending in `.json` is read without PyYAML.",
             "",
             "## Experiment document (top level)", "",
             "| key | description |", "|---|---|"]
    for key in TOP_LEVEL_KEYS:
        parts.append(f"| `{key}` | {TOP_LEVEL_DOCS[key]} |")
    parts.append("")
    parts += _spec_table("sampler", SamplerSpec)
    parts += _spec_table("executor", ExecutorSpec)
    parts += _spec_table("schedule", ScheduleSpec)
    parts += _spec_table(
        "criteria[i]", CriterionSpec,
        note="Each list entry is one criterion; scores aggregate by "
             "estimator name.")
    parts += fidelity_markdown().rstrip("\n").split("\n") + [""]
    parts += _spec_table(
        "kernel_tuning", KernelTuningSpec,
        note="Kernel-schedule tuning: the CUDA kernels' tile and chunk "
             "parameters become a per-target tuning dimension.  `cached` "
             "attaches a `ScheduleTuner` (winners persist in the experiment "
             "cache, keyed by kernel/shape-bucket/mesh scope — warm restarts "
             "re-tune nothing); `search` exposes the fields as "
             "`schedule:<kernel>:<field>` trial parameters.")
    parts += _spec_table("cache", CacheSpec)
    parts += _spec_table("budget", BudgetSpec)
    parts += _spec_table("pruner", PrunerSpec)
    parts += _spec_table(
        "faults", FaultsSpec,
        note="Deterministic fault injection (chaos testing a run on "
             "purpose): the validated plan is installed for the run and "
             "exported through `REPRO_FAULTS`, so spawned process workers "
             "replay the same seeded schedule.")
    parts += serving_markdown().rstrip("\n").split("\n") + [""]
    parts += ["## Sweep document", "",
              "A sweep fans one base experiment across axes "
              "(`python -m repro_torch.explorer sweep sweep.yaml`); every key:",
              ""]
    sweep_rows = _spec_rows(SweepSpec)
    row_keys = [r["key"] for r in sweep_rows]
    missing = sorted(set(SWEEP_KEYS) - set(row_keys))
    if missing:
        raise AssertionError(f"SweepSpec.FIELD_DOCS is missing {missing}")
    parts += ["| key | default | description |", "|---|---|---|"]
    for row in sweep_rows:
        parts.append(f"| `{row['key']}` | `{row['default']}` | "
                     f"{row['description']} |")
    parts.append("")
    return "\n".join(parts).rstrip() + "\n"


# ---------------------------------------------------------------------------
# environment variables (repro_torch.envvars registry)
# ---------------------------------------------------------------------------

def env_markdown() -> str:
    from repro_torch.envvars import ENV_VARS

    parts = [GENERATED_BANNER, "# Environment variables (the PyTorch port)", "",
             "Every `REPRO_*` knob the port reads, generated from the "
             "`repro_torch.envvars.ENV_VARS` registry — the same entries the "
             "readers parse with, so documented defaults and documented "
             "malformed-value fallbacks are the implemented ones.",
             "",
             "Unset or blank values silently use the default.  A malformed "
             "value emits a `RuntimeWarning` naming the variable and falls "
             "back — it never raises.",
             ""]
    for name in sorted(ENV_VARS):
        var = ENV_VARS[name]
        parts += [
            f"## `{name}`", "",
            var.description, "",
            f"- **expected:** {var.expected}",
            f"- **default:** {var.default}",
            f"- **on malformed values:** {var.malformed}",
            f"- **consulted by:** {var.consulted_by}",
            "",
        ]
    return "\n".join(parts).rstrip() + "\n"


# ---------------------------------------------------------------------------
# the generated file set
# ---------------------------------------------------------------------------

def generated_files() -> Dict[str, str]:
    """Relative path (from the repo root) -> rendered content."""
    return {
        "docs/reference/torch/experiment_spec.md": experiment_spec_markdown(),
        "docs/reference/torch/components.md": components_markdown(),
        "docs/reference/torch/env.md": env_markdown(),
    }
