"""The component walk behind ``python -m repro_torch.explorer
--list-components``: every registry kind and the components the port has
registered under it, read from the live registries with constructor
signatures; and the ``fidelity`` sections of the experiment reference,
rendered from the port's spec metadata (``FIELD_DOCS``/``KEYS``) as the
JAX package's ``explorer/docgen.py`` renders them.

The JAX package's ``explorer/docgen.py`` also renders the committed
reference docs (``docs/reference/*.md``) whole; those documents describe
the reference, and the port writes no file of its own for them.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List

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


# ---------------------------------------------------------------------------
# experiment spec walk (validation metadata)
# ---------------------------------------------------------------------------

def _spec_rows(cls: Any) -> List[Dict[str, str]]:
    """One row per declared key of a spec dataclass: name, default (from
    the dataclass field), description (from FIELD_DOCS)."""
    docs: Dict[str, str] = getattr(cls, "FIELD_DOCS", {})
    fields = {f.name: f for f in dataclasses.fields(cls)}
    keys = list(getattr(cls, "KEYS", fields))
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
