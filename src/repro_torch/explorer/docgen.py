"""The component walk behind ``python -m repro_torch.explorer
--list-components``: every registry kind and the components the port has
registered under it, read from the live registries with constructor
signatures.

The JAX package's ``explorer/docgen.py`` also renders the committed
reference docs (``docs/reference/*.md``) from the experiment and sweep
spec metadata; those documents describe the reference, and the port has
no generator of its own for them.
"""
from __future__ import annotations

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
