"""String-keyed component registries for the Explorer facade.

Every pluggable piece of the NAS pipeline — samplers, executors,
estimators, pruners, hardware targets — is published here under a stable
string key, so a declarative :class:`~repro.explorer.experiment.ExperimentSpec`
can name components without importing their classes, and third-party
code can plug in new ones without touching the engine:

    from repro_torch.explorer.registry import register

    @register("sampler", "simulated_annealing")
    class SimulatedAnnealingSampler(BaseSampler):
        ...

The built-in classes self-register at import time (see
``repro_torch/search/samplers.py``, ``repro_torch/search/executors.py``,
``repro_torch/search/remote/executor.py``, ``repro_torch/search/pruners.py``,
``repro_torch/evaluation/estimators.py``, ``repro_torch/hwgen/targets.py``); :func:`ensure_builtins` imports those
modules on first lookup so a registry consulted before anything else is
imported still sees the full built-in set.

This module must stay import-light (stdlib only): the registering
modules import it at class-definition time, so any import of repro
internals here would be circular.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class ExplorerError(ValueError):
    """Base class for facade configuration errors."""


class UnknownComponentError(ExplorerError):
    """A spec named a component key that no registry entry matches."""

    def __init__(self, kind: str, name: str, known: List[str]):
        super().__init__(
            f"unknown {kind} {name!r}; registered {kind}s: {known or '(none)'}"
        )
        self.kind, self.name, self.known = kind, name, known


class Registry:
    """One string-keyed component namespace (e.g. all samplers)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, obj: Any = None):
        """Register ``obj`` under ``name``.  Usable as a decorator
        (``@SAMPLERS.register("random")``) or a direct call
        (``TARGETS.register("host_cpu", spec)``).  Re-registering the same
        object is a no-op; a different object under a taken key raises —
        silent shadowing of a built-in would make specs ambiguous."""

        def _add(target: Any) -> Any:
            key = str(name)
            existing = self._entries.get(key)
            if existing is not None and existing is not target:
                raise ExplorerError(
                    f"{self.kind} key {key!r} already registered to "
                    f"{existing!r}; pick a different key for {target!r}"
                )
            self._entries[key] = target
            return target

        if obj is None:
            return _add
        return _add(obj)

    def get(self, name: str) -> Any:
        ensure_builtins()
        try:
            return self._entries[str(name)]
        except KeyError:
            raise UnknownComponentError(self.kind, str(name), self.names()) from None

    def names(self) -> List[str]:
        ensure_builtins()
        return sorted(self._entries)

    def __contains__(self, name: object) -> bool:
        ensure_builtins()
        return str(name) in self._entries

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {sorted(self._entries)})"


SAMPLERS = Registry("sampler")
EXECUTORS = Registry("executor")
ESTIMATORS = Registry("estimator")
PRUNERS = Registry("pruner")
TARGETS = Registry("target")

REGISTRIES: Dict[str, Registry] = {
    "sampler": SAMPLERS,
    "executor": EXECUTORS,
    "estimator": ESTIMATORS,
    "pruner": PRUNERS,
    "target": TARGETS,
}


def register(kind: str, name: str, obj: Any = None):
    """Plugin entry point: ``@register("sampler", "my_sampler")``."""
    try:
        registry = REGISTRIES[kind]
    except KeyError:
        raise ExplorerError(
            f"unknown registry kind {kind!r}; known kinds: {sorted(REGISTRIES)}"
        ) from None
    return registry.register(name, obj)


_builtins_loaded = False


def ensure_builtins() -> None:
    """Import the modules whose classes self-register, exactly once.

    The flag is set before importing so the registration decorators
    running inside those imports (which may consult other registries)
    cannot recurse into a second load."""
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    import repro_torch.evaluation.estimators  # noqa: F401
    import repro_torch.evaluation.proxies  # noqa: F401
    import repro_torch.evaluation.serving  # noqa: F401
    import repro_torch.hwgen.targets  # noqa: F401
    import repro_torch.search.executors  # noqa: F401
    import repro_torch.search.pruners  # noqa: F401
    import repro_torch.search.remote.executor  # noqa: F401
    import repro_torch.search.samplers  # noqa: F401
