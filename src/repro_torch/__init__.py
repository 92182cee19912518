"""repro_torch: the PyTorch/CUDA port of the ``repro`` package.

The port mirrors ``repro``'s sub-packages and module names wherever a
reader looks for a counterpart, and keeps the JAX layouts at public
functions (attention in ``(B, S, H, D)``, weight matrices as
``(in, out)`` applied as ``x @ w``) so that the two packages can be held
against each other on the same inputs.  It imports nothing of ``repro``
and nothing of JAX.

The package initializer re-exports the Explorer facade, the stable front
API, lazily (PEP 562), so ``import repro_torch.kernels`` and friends do
not pay for the search/evaluation stack:

    from repro_torch import Explorer

    report = Explorer.from_yaml("examples/experiments/quickstart.yaml",
                                device="cpu").run()

Entry points run on CUDA unless the caller asks for the CPU; see
:func:`repro_torch.device.resolve_device`.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Explorer": "repro_torch.explorer.explorer",
    "ExplorationReport": "repro_torch.explorer.explorer",
    "ExperimentSpec": "repro_torch.explorer.experiment",
    "ExperimentError": "repro_torch.explorer.experiment",
    "ExplorerError": "repro_torch.explorer.registry",
    "UnknownComponentError": "repro_torch.explorer.registry",
    "register_component": "repro_torch.explorer.registry",
    "SweepSpec": "repro_torch.explorer.sweep",
    "SweepReport": "repro_torch.explorer.sweep",
    "SweepError": "repro_torch.explorer.sweep",
    "run_sweep": "repro_torch.explorer.sweep",
}

__all__ = sorted(_EXPORTS)

# public alias: `register` is too generic a name at the top level
_ALIASES = {"register_component": "register"}
# ...but `from repro_torch import register` answers too, outside __all__
_UNLISTED = {"register": "repro_torch.explorer.registry"}


def __getattr__(name: str):
    module = _EXPORTS.get(name) or _UNLISTED.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(module), _ALIASES.get(name, name))


def __dir__():
    return __all__
