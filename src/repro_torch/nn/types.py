"""Logical axes of parameters, the JAX package's ``nn/types.py`` on the
port.

Every parameter a layer's ``init`` creates is passed through :func:`P`,
which tags the tensor with one *logical axis* name per dimension
("embed", "mlp", "heads", "vocab", "experts", ...), as the reference's
``P(value, axes)`` does.  A module that registers such tensors
(:func:`frozen`, or an ``LM``'s own leaves) records the tags by
parameter name, so they outlive ``load_state_dict(assign=True)``, and
:func:`param_axes` collects them under the model's state-dict names.
The distribution layer (:mod:`repro_torch.distributed.sharding`) maps
them onto mesh axes.

The JAX package stacks a segment's layers on a leading axis and its axes
describe the trailing dims; the port keeps one tensor a layer, so a
layer's tensor carries the reference's tuple as it is.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

Axes = Tuple[Optional[str], ...]

_TAG = "logical_axes"


def P(value: torch.Tensor, axes: Axes) -> torch.Tensor:
    """``value`` tagged with its logical axes (one name or None a dim)."""
    if len(axes) != value.dim():
        raise ValueError(f"axes {axes} do not fit a tensor of shape {tuple(value.shape)}")
    setattr(value, _TAG, tuple(axes))
    return value


def axes_of(value) -> Optional[Axes]:
    """The logical axes :func:`P` gave ``value``, or None."""
    return getattr(value, _TAG, None)


def record_axes(module: nn.Module, name: str, value) -> None:
    """Note ``value``'s logical axes as those of ``module``'s parameter
    ``name`` (nothing when it has none)."""
    axes = axes_of(value)
    if axes is not None:
        vars(module).setdefault("_param_axes", {})[name] = axes


def frozen(tensors: Mapping[str, Any]) -> nn.ParameterDict:
    """Frozen parameters (``requires_grad=False``) with their logical axes
    recorded; a nested dict (MoE's dense branch) nests."""
    out = nn.ParameterDict({k: frozen(v) if isinstance(v, Mapping)
                            else nn.Parameter(v, requires_grad=False)
                            for k, v in tensors.items()})
    for k, v in tensors.items():
        if not isinstance(v, Mapping):
            record_axes(out, k, v)
    return out


def param_axes(model: nn.Module) -> Dict[str, Optional[Axes]]:
    """``{state-dict name: logical axes}`` for every parameter of
    ``model``; None for a parameter created without axes."""
    declared: Dict[str, Axes] = {}
    for prefix, mod in model.named_modules():
        for name, axes in vars(mod).get("_param_axes", {}).items():
            declared[f"{prefix}.{name}" if prefix else name] = axes
    return {name: declared.get(name) for name, _ in model.named_parameters()}


def _values(tree):
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _values(v)]
    return [tree]


def param_count(tree) -> int:
    """Elements of a model's parameters, or of a mapping of tensors."""
    return sum(int(t.numel()) for t in _values(tree))


def param_bytes(tree) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _values(tree))
