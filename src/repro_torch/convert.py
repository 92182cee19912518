"""Weights and caches carried across from the JAX package.

A NAS candidate's tree is ``{"layer_<i>": {leaf: array}}`` on both sides;
the one leaf whose layout differs is a conv's ``w``, (K, C_in, C_out) in
the JAX package and (C_out, C_in, K) in the port.

The JAX ``LM`` keeps a segment's layers stacked on a leading ``layers``
axis under ``params[seg]["sub_<i>"]["norm" | "inner"]``; the port keeps
one module per layer (``<seg>.<layer>.subs.<i>.norm`` / ``.inner``).
Matrices keep their ``(in, out)`` layout on both sides.  The inputs here
are nested dicts of numpy arrays (the JAX tree after ``split``, converted
by the caller), so this module needs nothing of JAX.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.builder import BuiltModel
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM, Cache
from repro_torch.models.specs import ModelSpec

_SUB = re.compile(r"sub_(\d+)$")
_LAYER = re.compile(r"layer_(\d+)$")
# op -> {leaf: axes permutation from the JAX layout to the port's}
_CANDIDATE_LAYOUT = {"conv1d": {"w": (2, 1, 0)}}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _port_keys(model: LM, path: Tuple[str, ...], arr: np.ndarray):
    """(port state-dict key, array) pairs for one JAX leaf; unstacks a
    segment's leading layers axis."""
    segs = {seg.name: seg for seg in model.segments}
    if path[0] not in segs:
        return [(".".join(path), arr)]
    seg = segs[path[0]]
    m = _SUB.match(path[1]) if len(path) > 3 else None
    if m is None or path[2] not in ("norm", "inner"):
        return [("/".join(path), arr)]  # unexpected: reported by the caller
    if arr.ndim == 0 or arr.shape[0] != seg.count:
        raise ValueError(f"{'/'.join(path)}: expected a leading layers axis of "
                         f"{seg.count}, got shape {arr.shape}")
    tail = ".".join(path[3:])
    return [(f"{seg.name}.{i}.subs.{m.group(1)}.{path[2]}.{tail}", arr[i])
            for i in range(seg.count)]


def _load_checked(model, state: Dict[str, np.ndarray], device, what: str):
    """Load numpy ``state`` into ``model`` on ``device``; raises on any
    missing or unexpected key and any wrong shape."""
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    wrong = sorted(f"{k}: {state[k].shape} != {expected[k]}"
                   for k in set(state) & set(expected)
                   if tuple(state[k].shape) != expected[k])
    if missing or unexpected or wrong:
        raise ValueError(f"JAX params do not fit {what}: missing {missing}, "
                         f"unexpected {unexpected}, wrong shapes {wrong}")
    tensors = {k: torch.from_numpy(np.array(v)).to(device) for k, v in state.items()}
    model.load_state_dict(tensors, strict=True, assign=True)
    return model


def candidate_from_jax(model: BuiltModel, params_np: Mapping[str, Any],
                       device="cuda") -> BuiltModel:
    """``model`` (built by the port's ``ModelBuilder`` from the same
    architecture) with the JAX candidate's weights: ``params_np`` is the
    JAX ``BuiltModel.init`` tree (after ``split``) with numpy leaves.
    Raises on any missing or unexpected leaf and any wrong shape."""
    device = resolve_device(device)
    state: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params_np):
        m = _LAYER.match(path[0])
        if m is not None and len(path) == 2 and int(m.group(1)) < len(model.layers):
            op = model.layers[int(m.group(1))].name.split("(")[0]
            perm = _CANDIDATE_LAYOUT.get(op, {}).get(path[1])
            if perm is not None and arr.ndim == len(perm):
                arr = arr.transpose(perm)
        state[".".join(path)] = arr
    return _load_checked(model, state, device, f"candidate {model.arch.signature()}")


def lm_from_jax(spec: ModelSpec, params_np: Mapping[str, Any],
                device="cuda") -> LM:
    """The port's :class:`LM` with the JAX package's weights.

    ``params_np`` is the JAX ``LM.init`` tree after ``split``, with numpy
    leaves.  Raises on any missing or unexpected key and any wrong shape.
    """
    device = resolve_device(device)
    model = LM(spec)
    state: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params_np):
        for key, leaf in _port_keys(model, path, arr):
            state[key] = leaf
    return _load_checked(model, state, device, spec.name)


def cache_from_jax(spec: ModelSpec, cache_np: Mapping[str, Any],
                   device="cuda") -> Cache:
    """The JAX decode cache (``{seg: {sub_<i>: {"k", "v"}}}``, stacked on
    a leading layers axis) as the port's per-layer list of ``{"k", "v"}``."""
    device = resolve_device(device)
    model = LM(spec)
    if set(cache_np) != {seg.name for seg in model.segments}:
        raise ValueError(f"cache segments {sorted(cache_np)} do not match "
                         f"{[seg.name for seg in model.segments]}")
    out: Cache = []
    for seg in model.segments:
        subs = cache_np[seg.name]
        kinds = {f"sub_{i}": s.kind for i, s in enumerate(seg.spec.subs)}
        if set(subs) != set(kinds):
            raise ValueError(f"{seg.name}: cache subs {sorted(subs)} != {sorted(kinds)}")
        for name, kind in kinds.items():
            want = {"k", "v"} if kind == "attention" else set()
            if set(subs[name]) != want:
                raise ValueError(f"{seg.name}/{name} ({kind}): cache keys "
                                 f"{sorted(subs[name])} != {sorted(want)}")
        (attn_name,) = [n for n, k in kinds.items() if k == "attention"]
        entry = subs[attn_name]
        for i in range(seg.count):
            out.append({kv: torch.from_numpy(np.array(entry[kv][i])).to(device)
                        for kv in ("k", "v")})
    return out
