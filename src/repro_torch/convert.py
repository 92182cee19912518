"""Weights and caches carried across from the JAX package.

A NAS candidate's tree is ``{"layer_<i>": {leaf: array}}`` on both sides;
the one leaf whose layout differs is a conv's ``w``, (K, C_in, C_out) in
the JAX package and (C_out, C_in, K) in the port.

The JAX ``LM`` keeps a segment's layers stacked on a leading ``layers``
axis under ``params[seg]["sub_<i>"]["norm" | "inner"]`` (the decoder's
``seg_<i>`` and the encoder's ``enc_<i>``), and the weight-shared layer
unstacked under ``params["shared"]``; the port keeps one module per
layer (``<seg>.<layer>.subs.<i>.norm`` / ``.inner``, and
``shared.subs.<i>...``).  The other leaves (``embed``, ``pos_embed``,
``head``, ``final_norm``, ``enc_final_norm``) keep their names.  A tree
shaped like an ``LM``'s parameters (a gradient, an optimizer moment)
converts with the same mapping (:func:`lm_tree_from_jax`,
:func:`opt_state_from_jax`).
Matrices keep their ``(in, out)`` layout on both sides.  The inputs here
are nested dicts of numpy arrays (the JAX tree after ``split``, converted
by the caller), so this module needs nothing of JAX.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

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


def port_names(model: LM, path: Tuple[str, ...]) -> Tuple[List[str], bool]:
    """(the port's state-dict names of one JAX leaf, whether the leaf is
    stacked): a stacked segment's leaf is one name a layer, the shared
    layer's (``params["shared"]``) and the others' one name."""
    segs = {seg.name: seg for seg in model.segments + model.enc_segments
            if seg.kind == "stack"}
    if path[0] not in segs and path[0] != "shared":
        return [".".join(path)], False
    m = _SUB.match(path[1]) if len(path) > 3 else None
    if m is None or path[2] not in ("norm", "inner"):
        return ["/".join(path)], False  # unexpected: reported by the caller
    tail = ".".join(path[3:])
    if path[0] == "shared":
        return [f"shared.subs.{m.group(1)}.{path[2]}.{tail}"], False
    seg = segs[path[0]]
    return [f"{seg.name}.{i}.subs.{m.group(1)}.{path[2]}.{tail}"
            for i in range(seg.count)], True


def _port_keys(model: LM, path: Tuple[str, ...], arr: np.ndarray):
    """(port state-dict key, array) pairs for one JAX leaf; unstacks a
    stacked segment's leading layers axis.  The shared layer
    (``params["shared"]``) has none."""
    names, stacked = port_names(model, path)
    if not stacked:
        return [(names[0], arr)]
    if arr.ndim == 0 or arr.shape[0] != len(names):
        raise ValueError(f"{'/'.join(path)}: expected a leading layers axis of "
                         f"{len(names)}, got shape {arr.shape}")
    return [(name, arr[i]) for i, name in enumerate(names)]


def _axes_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _axes_leaves(val, path)
        else:
            yield path, val


def axes_from_jax(model: LM, jax_axes: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX ``LM``'s axes tree (``split(init)[1]``: a tuple of logical
    axes, or None, a leaf) as ``{port state-dict name: axes}``.  A stacked
    leaf's axes name its trailing dims, so each layer's tensor takes them
    as they are."""
    return {name: None if axes is None else tuple(axes)
            for path, axes in _axes_leaves(jax_axes)
            for name in port_names(model, path)[0]}


def placements_from_jax(model: LM, jax_specs: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """A tree of JAX ``PartitionSpec``s of the ``LM``'s parameters (a
    ``NamedSharding``'s ``spec``; leaves are tuples) as ``{port
    state-dict name: DTensor placements on mesh}``: a stacked leaf's spec
    loses its layers dim, which the JAX resolver never shards."""
    from repro_torch.distributed.sharding import placements

    out = {}
    for path, spec in _axes_leaves(jax_specs):
        names, stacked = port_names(model, path)
        spec = tuple(spec)
        if stacked:
            if spec and spec[0] is not None:
                raise ValueError(f"{'/'.join(path)}: a sharded layers dim {spec}")
            spec = spec[1:]
        for name in names:
            out[name] = placements(spec, mesh)
    return out


def _checked(model, state: Dict[str, np.ndarray], what: str) -> Dict[str, np.ndarray]:
    """``state`` after checking it against ``model``'s state dict; raises
    on any missing or unexpected key and any wrong shape."""
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(expected) - set(state))
    unexpected = sorted(set(state) - set(expected))
    wrong = sorted(f"{k}: {state[k].shape} != {expected[k]}"
                   for k in set(state) & set(expected)
                   if tuple(state[k].shape) != expected[k])
    if missing or unexpected or wrong:
        raise ValueError(f"JAX params do not fit {what}: missing {missing}, "
                         f"unexpected {unexpected}, wrong shapes {wrong}")
    return state


def _tensors(state: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in state.items()}


def _load_checked(model, state: Dict[str, np.ndarray], device, what: str):
    """Load numpy ``state`` into ``model`` on ``device``; raises on any
    missing or unexpected key and any wrong shape."""
    tensors = _tensors(_checked(model, state, what), device)
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


def _lm_state(model: LM, tree_np: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    state: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(tree_np):
        for key, leaf in _port_keys(model, path, arr):
            state[key] = leaf
    return state


def lm_from_jax(spec: ModelSpec, params_np: Mapping[str, Any],
                device="cuda") -> LM:
    """The port's :class:`LM` with the JAX package's weights.

    ``params_np`` is the JAX ``LM.init`` tree after ``split``, with numpy
    leaves.  Raises on any missing or unexpected key and any wrong shape.
    """
    device = resolve_device(device)
    model = LM(spec)
    return _load_checked(model, _lm_state(model, params_np), device, spec.name)


def lm_tree_from_jax(spec: ModelSpec, tree_np: Mapping[str, Any],
                     device="cuda") -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX ``LM``'s parameters (a gradient, an
    optimizer moment) as the port's ``{state-dict name: tensor}``, the
    mapping the port's train step and optimizer take.  Raises as
    :func:`lm_from_jax` does."""
    device = resolve_device(device)
    model = LM(spec)
    return _tensors(_checked(model, _lm_state(model, tree_np), spec.name), device)


_FACTORS = {"row", "col", "full"}


def opt_state_from_jax(spec: ModelSpec, state_np: Mapping[str, Any],
                       device="cuda") -> Dict[str, Any]:
    """The JAX ``Optimizer`` state of an ``LM``'s parameters (``step``,
    AdamW's ``mu``/``nu``, SGD's ``mu``, Adafactor's ``v``) as the port's,
    keyed like the port's parameters.  Adafactor's moments convert where
    the layouts factor alike: a parameter the port holds with two or more
    dimensions has ``{"row", "col"}``, one with one dimension ``{"full"}``;
    a stacked norm scale, which the JAX package factors across its layers
    axis, raises."""
    device = resolve_device(device)
    model = LM(spec)
    out: Dict[str, Any] = {"step": torch.tensor(int(np.asarray(state_np["step"])),
                                                dtype=torch.int32, device=device)}
    for name in ("mu", "nu"):
        if name in state_np:
            out[name] = lm_tree_from_jax(spec, state_np[name], device)
    if "v" in state_np:
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        v: Dict[str, Dict[str, np.ndarray]] = {}
        for path, arr in _flatten(state_np["v"]):
            if path[-1] not in _FACTORS:
                raise ValueError(f"v/{'/'.join(path)}: not an Adafactor moment")
            for key, leaf in _port_keys(model, path[:-1], arr):
                v.setdefault(key, {})[path[-1]] = leaf
        for key, shape in shapes.items():
            want = ({"row": shape[:-1], "col": shape[:-2] + shape[-1:]} if len(shape) >= 2
                    else {"full": shape})
            got = {f: tuple(a.shape) for f, a in v.get(key, {}).items()}
            if got != want:
                raise ValueError(f"Adafactor moments of {key} {got} do not factor the "
                                 f"port's parameter of shape {shape} ({want})")
        if set(v) != set(shapes):
            raise ValueError(f"Adafactor moments for unknown parameters "
                             f"{sorted(set(v) - set(shapes))}")
        out["v"] = {key: _tensors(factors, device) for key, factors in v.items()}
    return out


# sub-block kind -> the leaves of its decode cache (the JAX package's)
_CACHE_LEAVES = {
    "attention": {"k", "v"},
    "cross_attention": {"k", "v"},  # the encoder output's, projected once
    "mlp": set(),
    "moe": set(),
    "mamba2": {"conv", "state"},
    "mlstm": {"conv", "c", "n", "m"},
    "slstm": {"conv", "c", "n", "m", "h"},
}


def _cache_keys(model: LM):
    """(segment, the JAX cache's key for it) in the order the layers run:
    a stacked segment's name, or ``shared_<i>`` for the i-th run of the
    shared layer."""
    keys, shared = [], 0
    for seg in model.segments:
        if seg.kind == "shared":
            keys.append((seg, f"shared_{shared}"))
            shared += 1
        else:
            keys.append((seg, seg.name))
    return keys


def cache_from_jax(spec: ModelSpec, cache_np: Mapping[str, Any],
                   device="cuda") -> Cache:
    """The JAX decode cache (``{seg: {sub_<i>: {leaf: array}}}``, stacked
    on a leading layers axis, and ``{shared_<i>: ...}`` unstacked for each
    run of the shared layer) as the port's per-layer list of ``{sub_<i>:
    {leaf: tensor}}``.  Raises on any missing or unexpected segment,
    sub-block or leaf, and on a wrong layers axis."""
    device = resolve_device(device)
    model = LM(spec)
    keys = _cache_keys(model)
    if set(cache_np) != {key for _, key in keys}:
        raise ValueError(f"cache segments {sorted(cache_np)} do not match "
                         f"{[key for _, key in keys]}")
    out: Cache = []
    for seg, key in keys:
        subs = cache_np[key]
        stacked = seg.kind == "stack"
        kinds = {f"sub_{i}": s.kind for i, s in enumerate(seg.spec.subs)}
        if set(subs) != set(kinds):
            raise ValueError(f"{key}: cache subs {sorted(subs)} != {sorted(kinds)}")
        for name, kind in kinds.items():
            want = _CACHE_LEAVES[kind]
            if set(subs[name]) != want:
                raise ValueError(f"{key}/{name} ({kind}): cache keys "
                                 f"{sorted(subs[name])} != {sorted(want)}")
            for leaf, arr in subs[name].items():
                if stacked and (np.ndim(arr) == 0 or np.shape(arr)[0] != seg.count):
                    raise ValueError(f"{key}/{name}/{leaf}: expected a leading "
                                     f"layers axis of {seg.count}, got shape "
                                     f"{np.shape(arr)}")
        for i in range(seg.count):
            out.append({name: {leaf: torch.from_numpy(np.array(arr[i] if stacked else arr))
                               .to(device) for leaf, arr in subs[name].items()}
                        for name in kinds})
    return out
