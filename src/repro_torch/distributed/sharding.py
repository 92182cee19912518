"""Logical-axis sharding resolver, the JAX package's
``distributed/sharding.py`` on the port.

Parameters and activations carry *logical* axis names ("embed", "mlp",
"heads", "vocab", "experts", "batch", "kv_seq", ...).  A rule-set maps
each name to zero or more mesh axes, and the resolver applies it with a
**divisibility fallback**: a dimension that the product of its mesh axes
does not divide is replicated (kv_heads = 8 cannot shard over model =
16), and no mesh axis is used twice in one spec.

Default policy = FSDP + TP: weights ``embed -> data``, ``mlp / heads /
kv_heads / vocab / experts -> model``; activations ``batch -> (pod,
data)``; decode caches shard their sequence over ``model``.

A spec is a :class:`PartitionSpec`, one entry a tensor dim: None, a mesh
axis name, or a tuple of names (major first), as ``jax.sharding``'s.  The
resolver needs only the mesh's axis sizes, so it takes a
``torch.distributed.DeviceMesh``, a mapping ``{axis: size}``, or any
object with ``axis_names`` and a ``shape`` mapping.  :func:`placements`
turns a spec into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

Rules = Dict[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis, or a tuple of axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a mapping, or a mesh
    with ``axis_names`` and a ``shape`` mapping (the JAX package's)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def default_rules(mesh) -> Rules:
    has_pod = "pod" in mesh_axes(mesh)
    batch = ("pod", "data") if has_pod else ("data",)
    return {
        "batch": batch,
        "embed": ("data",),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_mlp": ("data",),  # 2D expert sharding (MoEConfig.shard_ff)
        "kv_seq": ("model",),
        # attention-internal context parallelism (AttentionConfig.seq_shard)
        "act_seq": ("model",),
        "layers": (),
    }


def partition_spec(logical_axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
                   rules: Rules) -> PartitionSpec:
    """Map logical axes -> PartitionSpec honoring divisibility + uniqueness."""
    sizes = mesh_axes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ()) if a in sizes and a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if not axes or dim % size != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return PartitionSpec(*out)


def logical_to_spec(logical_axes, shape, mesh, rules: Rules) -> PartitionSpec:
    """:func:`partition_spec` with missing leading axes padded with None
    (the JAX package's stacked layers dim)."""
    if len(logical_axes) < len(shape):
        logical_axes = (None,) * (len(shape) - len(logical_axes)) + tuple(logical_axes)
    return partition_spec(logical_axes, shape, mesh, rules)


def params_shardings(model, mesh, rules: Optional[Rules] = None) -> Dict[str, PartitionSpec]:
    """``{state-dict name: PartitionSpec}`` of a model's parameters, from
    their logical axes (:func:`repro_torch.nn.types.param_axes`); a
    parameter without axes is replicated."""
    from repro_torch.nn.types import param_axes

    rules = rules or default_rules(mesh)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    return {k: PartitionSpec() if axes is None else logical_to_spec(axes, shapes[k], mesh, rules)
            for k, axes in param_axes(model).items()}


def is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                                      for e in x))


def shapes_shardings_from_axes(values, axes_tree, mesh, rules: Optional[Rules] = None):
    """(values, axes) trees -> a tree of PartitionSpecs shaped like
    ``axes_tree``.  ``values`` leaves need only a ``shape`` (tensors, meta
    tensors, ``torch.Size``); nodes are dicts or lists."""
    rules = rules or default_rules(mesh)

    def one(a, v):
        if is_axes_leaf(a):
            if a is None:
                return PartitionSpec()
            return logical_to_spec(a, tuple(getattr(v, "shape", v)), mesh, rules)
        if isinstance(a, Mapping):
            return {k: one(a[k], v[k]) for k in a}
        return [one(x, y) for x, y in zip(a, v, strict=True)]

    return one(axes_tree, values)


def placements(spec: Sequence[Any], mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(dim)``
    on each mesh dim a tensor dim maps to (a dim over several mesh axes
    gets one ``Shard`` on each, major first, which DTensor's default
    order keeps only when the spec lists them in the mesh's order), and
    ``Replicate()`` on every other.  A mesh dim of size 1 holds the whole
    tensor, so it is ``Replicate()`` whatever the spec says: the local
    shapes are the same, and DTensor's propagator (torch 2.11) picks
    zero-cost shardings of its own on size-1 dims whose views it then
    refuses."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(int(n) for n in mesh.shape)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: the axes {axes} of dim {dim} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def spec_of(placements_: Sequence[Any], ndim: int, mesh) -> PartitionSpec:
    """The inverse of :func:`placements`: the spec DTensor placements on
    ``mesh`` stand for, without the mesh's size-1 axes (partial
    placements are refused)."""
    names = tuple(mesh.mesh_dim_names)
    dims: Dict[int, list] = {}
    for name, p in zip(names, placements_):
        if p.is_shard():
            dims.setdefault(p.dim, []).append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} on {name} has no PartitionSpec")
    return PartitionSpec(*(None if d not in dims else
                           (dims[d][0] if len(dims[d]) == 1 else tuple(dims[d]))
                           for d in range(ndim)))


def distribute_model(model, mesh, rules: Optional[Rules] = None) -> Dict[str, Any]:
    """Shard ``model``'s parameters onto ``mesh`` in place: each becomes a
    DTensor with the placements its logical axes resolve to (each rank
    keeps only its shard).  Returns ``{state-dict name: DTensor}``, the
    mapping a train step takes."""
    from torch.distributed.tensor import distribute_tensor

    specs = params_shardings(model, mesh, rules)
    state = {k: distribute_tensor(p.detach(), mesh, placements(specs[k], mesh),
                                  src_data_rank=None)
             for k, p in model.named_parameters()}
    model.load_state_dict(state, strict=True, assign=True)
    return {k: p.detach() for k, p in model.named_parameters()}


def replicate_tree(tree, mesh):
    """A tree of plain tensors (a batch, a scalar) as replicated DTensors
    on ``mesh``: every rank holds the same values."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(tree, Mapping):
        return {k: replicate_tree(v, mesh) for k, v in tree.items()}
    return DTensor.from_local(tree, mesh, [Replicate()] * mesh.ndim, run_check=False)


def placements_tree(tree):
    """The placements of a tree of DTensors (dicts nest), the form
    ``Checkpointer.restore(shardings=)`` takes."""
    if isinstance(tree, Mapping):
        return {k: placements_tree(v) for k, v in tree.items()}
    return tuple(tree.placements)
