"""Distribution hooks usable from model code, the JAX package's
``distributed/api.py`` on the port.

Model code calls :func:`constrain` with *logical* activation axes.  Inside
:func:`sharding_context` (a ``DeviceMesh`` and its rules) it redistributes
the DTensor to the placements the resolver gives; outside one it returns
its argument itself, so the same model code runs on plain tensors (the
serve and NAS paths) and on a mesh (sharded training) unchanged.

Inside a context, plain tensors that model code makes (positions,
masks, ``arange``s) meet DTensors; the context lets DTensor treat them
as replicated (``implicit_replication``), as every rank makes the same.
:func:`local` runs a computation on local shards (an attention core, a
scan: DTensor would refuse their flattens or gather them), and
:func:`along` an op DTensor has no working rule for (a pad, a cumsum,
a log-sigmoid), keeping every placement the op allows;
:func:`placed_grad` gives one use of a DTensor whose gradients are
summed its own gradient placement.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional, Tuple

import torch

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_context(mesh, rules):
    """Activate (mesh, rules) for :func:`constrain` within the block."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = (current_mesh(), current_rules())
    _state.mesh, _state.rules = mesh, rules
    try:
        with implicit_replication():
            yield
    finally:
        _state.mesh, _state.rules = prev


@functools.cache
def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


def constrain(x, logical_axes: Tuple[Optional[str], ...]):
    """``x`` redistributed to the placements of ``logical_axes`` when a
    context is active; ``x`` itself otherwise.  A plain tensor inside a
    context is an error."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return x
    if not is_dtensor(x):
        raise TypeError(f"constrain{tuple(logical_axes)} inside a sharding context got a "
                        f"plain {type(x).__name__}, not a DTensor")
    from repro_torch.distributed.sharding import logical_to_spec, placements

    target = placements(logical_to_spec(logical_axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def spec(x, logical_axes):
    """The PartitionSpec ``logical_axes`` resolve to for ``x`` (a tensor
    or a shape) in the active context; None outside one."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return None
    from repro_torch.distributed.sharding import logical_to_spec

    return logical_to_spec(logical_axes, tuple(getattr(x, "shape", x)), mesh, rules)


def _sharded(placements_) -> bool:
    return any(p.is_shard() for p in placements_)


class _DenseGrad(torch.autograd.Function):
    """Identity forward; the backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(x, placements_, grad_placements=None):
    """The local shard of the DTensor ``x`` redistributed to
    ``placements_``, differentiably.  A shard's gradient comes back
    contiguous: DTensor reads a gradient's layout off the forward's
    global strides, and a view it then takes of a permuted local
    gradient fails.  (Replicated, the layouts are the plain path's.)"""
    t = x.redistribute(x.device_mesh, placements_).to_local(grad_placements=grad_placements)
    return _DenseGrad.apply(t) if t.requires_grad and _sharded(placements_) else t


def from_local(t, mesh, placements_):
    """The local ``t`` (one rank's even shard) as a DTensor with
    ``placements_``, differentiably; a shard is made contiguous first,
    for the views DTensor takes of it."""
    from torch.distributed.tensor import DTensor

    t = t.contiguous() if _sharded(placements_) else t
    return DTensor.from_local(t, mesh, placements_, run_check=False)


def local(fn: Callable, *args, axes):
    """``fn(*args)`` run on local shards, for a computation DTensor would
    gather or refuse (a scan, an attention core) that is independent
    along every dim its ``axes`` shard.  Inside a context each argument
    (a plain tensor is taken as replicated) is redistributed to the
    placements of its logical axes in ``axes``, ``fn`` runs on the local
    tensors, and each tensor it returns comes back as a DTensor placed as
    the first argument.  Outside a context it is ``fn(*args)``."""
    mesh = current_mesh()
    if mesh is None or current_rules() is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed.sharding import placements

    rep = [Replicate()] * mesh.ndim
    targets = [placements(spec(a, ax), mesh) for a, ax in zip(args, axes, strict=True)]
    local_args = []
    for a, target in zip(args, targets):
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, rep, run_check=False)
        # an argument whole on a mesh dim that splits the work gets a
        # partial gradient there: each rank's holds its share's
        grad = [Partial() if p.is_replicate() and o.is_shard() else p
                for p, o in zip(target, targets[0])]
        local_args.append(to_local(a, target, grad))
    out = fn(*local_args)

    def wrap(t):
        return from_local(t, mesh, targets[0]) if torch.is_tensor(t) else t

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def along(fn: Callable, x, dims: Tuple[int, ...] = ()):
    """``fn(x)`` for an op that works along ``dims`` of ``x`` only (a
    pad, a cumsum; none for an elementwise op) and that DTensor has no
    working rule for: a DTensor ``x`` keeps its placements but a shard of
    one of ``dims`` (or a partial sum), which is replicated; ``fn`` runs
    on the local tensor, and its result comes back with those placements.
    ``fn(x)`` for a plain ``x``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate

    wanted = {d % x.ndim for d in dims}
    target = tuple(p if p.is_replicate() or (p.is_shard() and p.dim not in wanted)
                   else Replicate() for p in x.placements)
    out = fn(to_local(x, target))
    return from_local(out, x.device_mesh, target)


def replicate(x):
    """A DTensor redistributed to replicated on every mesh dim (a partial
    sum is reduced); a plain tensor as it is."""
    if not is_dtensor(x) or all(p.is_replicate() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def placed_like(x, ref):
    """``x`` with the placements of the DTensor ``ref``; ``x`` as it is
    when ``ref`` is a plain tensor or the placements agree."""
    if not is_dtensor(ref) or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def replicated_like(x, ref):
    """The plain tensor ``x`` as a replicated DTensor on the mesh of the
    DTensor ``ref`` (every rank holds the same ``x``); ``x`` itself when
    ``ref`` is plain."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


class _PlacedGrad(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient to the
    input's placements."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def placed_grad(x):
    """``x`` for one of several uses of a DTensor whose gradients are summed:
    the use's gradient comes back with ``x``'s placements, so the sum adds
    like placements (DTensor (torch 2.11) cannot add a shard to a partial
    sum).  ``x`` itself when it is a plain tensor."""
    return _PlacedGrad.apply(x) if is_dtensor(x) else x
