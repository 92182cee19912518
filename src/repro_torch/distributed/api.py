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
summed its own gradient placement.  :func:`gathered` gathers a weight's
FSDP shards as it is used, :func:`embedding` looks tokens up in a
vocab-sharded table, :func:`unflatten` and :func:`flatten` reshape where
DTensor would refuse, and :func:`write_at` writes one position of a
sequence-sharded cache.
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

    with rebind(mesh, rules), implicit_replication():
        yield


@contextlib.contextmanager
def rebind(mesh, rules):
    """Bind (mesh, rules) in this thread for the block, and nothing else:
    for code that an enclosing :func:`sharding_context` runs on another
    thread (a recomputation in a card's backward runs on the autograd
    engine's thread).  DTensor's implicit replication is process-wide, set
    by the enclosing context, and its exit would clear it."""
    prev = (current_mesh(), current_rules())
    _state.mesh, _state.rules = mesh, rules
    try:
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


def from_local(t, mesh, placements_, shape=None):
    """The local ``t`` (one rank's shard) as a DTensor with ``placements_``,
    differentiably; a shard is made contiguous first, for the views DTensor
    takes of it.  ``shape``, the global shape, is needed where the shards
    are uneven (otherwise it is taken as the local shape times the mesh's
    split)."""
    from torch.distributed.tensor import DTensor

    t = t.contiguous() if _sharded(placements_) else t
    kwargs = {}
    if shape is not None:
        stride, n = [], 1
        for size in reversed(tuple(shape)):
            stride.insert(0, n)
            n *= size
        kwargs = {"shape": torch.Size(shape), "stride": tuple(stride)}
    return DTensor.from_local(t, mesh, placements_, run_check=False, **kwargs)


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


def embedding(w, tokens):
    """``w[tokens]``.  On a DTensor table inside a sharding context, the
    lookup XLA partitions a gather into: each rank looks its tokens (batch
    split as the rules say) up in its shard of the vocab, zero where a
    token lies in another shard, and the shards' rows sum through an
    all-reduce (``Partial``) over the mesh dims that split the vocab."""
    if current_mesh() is None or not is_dtensor(w):
        return w[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.distributed.sharding import placements

    mesh = w.device_mesh
    if not is_dtensor(tokens):
        tokens = replicated_like(tokens, w)
    tok = placements(spec(tokens, ("batch",) + (None,) * (tokens.ndim - 1)), mesh)
    out = []
    for i, (pw, pt) in enumerate(zip(w.placements, tok)):
        if pw.is_shard(0) and pt.is_shard():
            raise ValueError(f"mesh dim {i} splits both the vocab and the tokens")
        out.append(Partial() if pw.is_shard(0) else Shard(tokens.ndim) if pw.is_shard(1)
                   else pt if pt.is_shard() else Replicate())
    # the table is whole on the mesh dims that split the tokens: its
    # gradient there is each rank's share (a partial sum), as in local()
    table = to_local(w, tuple(w.placements), [Partial() if pt.is_shard() else pw
                                               for pw, pt in zip(w.placements, tok)])
    ids = tokens.redistribute(mesh, tok).to_local()
    shape, offset = compute_local_shape_and_global_offset(w.shape, mesh, w.placements)
    if shape[0] == w.shape[0]:
        rows = table[ids]
    else:
        ids = ids - offset[0]
        held = (ids >= 0) & (ids < shape[0])
        rows = table[ids.clamp(0, shape[0] - 1)] * held[..., None].to(table.dtype)
    return DTensor.from_local(rows, mesh, out, run_check=False)


def gathered(w):
    """A weight as FSDP uses it inside a sharding context: a DTensor ``w``
    sharded on a mesh dim that splits the batch (``rules["batch"]``) is
    all-gathered there, its other shards kept, and its gradient goes back
    to ``w``'s placements (reduce-scattered).  Left to itself, DTensor
    contracts over such a shard instead, which in the backward moves the
    whole batch's activations.  A weight with nothing to gather gets
    :func:`placed_grad`; a plain one, or one outside a context, is
    returned as it is."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = tuple(w.device_mesh.mesh_dim_names)
    batch = {names.index(a) for a in rules.get("batch", ()) if a in names}
    target = tuple(Replicate() if i in batch and p.is_shard() else p
                   for i, p in enumerate(w.placements))
    if target == tuple(w.placements):
        return placed_grad(w)
    return w.redistribute(w.device_mesh, target)


def unflatten(x, dim: int, sizes: Tuple[int, ...]):
    """``x.unflatten(dim, sizes)``.  A DTensor whose shard of ``dim`` the
    leading size does not split evenly (4 heads on model = 16) is first
    replicated on the mesh dims that shard ``dim``: DTensor refuses to cut
    a head.  The result's gradient comes back with its placements, so the
    backward's flatten is one DTensor takes."""
    if not is_dtensor(x):
        return x.unflatten(dim, sizes)
    from torch.distributed.tensor import Replicate

    d = dim % x.ndim
    mesh = x.device_mesh
    ways = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(d):
            ways *= mesh.size(i)
    if sizes[0] % ways:
        x = x.redistribute(mesh, [Replicate() if p.is_shard(d) else p for p in x.placements])
    return placed_grad(x.unflatten(dim, sizes))


def flatten(x, start: int, end: int):
    """``x.flatten(start, end)``.  A DTensor sharded on one of the inner
    dims (``start`` excluded) is first replicated there: torch 2.11's
    DTensor refuses to flatten a dim into a sharded one.  The result's
    gradient comes back with its placements."""
    if not is_dtensor(x):
        return x.flatten(start, end)
    from torch.distributed.tensor import Replicate

    start, end = start % x.ndim, end % x.ndim
    inner = [p.is_shard() and start < p.dim <= end for p in x.placements]
    if any(inner):
        x = x.redistribute(x.device_mesh, [Replicate() if i else p
                                           for i, p in zip(inner, x.placements)])
    return placed_grad(x.flatten(start, end))


def write_at(buf, dim: int, index: int, value) -> None:
    """``buf.select(dim, index).copy_(value)``, in place.  On a DTensor
    ``buf`` (a decode cache whose sequence is sharded) ``value`` takes
    ``buf``'s placements on its other dims, and the rank whose shard holds
    ``index`` writes it there."""
    if not is_dtensor(buf):
        buf.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    target = [Replicate() if p.is_shard(dim) else Shard(p.dim - 1) if p.is_shard()
              and p.dim > dim else p for p in buf.placements]
    if not is_dtensor(value):
        value = replicated_like(value, buf)
    local_value = value.redistribute(mesh, target).to_local()
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, buf.placements)
    at = index - offset[dim]
    if 0 <= at < shape[dim]:
        buf.to_local().select(dim, at).copy_(local_value)


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
