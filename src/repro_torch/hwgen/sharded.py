"""Counting a sharded program on the host, without a card: what the dry
run (:mod:`repro_torch.launch.dryrun`) and the generator's sharded path
(:meth:`repro_torch.hwgen.generator.TorchGenerator.generate` with
``in_shardings``) share.

The reference lowers and compiles a ``jax.jit`` program for a mesh of
spoofed host devices.  The port runs the program once instead, on the
fake process group (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once, moving nothing), this process being rank 0 of
the mesh's world, with every argument on the ``meta`` device as a DTensor
of the placements its ``PartitionSpec`` gives (no memory is allocated).
DTensor issues the collectives and local ops it would issue on the
cards, and three counters watch them:

* :class:`~repro_torch.hwgen.collectives.CollectiveCounter`: operand bytes
  by collective kind;
* :class:`LocalCost`: operations (``torch.utils.flop_counter``'s
  formulas), bytes read and written, and transcendentals of the local
  ops, each counted once on its local shards;
* :func:`mem_tracker`: the peak bytes alive at once on a device,
  arguments included.

:func:`extrapolate` takes the counts of a program cut to ``k`` and
``k + 1`` layer units to a depth of ``units``: every per-unit count adds
up exactly, as the reference's cost lowering assumes.

One process has one process group.  :func:`fake_group` holds it as the
fake group at a given world for a block, and refuses a real one (gloo or
NCCL, as ``train --mesh`` starts).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.sharding import default_rules, placements
from repro_torch.hwgen.collectives import CollectiveCounter, on_dtensors, tensor_bytes


# -- the fake process group ----------------------------------------------------

def _fake_store():
    """The fake process group's store; the one place it is imported."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"torch {torch.__version__} has no fake process group "
            f"(torch.testing._internal.distributed.fake_pg); counting a sharded "
            f"program needs it") from e
    return FakeStore()


def start_fake_group(world: int, rank: int = 0) -> None:
    """The fake process group at ``world`` ranks, this process being
    ``rank``: every collective returns at once, moving nothing."""
    import torch.distributed as dist

    dist.init_process_group("fake", store=_fake_store(), rank=rank, world_size=world)


@contextlib.contextmanager
def fake_group(world: int):
    """This process's group as the fake one at ``world`` ranks while the
    block runs: one it starts ends with the block, so that no later code
    in the process (``train --mesh``, a checkpoint) takes over a group
    whose collectives move nothing; a fake group of that world that runs
    already is used and left running.  Refuses (``RuntimeError``) any
    other group, a real one (gloo or NCCL, as ``train --mesh`` starts)
    above all: its collectives would move data."""
    import torch.distributed as dist

    if dist.is_initialized():
        backend, have = str(dist.get_backend()), dist.get_world_size()
        if backend != "fake" or have != world:
            raise RuntimeError(
                f"a {backend} process group of {have} ranks is running in this process: "
                f"a sharded program of {world} ranks is counted on the fake group, and a "
                f"process holds one group; count it in another process")
        yield
        return
    start_fake_group(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- arguments as DTensors -----------------------------------------------------

def distribute(tree, specs, mesh):
    """A tree (dicts, lists, tuples) of ``meta`` tensors as DTensors with
    the placements of ``specs`` (a tree of the same structure whose leaves
    are ``PartitionSpec``s) on ``mesh``; a leaf that is not a tensor stays
    as it is."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        out = [distribute(a, b, mesh) for a, b in zip(tree, specs, strict=True)]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements(specs, mesh), src_data_rank=None)
    return tree


def local_tensors(tree) -> list:
    """The local shards of a tree (dicts, lists) of (D)Tensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in local_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in local_tensors(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if isinstance(tree, DTensor) else tree]
    return []


def local_bytes(tree) -> int:
    return tensor_bytes(local_tensors(tree))


# -- the counters ----------------------------------------------------------------

class LocalCost(TorchDispatchMode):
    """Operations, bytes and transcendentals of the local ops run inside
    it; an op on DTensors is passed down (``NotImplemented``) to the local
    ops DTensor runs for it, which are counted here once."""

    _EMPTY = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})
    _TRANSCENDENTAL = frozenset({
        "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid",
        "rsqrt", "sqrt", "sin", "cos", "erf", "erfinv", "pow", "silu", "gelu",
        "softplus", "_softmax", "_log_softmax", "logsumexp", "tanh_backward",
        "sigmoid_backward", "silu_backward", "gelu_backward", "_softmax_backward_data",
        "_log_softmax_backward_data", "log_sigmoid_forward", "log_sigmoid_backward"})

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        if on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        if _propagating():
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            # as FlopCounterMode: count a decomposable op by its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ns, _, name = packet._qualified_op_name.partition("::")
        if ns in ("aten", "prims") and not func.is_view and name not in self._EMPTY:
            self.bytes += tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
            if name.rstrip("_") in self._TRANSCENDENTAL:
                self.transcendentals += _numel(out)
        return out


_propagation = threading.local()


def _propagating() -> bool:
    """Inside DTensor's sharding propagation, which runs ops on the global
    shapes to find the outputs' metadata: under a ``FakeTensorMode``, or,
    for an op whose sharding it propagates through its decomposition, on
    the arguments themselves (:func:`_watch_propagation`).  Either way it
    runs once per op signature in a process, so counting its ops would
    make a count depend on what the process ran before."""
    return (getattr(_propagation, "depth", 0) > 0
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None)


@contextlib.contextmanager
def _watch_propagation():
    """Mark DTensor's uncached sharding propagation for :func:`_propagating`
    while the block runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "propagate_op_sharding_non_cached"
    original = getattr(ShardingPropagator, name, None)
    if original is None:  # another torch: only the fake-mode test applies
        yield
        return

    @functools.wraps(original)
    def marked(self, *args, **kwargs):
        _propagation.depth = getattr(_propagation, "depth", 0) + 1
        try:
            return original(self, *args, **kwargs)
        finally:
            _propagation.depth -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return 0


def mem_tracker():
    """A ``MemTracker`` that keeps only the device totals: its per-module
    statistics hook every module's parameters for their gradients, which
    a prefill's or decode's parameters (no gradient) refuse.  It passes
    DTensor ops down and skips DTensor's sharding propagation, as torch
    2.13's does; torch 2.11's would count the propagation's fake tensors
    of the global shapes, which its cache keeps alive."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class _Totals(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if on_dtensors(types):
                return NotImplemented
            if _propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _pre_fw_hook(self, module, inputs):
            pass

        def _post_fw_hook(self, module, inputs, outputs):
            pass

        def _pre_bw_hook(self, module, args):
            pass

        def _post_bw_hook(self, module, args):
            pass

    return _Totals()


# the propagation marker patches a class for the whole process
_counting_lock = threading.Lock()


def count(step, args, mesh, with_cost: bool) -> dict:
    """One run of ``step(*args)`` under the counters, inside
    ``sharding_context`` with the default rules: the peak bytes, the
    collectives by kind and (with the cost counter) the local ops' cost.

    The ops of DTensor's sharding propagation through an op's
    decomposition (:func:`_propagating`), which runs the first time a
    process meets the op, are left out: a count is the same whatever the
    process counted before, which a study of many candidates in one
    process and the dry run's records need."""
    tracker, counter = mem_tracker(), CollectiveCounter()
    tracker.track_external(*local_tensors(args))
    cost = LocalCost() if with_cost else contextlib.nullcontext()
    with _counting_lock, _watch_propagation(), sharding_context(mesh, default_rules(mesh)), \
            tracker, counter, cost:
        step(*args)
    peak = tracker.get_tracker_snapshot("peak")
    out = {"peak": max((int(snap.get("Total", 0)) for snap in peak.values()), default=0),
           "collectives": counter.stats}
    if with_cost:
        out["cost"] = {"flops": float(cost.flops), "bytes_accessed": float(cost.bytes),
                       "transcendentals": float(cost.transcendentals)}
    return out


def extrapolate(lo: Dict[str, Any], hi: Dict[str, Any], units: int, k: int = 0) -> dict:
    """The collectives and (where counted) cost of :func:`count` at
    ``units`` layer units, from its counts ``lo`` at ``k`` units and ``hi``
    at ``k + 1``: q(units) = q(k) + (units - k) * (q(k+1) - q(k)).  A
    peak does not add up by layer, so the caller sets it."""
    def extrap(q0, q1):
        return q0 + (units - k) * (q1 - q0)

    out = {"collectives": {
        kind: {key: extrap(lo["collectives"][kind][key], hi["collectives"][kind][key])
               for key in ("count", "bytes")} for kind in lo["collectives"]}}
    if "cost" in lo:
        out["cost"] = {key: extrap(lo["cost"][key], hi["cost"][key]) for key in lo["cost"]}
    return out
