"""Collective-communication byte accounting, the JAX package's
``hwgen/hlo_analysis.py`` on the port.

The reference parses the optimized (SPMD-partitioned) HLO text and sums
the operand bytes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute, multiplying those of a ``while`` body by
its trip count.  The port compiles no program: DTensor issues each
collective eagerly on its local shard, as a functional collective
(``torch.ops._c10d_functional.*``) or a c10d op (``torch.ops.c10d.*``).
:class:`CollectiveCounter` is a ``TorchDispatchMode`` that sees every
collective issued inside it, on any process group (the fake one of a dry
run included), and counts it by the parser's rule: **operand bytes**, the
input tensor of each collective (an all-gather's local shard, a
reduce-scatter's whole local input, a point-to-point send's tensor).  A
Python loop issues its collectives once a trip, so there are no trip
counts to recover.  There is no HLO text, so there is no ``count_op``.

What the count cannot match: DTensor chooses its own collectives where
XLA's partitioner chooses others (a ``(Partial, Partial)`` result goes to
``Replicate`` as two all-reduces, one a mesh dim; a reshard between two
``Shard`` dims on a ``cpu`` mesh is an all-gather and a chunk, as the CPU
groups have no all-to-all), so per-kind counts describe DTensor's program,
not the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# (namespace, op name) -> (kind, index of the operand in the op's arguments)
_OPS = {
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): ("all-gather", 0),
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
    ("_c10d_functional_autograd", "all_to_all_single"): ("all-to-all", 0),
    ("_c10d_functional_autograd", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional_autograd", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_coalesced_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "send"): ("collective-permute", 0),
    # DTensor's Shard -> Shard reshard on a mesh of a device with all-to-all
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", 0),
}


def _kind(func) -> Optional[tuple]:
    packet = getattr(func, "_overloadpacket", None)
    if packet is None:
        return None
    ns, _, name = packet._qualified_op_name.partition("::")
    return _OPS.get((ns, name))


def tensor_bytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or lists, tuples and dicts
    of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(tensor_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


def empty_stats() -> Dict[str, Dict[str, float]]:
    return {k: {"count": 0.0, "bytes": 0.0} for k in COLLECTIVES}


def on_dtensors(types) -> bool:
    """Whether a dispatch mode's ``types`` hold a DTensor: the mode then
    returns ``NotImplemented`` and sees the local ops DTensor runs."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, type) and issubclass(t, DTensor) for t in types)


class CollectiveCounter(TorchDispatchMode):
    """Counts every collective issued inside it: ``stats`` is ``{kind:
    {"count", "bytes"}}`` over :data:`COLLECTIVES`, the shape of the
    reference's ``analyze_collectives``.  An op on DTensors is let through
    (``NotImplemented``) so that DTensor runs it and issues its
    collectives and local ops here, where they are seen and counted once."""

    def __init__(self):
        super().__init__()
        self.stats = empty_stats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        found = _kind(func)
        if found is not None:
            kind, index = found
            self.stats[kind]["count"] += 1
            self.stats[kind]["bytes"] += tensor_bytes(args[index] if index < len(args) else None)
        return func(*args, **kwargs)


def total_collective_bytes(stats: Dict[str, Dict[str, float]]) -> int:
    return int(sum(v["bytes"] for v in stats.values()))
