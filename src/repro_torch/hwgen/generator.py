"""Generator pipeline (paper §VI): model instance -> deployable artifact.

The JAX package lowers and compiles a candidate for its target.  The
port runs eagerly: the kernels are ``ctypes`` calls into the CUDA
libraries of :mod:`repro_torch.kernels`, which ``torch.compile`` cannot
trace.  So generating an artifact here means placing the candidate and
its inputs on the target's device and running one forward, which also
gives the candidate's peak device memory.  Between runs an artifact lives
on the host: an evaluation cache full of artifacts holds no device
memory, and what one candidate leaves on the card cannot show up in the
next one's peak.

Two usage modes, mirroring the paper:
  1. deploy-best: generate once for the final architecture;
  2. hardware-in-the-loop: a cost estimator generates + benchmarks every
     candidate and feeds the measurement back into the study.

:func:`export_candidate` turns a candidate into a program of ``(params,
x)`` with no weights in it (``torch.export``, traced on fake tensors of
the target's device under the plan's schedules, the kernels recorded as
their registered ops with their tiles): what the artifact store
(:mod:`repro_torch.evaluation.artifact_store`) keeps, as the reference's
keeps an executable that draws its parameters at each use.  An artifact
loaded from the store carries that program, and every run of it calls the
program on the artifact's seed-0 weights instead of the candidate's own
forward; the kernels it launches are the same.

A sharded program (``generate(fn, args, in_shardings=...)``, the
reference's ``jax.jit(in_shardings=)`` under the target's mesh) is laid
out and counted on the host, not run: over the fake process group at the
target's world, on a ``DeviceMesh`` of its shape, every argument a
DTensor on ``meta`` (:mod:`repro_torch.hwgen.sharded`, which the dry run
shares).  Its artifact carries per-device operations, bytes, collective
bytes, argument and peak bytes and their roofline against the target's
chip, as the reference's compiled artifact does, and launches nothing.
:meth:`TorchGenerator.generate_by_units` counts a program at two depths
and extrapolates, for studies whose candidates are too slow to count
whole on the host.

``HardwareManager.benchmark`` times eager forwards: with CUDA events on
the card, with the host clock on the CPU.  A ``roofline`` target
(``edge_npu``) is never run: its artifact stays on the host, and its
benchmark is the roofline bound of the candidate's counted forward.

:func:`program_cost` is the port's counterpart of the compiled artifact's
``flops``, ``bytes_accessed`` and ``collective_bytes`` (what XLA's cost
analysis gives the reference), counted in one forward on the ``meta``
device: nothing is placed on a device, nothing is launched, and
:func:`generate_call_count` does not move.  ``metric: modelled`` puts
these terms against the target's chip (``hwgen/roofline.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import faults
from repro_torch.device import resolve_device
from repro_torch.hwgen.collectives import CollectiveCounter, total_collective_bytes
from repro_torch.hwgen.roofline import RooflineReport, roofline_terms
from repro_torch.hwgen.targets import TargetSpec, get_target
from repro_torch.ioutils import lock_file, unlock_file
from repro_torch.kernels import ops as kops
from repro_torch.kernels import schedule as ksched


@dataclasses.dataclass
class Artifact:
    """A candidate for a target, with the inputs it was run on and what
    that run used.  ``fn`` and ``example_args`` stay on the host; a run
    places them on the target's device and takes them off again."""

    target: TargetSpec
    fn: Callable
    example_args: Tuple = ()
    # {"peak_bytes_per_device": ...} from the allocator on CUDA; empty on
    # the CPU, which keeps no allocator statistics
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the kernel schedules every run of ``fn`` is resolved under (None:
    # each kernel's call site and default decide)
    schedules: Optional[Mapping[str, Any]] = None
    # a program of (params, x) loaded from the artifact store; when set,
    # a run calls it on ``fn``'s weights in place of ``fn``'s forward
    program: Optional[Callable] = None
    # a sharded program counted on the host (``generate(in_shardings=)``):
    # operations, bytes and collective bytes a device, the collectives by
    # kind, and their roofline against the target's chip; None otherwise
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    collective_bytes: Optional[float] = None
    collectives: Optional[Dict[str, Dict[str, float]]] = None
    roofline: Optional[RooflineReport] = None

    @property
    def fits_memory(self) -> bool:
        """Whether the peak a device holds fits the target chip's memory
        (False where no peak was taken)."""
        peak = self.memory.get("peak_bytes_per_device")
        return peak is not None and peak <= self.target.chip.hbm_bytes

    def __call__(self, *args):
        """One forward: ``fn``'s own, or the loaded program on its weights."""
        if self.program is None:
            return self.fn(*args)
        return self.program(dict(self.fn.named_parameters()), *args)


class GeneratorError(RuntimeError):
    pass


def _on_meta(value):
    if isinstance(value, torch.Tensor):
        return torch.empty_like(value, device="meta")
    return value


def _tree_on_meta(tree):
    """A tree (dicts, lists, tuples) with every tensor as a meta tensor of
    its shape and dtype."""
    if isinstance(tree, dict):
        return {k: _tree_on_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        out = [_tree_on_meta(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return _on_meta(tree)


def meta_forward(fn: Callable, example_args: Tuple):
    """Run ``fn`` on the ``meta`` device: its inputs, and a module's
    parameters and buffers (swapped in by ``torch.func.functional_call``),
    as meta tensors of the same shapes and dtypes.  Nothing is computed,
    copied or launched, and a module's own tensors are left as they are."""
    args = tuple(_on_meta(a) for a in example_args)
    with torch.inference_mode():
        if isinstance(fn, torch.nn.Module):
            state = {name: _on_meta(t) for name, t in
                     list(fn.named_parameters()) + list(fn.named_buffers())}
            return torch.func.functional_call(fn, state, args)
        return fn(*args)


class _Program(torch.nn.Module):
    """A candidate's forward as a function of ``(params, x)``: the
    candidate is held outside the module tree, so none of its tensors
    becomes the program's."""

    def __init__(self, candidate: torch.nn.Module):
        super().__init__()
        self.__dict__["candidate"] = candidate

    def forward(self, params, x):
        return torch.func.functional_call(self.candidate, params, (x,))


def export_candidate(candidate, example_args: Tuple, target: TargetSpec,
                     schedules: Optional[Mapping[str, Any]] = None):
    """``candidate`` (a ``BuiltModel``) as a ``torch.export``
    ``ExportedProgram`` of ``(params, x)``, ``params`` its
    ``{state-dict name: tensor}`` mapping: an instance of its layers with
    weights on ``meta`` run through ``torch.func.functional_call``, traced
    on fake tensors of ``example_args``' shapes on ``target``'s device,
    with ``schedules`` active.  The kernels' tiles and chunks are baked in
    as constants, and the program holds no weights.  Nothing is placed,
    run or launched (no card is needed to trace for one), and
    :func:`generate_call_count` does not move."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.builder import BuiltModel

    shell = BuiltModel(candidate.layers, candidate.input_shape, candidate.output_dim,
                       candidate.arch, candidate.preprocess)
    device = torch.device(target.device)
    leaves = [(name, p.shape, p.dtype) for name, p in shell.named_parameters()]
    with FakeTensorMode():
        params = {name: torch.empty(shape, dtype=dtype, device=device)
                  for name, shape, dtype in leaves}
        args = tuple(torch.empty(a.shape, dtype=a.dtype, device=device) for a in example_args)
        with torch.no_grad(), ksched.use_schedules(schedules):
            program = torch.export.export(_Program(shell), (params, *args), strict=False)
    # fake tensors: nothing to keep, and reading them back would unpickle
    program.example_inputs = None
    return program


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@dataclasses.dataclass
class ProgramCost:
    """What one forward of a candidate does: operations, bytes moved and
    collective bytes (0 on one card), the bytes it holds at its peak, and
    each recorded kernel call site (kernel, shapes, ``calls``, and the
    operations and bytes of one call by
    :func:`repro_torch.kernels.ops.kernel_work`)."""

    flops: float
    bytes_accessed: float
    collective_bytes: float
    peak_bytes: int
    kernel_calls: List[Dict[str, Any]]

    @property
    def kernel_flops(self) -> float:
        return float(sum(c["flops"] * c["calls"] for c in self.kernel_calls))


def program_cost(candidate, example_args: Tuple,
                 schedules: Optional[Mapping[str, Any]] = None) -> ProgramCost:
    """Count one forward of ``candidate`` (a ``BuiltModel``) on
    ``example_args`` under ``schedules``, on the ``meta`` device, under
    ``torch.utils.flop_counter.FlopCounterMode`` and the kernel recorder.

    * Operations: the counter's total (matrix products and convolutions;
      it leaves out elementwise work) plus :func:`kernel_work` for every
      recorded kernel call: a kernel is a ``ctypes`` call the counter
      cannot see, and on ``meta`` it computes nothing.
    * Bytes, at the level of layers: the pre-processing stage and each
      layer read their input and their weights once and write their
      output once, and each kernel call moves the bytes
      :func:`kernel_work` gives it (its inputs read once, its outputs
      written once), the rule the kernels' bounds use.  Traffic inside a
      layer between its own operations is not counted.
    * Collective bytes: every collective the forward issues, by
      :class:`repro_torch.hwgen.collectives.CollectiveCounter` (the
      reference parses them from the compiled program): 0 on one card.
    * Peak bytes: the weights and the input, plus the largest pair of
      consecutive activations (a stage's input and output, both live
      while it runs): the counterpart of the reference's
      ``memory_analysis`` (arguments + output + temporaries), which it
      matches to 1.00-1.16x on the conv spaces.

    Weights and inputs are taken as meta tensors of their shapes and
    dtypes, so the candidate's own tensors, wherever they are, stay as
    they were."""
    (x,) = (_on_meta(a) for a in example_args)
    sink: Dict = {}
    nbytes = weights = 0
    held = [_nbytes(x)]  # every stage's output, the input first
    with torch.inference_mode(), ksched.use_schedules(schedules), \
            ksched.record_kernel_calls(sink), FlopCounterMode(display=False) as counter, \
            CollectiveCounter() as collectives:
        if candidate.preprocess is not None:
            y = candidate.preprocess(x)
            nbytes += _nbytes(x) + _nbytes(y)
            held.append(_nbytes(y))
            x = y
        for i, layer in enumerate(candidate.layers):
            params = {k: _on_meta(v) for k, v in getattr(candidate, f"layer_{i}").items()}
            y = layer.apply(params, x)
            w = sum(_nbytes(p) for p in params.values())
            nbytes += _nbytes(x) + w + _nbytes(y)
            weights += w
            held.append(_nbytes(y))
            x = y
    calls = []
    for entry in sink.values():
        flops, kbytes = kops.kernel_work(entry["kernel"], entry["shapes"], entry["meta"],
                                         entry["effective"])
        calls.append({"kernel": entry["kernel"], "shapes": entry["shapes"],
                      "calls": entry["calls"], "flops": flops, "bytes": kbytes})
    kernel_flops = sum(c["flops"] * c["calls"] for c in calls)
    kernel_bytes = sum(c["bytes"] * c["calls"] for c in calls)
    pair = max((a + b for a, b in zip(held, held[1:])), default=held[0])
    return ProgramCost(flops=float(counter.get_total_flops() + kernel_flops),
                       bytes_accessed=float(nbytes + kernel_bytes),
                       collective_bytes=float(total_collective_bytes(collectives.stats)),
                       peak_bytes=weights + held[0] + pair,
                       kernel_calls=calls)


_gate_lock = threading.Lock()
# one process group a process: sharded generates take turns on it
_sharded_lock = threading.Lock()

_generate_count_lock = threading.Lock()
_generate_count = 0


def generate_call_count() -> int:
    """Process-local count of :meth:`TorchGenerator.generate` calls (each
    places a candidate and runs it once).  Warm-restart checks assert this
    stays flat when every value comes from the disk cache."""
    return _generate_count


def measurement_gate_path(device: torch.device) -> str:
    """The lock file that every process measuring on CUDA card ``device``
    holds while it measures: one per card and user, in the temporary
    directory.  Naming it must not start CUDA (a new context is device work
    beside a sibling's timing): an unindexed device is the current one, which
    is 0 until CUDA has started."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device() if torch.cuda.is_initialized() else 0
    return os.path.join(tempfile.gettempdir(),
                        f"repro_torch-measurement-{os.getuid()}-cuda{index}.lock")


@contextlib.contextmanager
def measurement_gate(device: Optional[torch.device] = None) -> Iterator[None]:
    """Held by every generate and every timing, as the JAX package's
    ``compile_gate`` is: a forward or a timing taken while a sibling
    worker's candidate runs on the same device would report the
    contention, and the evaluation cache would keep that number.  Within a
    process it is a lock; on a CUDA ``device`` it also takes an exclusive
    lock on :func:`measurement_gate_path`, so that worker processes (the
    process backend spawns them) sharing a card measure one at a time."""
    with _gate_lock:
        if device is None or device.type != "cuda":
            yield
            return
        path = measurement_gate_path(device)
        with open(path, "a+b") as f:
            how = lock_file(f, path)
            try:
                yield
            finally:
                unlock_file(f, how)


@contextlib.contextmanager
def collector_off() -> Iterator[None]:
    """Python's cyclic garbage collector off for a timing, as ``timeit``
    turns it off.  A full collection with torch loaded takes tens of
    milliseconds; in a timed window's first forwards the host is not yet
    that far ahead of the card, so the pause reads as idle device time
    (``scripts/card_timing_drift.py``)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@functools.lru_cache(maxsize=None)
def _start_blas(device: torch.device) -> None:
    """Make cuBLAS's handles and their workspaces (32 MiB on an H100, kept
    for the life of the process) before this process's first measurement.
    Made during a candidate's forward, the workspace is held after it, and
    the peak rule (less what is held after) would take it off a peak it
    had no part in: a spawned worker's first conv candidate read 0.37x the
    peak the same candidate reads in a process that started cuBLAS before."""
    a = torch.ones((8, 8), device=device)
    torch.nn.functional.linear(a, a, a[0])
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def _placed(fn: Callable, example_args: Tuple, device: torch.device):
    """Yield copies of ``example_args``' tensors on ``device``, with ``fn``
    (a module is moved in place) there too; on exit ``fn`` goes back to
    the host.  The caller drops the yielded copies."""
    module = isinstance(fn, torch.nn.Module)
    if module:
        params = list(fn.parameters())
        before = [p.data for p in params]
        fn.to(device)
    try:
        yield tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                    for a in example_args)
    finally:
        if module:
            # an inference forward leaves the weights as they were: take
            # back the tensors they had rather than copy them off the card
            for p, data in zip(params, before):
                p.data = data
            fn.to("cpu")


class TorchGenerator:
    """Places candidates on their target's device and runs them once."""

    def __init__(self, target: TargetSpec | str):
        self.target = get_target(target) if isinstance(target, str) else target

    # -- reflection API (paper §VI) -----------------------------------------

    def supported_ops(self) -> frozenset:
        return self.target.supported_ops

    def capabilities(self) -> Dict[str, Any]:
        """The reference's five keys.  ``pallas`` means here that the
        target runs the hand-written kernels (the CUDA counterparts of the
        reference's Pallas kernels), from the target's ``supports_pallas``.
        For ``host_cpu`` and ``edge_npu`` every key equals the reference's;
        the H100 targets' ``pallas`` (True) and ``hbm_bytes`` (80 GiB) are
        the card's own, as the port has no TPU target to compare them to."""
        return {
            "ops": sorted(self.target.supported_ops),
            "pallas": self.target.supports_pallas,
            "chips": self.target.n_chips,
            "hbm_bytes": self.target.chip.hbm_bytes,
            "measurement": self.target.measurement,
        }

    def generate_cached(self, cache, key, fn: Callable, example_args: Tuple, **kw) -> Artifact:
        """Memoized :meth:`generate` through a shared
        :class:`~repro_torch.evaluation.cache.EvaluationCache`: estimators
        that need the same candidate's artifact (latency + memory) generate
        it once; concurrent workers racing on one key generate it once too
        (single-flight)."""
        return cache.get_or_compute(key, lambda: self.generate(fn, example_args, **kw))

    # -- generation -----------------------------------------------------------

    def generate(self, fn: Callable, example_args: Tuple, in_shardings=None,
                 schedules: Optional[Mapping[str, Any]] = None) -> Artifact:
        """With ``in_shardings`` (a tree of ``PartitionSpec`` shaped like
        ``example_args``, as ``distributed.sharding.shapes_shardings_from_axes``
        gives them): the sharded program, counted on the host
        (:meth:`_generate_sharded`).

        Otherwise place ``fn`` (a module, or a plain function) and the tensors of
        ``example_args`` on the target's device, run ``fn`` once under
        ``inference_mode``, and take them off the device again.

        On CUDA the artifact records the candidate's own peak: the most
        the allocator held from placement to the end of the forward, less
        what it still holds once the candidate is off the card (what other
        code keeps there, and library workspaces made on first use).  So
        it counts the weights, inputs, activations and output of this
        candidate, whatever the card held before and in whatever order
        candidates come.  ``fn`` ends on the host even if it was given
        on the device.  ``schedules`` (kernel -> schedule) are active for
        this forward and for every later run of the artifact.  For a
        ``roofline`` target nothing is placed or run (and
        :func:`generate_call_count` does not move): the artifact is the
        candidate on the host."""
        global _generate_count
        faults.fault_point("compile", key=self.target.name)
        if in_shardings is not None:
            return self._generate_sharded(fn, example_args, in_shardings, schedules)
        example_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in example_args)
        memory: Dict[str, int] = {}
        if self.target.measurement == "roofline":
            return Artifact(target=self.target, fn=fn, example_args=example_args,
                            memory=memory, schedules=schedules)
        with _generate_count_lock:
            _generate_count += 1
        artifact = Artifact(target=self.target, fn=fn, example_args=example_args,
                            memory=memory, schedules=schedules)
        memory.update(self.run_once(artifact))
        return artifact

    def _generate_sharded(self, fn: Callable, example_args: Tuple, in_shardings,
                          schedules=None) -> Artifact:
        """``fn(*example_args)`` laid out on the target's mesh and run once
        on the host, moving and launching nothing: the fake process group
        at the target's world for this generate alone (any other group
        running is refused with :class:`GeneratorError`), a
        ``cuda``-typed ``DeviceMesh`` of the target's shape and axes (so
        DTensor issues NCCL's collectives), every tensor of
        ``example_args`` a DTensor on ``meta`` with the placements of its
        ``PartitionSpec``, and ``fn`` run once under ``no_grad``, the
        schedules and :func:`repro_torch.hwgen.sharded.count`'s counters.
        The artifact's ``memory`` holds ``argument_bytes`` (each device's
        shards, exact) and ``peak_bytes_per_device`` (``MemTracker``'s
        peak, arguments included); ``flops``, ``bytes_accessed`` and
        ``collective_bytes`` are one device's, and ``roofline`` puts them
        against the target's chip (n_chips 1), as the reference's per-device
        program analysis does.  Sharded generates in one process take
        turns; :func:`generate_call_count` does not move (nothing is placed
        or run on a device)."""
        from repro_torch.hwgen import sharded
        from repro_torch.launch.mesh import make_mesh

        with _sharded_lock, contextlib.ExitStack() as stack:
            try:
                stack.enter_context(sharded.fake_group(self.target.n_chips))
            except RuntimeError as e:
                raise GeneratorError(f"target {self.target.name}: {e}") from e
            mesh = make_mesh(self.target.mesh_shape, self.target.mesh_axes, "cuda")
            args = sharded.distribute(_tree_on_meta(tuple(example_args)),
                                      tuple(in_shardings), mesh)
            argument_bytes = sharded.local_bytes(args)
            with torch.no_grad(), ksched.use_schedules(schedules):
                counted = sharded.count(fn, args, mesh, with_cost=True)
        return self._counted_artifact(fn, example_args, schedules, counted, argument_bytes,
                                      counted["peak"])

    def _counted_artifact(self, fn, example_args, schedules, counted, argument_bytes,
                          peak) -> Artifact:
        flops = float(counted["cost"]["flops"])
        nbytes = float(counted["cost"]["bytes_accessed"])
        coll = float(total_collective_bytes(counted["collectives"]))
        return Artifact(
            target=self.target, fn=fn, example_args=example_args,
            memory={"argument_bytes": int(argument_bytes), "peak_bytes_per_device": int(peak)},
            schedules=schedules, flops=flops, bytes_accessed=nbytes, collective_bytes=coll,
            collectives=counted["collectives"],
            roofline=roofline_terms(hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll,
                                    n_chips=1, chip=self.target.chip))

    def generate_by_units(self, build: Callable[[int], Tuple[Callable, Tuple, Any]],
                          units: int, schedules: Optional[Mapping[str, Any]] = None
                          ) -> Artifact:
        """A sharded program of ``units`` layer units, counted at 1 and 2
        units and extrapolated, as the dry run extrapolates a cell too slow
        to count whole on the host (from 1, not 0: a program's first unit
        may differ from the others).  ``build(n)`` returns ``(fn,
        example_args, in_shardings)`` for the program cut to ``n`` units.
        Operations, bytes, collectives by kind and argument bytes add up
        exactly by unit: q(units) = q(1) + (units - 1) (q(2) - q(1)).  The
        peak is the 2-unit program's peak plus the arguments the other units
        add (the dry run's ``peak_mode``), which is the whole program's
        where every unit holds the same activations at its peak.  The
        artifact's ``fn`` and ``example_args`` are ``build(units)``'s."""
        from repro_torch.hwgen import sharded

        lo, hi = (self.generate(*build(n), schedules=schedules) for n in (1, 2))

        def counts(a):
            return {"collectives": a.collectives,
                    "cost": {"flops": a.flops, "bytes_accessed": a.bytes_accessed}}

        counted = sharded.extrapolate(counts(lo), counts(hi), units, 1)
        args_lo, args_hi = lo.memory["argument_bytes"], hi.memory["argument_bytes"]
        argument_bytes = args_lo + (units - 1) * (args_hi - args_lo)
        peak = hi.memory["peak_bytes_per_device"] + argument_bytes - args_hi
        fn, example_args, _ = build(units)
        return self._counted_artifact(fn, example_args, schedules, counted, argument_bytes,
                                      peak)

    def run_once(self, artifact: Artifact) -> Dict[str, int]:
        """Place ``artifact`` on the target's device, run it once and take
        it off again; returns its memory record (``peak_bytes_per_device``
        on CUDA, the rule of :meth:`generate`; empty on the CPU).  For an
        artifact from the store whose record lacks a peak (a serving
        exploration stores programs it never ran); not a generate."""
        device = resolve_device(self.target.device)
        cuda = device.type == "cuda"
        memory: Dict[str, int] = {}
        with measurement_gate(device):
            if cuda:
                _start_blas(device)
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                held_before = torch.cuda.memory_allocated(device)
            with _placed(artifact.fn, artifact.example_args, device) as args:
                with torch.inference_mode(), ksched.use_schedules(artifact.schedules):
                    artifact(*args)
                del args
            if cuda:
                torch.cuda.synchronize(device)
                held_after = torch.cuda.memory_allocated(device)
                memory["peak_bytes_per_device"] = int(
                    torch.cuda.max_memory_allocated(device) - held_after)
                # what the card held before and after: the peak rule's terms
                memory["held_before_bytes"] = int(held_before)
                memory["held_after_bytes"] = int(held_after)
        return memory


class HardwareManager:
    """Deploys artifacts and extracts cost metrics (paper §VI): runs the
    candidate on its device and times it."""

    def __init__(self, warmup: int = 2, iters: int = 10):
        self.warmup = warmup
        self.iters = iters

    def benchmark(self, artifact: Artifact) -> Dict[str, float]:
        """Mean seconds of one eager forward over ``iters`` forwards after
        ``warmup``: CUDA events around them on the card (the device's
        time), the host clock around them on the CPU; the cyclic garbage
        collector off meanwhile (:func:`collector_off`).  On a ``roofline``
        target, the roofline bound of one forward of the artifact's
        candidate (a ``BuiltModel``), counted by :func:`program_cost` on
        the ``meta`` device against the target's chip: nothing is placed
        or run, and ``measured`` is 0."""
        if artifact.target.measurement == "roofline":
            cost = program_cost(artifact.fn, artifact.example_args, artifact.schedules)
            r = roofline_terms(hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
                               collective_bytes=cost.collective_bytes, n_chips=1,
                               chip=artifact.target.chip)
            return {"latency_s": r.bound_s, "compute_s": r.compute_s,
                    "memory_s": r.memory_s, "collective_s": r.collective_s,
                    "measured": 0.0}
        device = resolve_device(artifact.target.device)
        with measurement_gate(device), _placed(artifact.fn, artifact.example_args,
                                               device) as args, \
                torch.inference_mode(), ksched.use_schedules(artifact.schedules), \
                collector_off():
            for _ in range(self.warmup):
                artifact(*args)
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(self.iters):
                    artifact(*args)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / self.iters
            else:
                t0 = time.perf_counter()
                for _ in range(self.iters):
                    artifact(*args)
                dt = (time.perf_counter() - t0) / self.iters
        return {"latency_s": dt, "measured": 1.0}
