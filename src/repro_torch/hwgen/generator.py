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
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import faults
from repro_torch.device import resolve_device
from repro_torch.hwgen.roofline import roofline_terms
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


def _on_meta(value):
    if isinstance(value, torch.Tensor):
        return torch.empty_like(value, device="meta")
    return value


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
    * Collective bytes: 0 (one card).
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
            ksched.record_kernel_calls(sink), FlopCounterMode(display=False) as counter:
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
                       collective_bytes=0.0, peak_bytes=weights + held[0] + pair,
                       kernel_calls=calls)


_gate_lock = threading.Lock()

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

    def generate(self, fn: Callable, example_args: Tuple,
                 schedules: Optional[Mapping[str, Any]] = None) -> Artifact:
        """Place ``fn`` (a module, or a plain function) and the tensors of
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
        example_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in example_args)
        memory: Dict[str, int] = {}
        if self.target.measurement == "roofline":
            return Artifact(target=self.target, fn=fn, example_args=example_args,
                            memory=memory, schedules=schedules)
        with _generate_count_lock:
            _generate_count += 1
        device = resolve_device(self.target.device)
        cuda = device.type == "cuda"
        with measurement_gate(device):
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            with _placed(fn, example_args, device) as args:
                with torch.inference_mode(), ksched.use_schedules(schedules):
                    fn(*args)
                del args
            if cuda:
                torch.cuda.synchronize(device)
                memory["peak_bytes_per_device"] = int(
                    torch.cuda.max_memory_allocated(device)
                    - torch.cuda.memory_allocated(device))
        return Artifact(target=self.target, fn=fn, example_args=example_args,
                        memory=memory, schedules=schedules)


class HardwareManager:
    """Deploys artifacts and extracts cost metrics (paper §VI): runs the
    candidate on its device and times it."""

    def __init__(self, warmup: int = 2, iters: int = 10):
        self.warmup = warmup
        self.iters = iters

    def benchmark(self, artifact: Artifact) -> Dict[str, float]:
        """Mean seconds of one eager forward over ``iters`` forwards after
        ``warmup``: CUDA events around them on the card (the device's
        time), the host clock around them on the CPU.  On a ``roofline``
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
        fn = artifact.fn
        with measurement_gate(device), _placed(fn, artifact.example_args, device) as args, \
                torch.inference_mode(), ksched.use_schedules(artifact.schedules):
            for _ in range(self.warmup):
                fn(*args)
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(self.iters):
                    fn(*args)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3 / self.iters
            else:
                t0 = time.perf_counter()
                for _ in range(self.iters):
                    fn(*args)
                dt = (time.perf_counter() - t0) / self.iters
        return {"latency_s": dt, "measured": 1.0}
