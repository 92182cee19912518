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
the card, with the host clock on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Tuple

import torch

from repro_torch import faults
from repro_torch.device import resolve_device
from repro_torch.hwgen.targets import TargetSpec, get_target


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


class GeneratorError(RuntimeError):
    pass


_gate_lock = threading.Lock()


def measurement_gate() -> threading.Lock:
    """The lock every generate and every timing holds, as the JAX
    package's ``compile_gate`` does: a forward or a timing taken while a
    sibling worker's candidate runs on the same device would report the
    contention, and the evaluation cache would keep that number."""
    return _gate_lock


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

    def generate(self, fn: Callable, example_args: Tuple) -> Artifact:
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
        on the device."""
        faults.fault_point("compile", key=self.target.name)
        device = resolve_device(self.target.device)
        cuda = device.type == "cuda"
        example_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in example_args)
        memory: Dict[str, int] = {}
        with measurement_gate():
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            with _placed(fn, example_args, device) as args:
                with torch.inference_mode():
                    fn(*args)
                del args
            if cuda:
                torch.cuda.synchronize(device)
                memory["peak_bytes_per_device"] = int(
                    torch.cuda.max_memory_allocated(device)
                    - torch.cuda.memory_allocated(device))
        return Artifact(target=self.target, fn=fn, example_args=example_args,
                        memory=memory)


class HardwareManager:
    """Deploys artifacts and extracts cost metrics (paper §VI): runs the
    candidate on its device and times it."""

    def __init__(self, warmup: int = 2, iters: int = 10):
        self.warmup = warmup
        self.iters = iters

    def benchmark(self, artifact: Artifact) -> Dict[str, float]:
        """Mean seconds of one eager forward over ``iters`` forwards after
        ``warmup``: CUDA events around them on the card (the device's
        time), the host clock around them on the CPU."""
        if artifact.target.measurement != "wallclock":
            raise GeneratorError(
                f"target {artifact.target.name} measures by "
                f"{artifact.target.measurement!r}; the port times candidates "
                f"on their device only (roofline targets come with "
                f"metric: modelled, ROADMAP.md Queue 1 item 3)")
        device = resolve_device(artifact.target.device)
        fn = artifact.fn
        with measurement_gate(), _placed(fn, artifact.example_args, device) as args, \
                torch.inference_mode():
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
