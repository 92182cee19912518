"""Cost estimators (paper §V).

  * ParamCountEstimator / FlopsEstimator / ActivationMemoryEstimator —
    analytical, from BuiltModel metadata (fast, nothing runs)
  * CompiledLatencyEstimator — hardware-in-the-loop: places the candidate
    on the target's device through the generator and returns its measured
    forward time (``metric="measured"``)
  * CompiledMemoryEstimator — the candidate's own peak device memory in
    one forward, from the CUDA allocator

The names are the JAX package's, so one experiment names the same
estimators in both.  The roofline-modelled latency (``metric="modelled"``)
and the kernel-schedule tuner come with the next slice (ROADMAP.md,
Queue 1 items 3 and 4), the trained-accuracy estimator with training.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.builder import BuiltModel
from repro_torch.device import resolve_device
from repro_torch.evaluation.api import Estimator
from repro_torch.evaluation.cache import EvaluationCache
from repro_torch.explorer.registry import ESTIMATORS
from repro_torch.hwgen.generator import HardwareManager, TorchGenerator
from repro_torch.hwgen.targets import TargetSpec


@ESTIMATORS.register("n_params")
class ParamCountEstimator(Estimator):
    name = "n_params"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        return float(candidate.n_params)


@ESTIMATORS.register("flops")
class FlopsEstimator(Estimator):
    name = "flops"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        return float(candidate.flops)


@ESTIMATORS.register("activation_bytes")
class ActivationMemoryEstimator(Estimator):
    """Analytical activation footprint: max layer output size (batch 1)."""

    name = "activation_bytes"
    bytes_per_el = 4

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        peak = max((math.prod(l.out_shape) for l in candidate.layers), default=0)
        return float(peak * self.bytes_per_el)


class _CompiledEstimator(Estimator):
    """Shared machinery for estimators that need a generated artifact.

    The artifact and the derived values are memoized in an
    :class:`EvaluationCache` keyed by the candidate's *full* architecture
    signature (layers + pre-processing) plus the batch size and a scope:
    the target's ``mesh_scope`` (which names its device) for what the
    program determines, the target's name for measurements.  Passing the
    same cache to several estimators makes them share artifacts: latency
    and memory for one candidate cost one generate.
    """

    def __init__(self, target: TargetSpec | str, batch: int = 1,
                 cache: Optional[EvaluationCache] = None):
        self.generator = TorchGenerator(target)
        self.batch = batch
        self.cache = EvaluationCache() if cache is None else cache
        if not isinstance(self.cache, EvaluationCache):
            raise NotImplementedError(
                "the port's estimators take an EvaluationCache; a store path "
                "is the disk tier, ROADMAP.md Queue 1 item 2")

    def _program_key(self, name: str, candidate: BuiltModel):
        return (name, self.generator.target.mesh_scope, self.batch,
                EvaluationCache.candidate_key(candidate))

    def _target_key(self, name: str, candidate: BuiltModel):
        return (name, self.generator.target.name, self.batch,
                EvaluationCache.candidate_key(candidate))

    def _artifact(self, candidate: BuiltModel):
        """The candidate with weights drawn from seed 0, run once on the
        target's device on a zero batch of ``self.batch`` examples.  The
        weights are drawn on the device (far faster than on the host) but
        kept on the host with the batch: the generator places both on the
        device for each run and counts them in the candidate's peak."""

        def produce():
            device = resolve_device(self.generator.target.device)
            l, c = candidate.input_shape[-1], candidate.input_shape[0]
            gen = torch.Generator(device=device).manual_seed(0)
            model = candidate.init(gen, device).to("cpu")
            x = torch.zeros((self.batch, l, c), dtype=torch.float32)
            return self.generator.generate(model, (x,))

        return self.cache.get_or_compute(self._program_key("artifact", candidate),
                                         produce)


@ESTIMATORS.register("latency_s")
class CompiledLatencyEstimator(_CompiledEstimator):
    """Hardware-in-the-loop latency via the generator pipeline (paper §VI
    mode 2): the mean time of one forward on the target's device.  Results
    are cached by full architecture signature."""

    name = "latency_s"

    def __init__(self, target: TargetSpec | str, batch: int = 1,
                 manager: Optional[HardwareManager] = None,
                 cache: Optional[EvaluationCache] = None,
                 metric: str = "measured"):
        super().__init__(target, batch=batch, cache=cache)
        if metric == "modelled":
            raise NotImplementedError(
                "latency metric 'modelled' (the roofline bound) is not ported "
                "yet: ROADMAP.md Queue 1 item 3 (metric: modelled)")
        if metric != "measured":
            raise ValueError(
                f"unknown latency metric {metric!r}; expected 'measured' or 'modelled'")
        self.manager = manager or HardwareManager()
        self.metric = metric

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        def compute() -> float:
            artifact = self._artifact(candidate)
            return float(self.manager.benchmark(artifact)["latency_s"])

        return self.cache.get_or_compute(
            ("measured",) + self._target_key(self.name, candidate), compute)


@ESTIMATORS.register("peak_bytes")
class CompiledMemoryEstimator(_CompiledEstimator):
    """Peak bytes the CUDA allocator held for one forward of the candidate
    (its weights, inputs, activations and output), whatever else the card
    holds.  A CPU target keeps no such statistics."""

    name = "peak_bytes"

    def __init__(self, target: TargetSpec | str, batch: int = 1,
                 cache: Optional[EvaluationCache] = None):
        super().__init__(target, batch=batch, cache=cache)
        if self.generator.target.device != "cuda":
            raise ValueError(
                f"peak_bytes needs a CUDA target: {self.generator.target.name} "
                f"runs on {self.generator.target.device}, which has no "
                f"allocator statistics")

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        def compute() -> float:
            artifact = self._artifact(candidate)
            return float(artifact.memory["peak_bytes_per_device"])

        return self.cache.get_or_compute(self._program_key(self.name, candidate),
                                         compute)
