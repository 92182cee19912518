"""Traffic-shaped serving estimators (the serving-path counterpart of
the latency/memory estimators).

A candidate that wins on single-request kernel time can still lose in
production: tail latency and throughput depend on how requests arrive,
how long their prompts are, and how the engine batches.  These
estimators rank candidates under the experiment's **declared traffic
mix** (the validated ``serving:`` section, injected by the Explorer as
the ``serving`` kwarg):

  * ``prefill_latency_s`` — roofline bound of one full-batch prompt
    forward at ``(max_batch, L, C)``
  * ``decode_latency_s`` — analytic per-step decode bound: per-token
    FLOPs vs the parameter + decode-state bytes streamed every step
  * ``kv_cache_peak_bytes`` — peak decode-state footprint the traffic
    actually reaches (simulated concurrency × per-layer state metadata)
  * ``throughput_tok_s`` / ``p99_latency_s`` — summary of a
    discrete-event simulation of the continuous-batching engine
    (:class:`repro_torch.launch.traffic.ServingSim`) under the declared mix

Every value is a deterministic pure function of (program, chip
constants, serving spec): the simulator advances a modelled clock, never
a wall clock, so fixed-seed sweeps produce identical rankings on the
serial and process backends.

This is the JAX package's ``evaluation/serving.py`` on the port.  The
reference takes the prefill's terms from the compiled program; here they
are the forward counted on the ``meta`` device
(:func:`~repro_torch.hwgen.generator.program_cost`), cached under the key
``latency_s`` at ``metric: modelled`` uses, so one count serves both and
nothing is placed or run.  The decode step and the simulation are the
reference's arithmetic, step for step.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from repro_torch.core.builder import BuiltModel
from repro_torch.evaluation.cache import EvaluationCache
from repro_torch.evaluation.estimators import _CompiledEstimator
from repro_torch.explorer.registry import ESTIMATORS
from repro_torch.hwgen.autotune import ScheduleTuner
from repro_torch.hwgen.roofline import roofline_terms
from repro_torch.hwgen.targets import TargetSpec
from repro_torch.launch.traffic import ServingCosts, ServingSim


def resolve_serving(serving: Any):
    """Normalize the injected ``serving`` value to a ServingSpec: the
    spec object itself, a raw mapping, or None (all defaults)."""
    from repro_torch.explorer.experiment import ServingSpec

    if serving is None:
        return ServingSpec()
    if isinstance(serving, ServingSpec):
        return serving
    spec = ServingSpec.from_raw(serving)
    return spec if spec is not None else ServingSpec()


class _ServingEstimator(_CompiledEstimator):
    """Shared machinery: counted prefill terms + analytic decode costs
    + the memoized traffic simulation, all under the shared cache."""

    def __init__(self, target: TargetSpec | str,
                 serving: Any = None,
                 cache: Optional[EvaluationCache | str] = None,
                 tuner: Optional[ScheduleTuner] = None):
        spec = resolve_serving(serving)
        super().__init__(target, batch=spec.max_batch, cache=cache,
                         tuner=tuner)
        self.serving = spec
        # the spec is part of every derived value's identity
        self._serving_sig = json.dumps(spec.to_dict(), sort_keys=True,
                                       separators=(",", ":"))

    # -- modelled costs ------------------------------------------------------

    def _forward_terms(self, candidate: BuiltModel, plan):
        """Chip-independent (flops, bytes, collective) of the full-batch
        forward, counted on ``meta``; the entry ``latency_s`` at
        ``metric: modelled`` reads at the same batch."""
        return self._roofline_terms(candidate, plan)

    def _prefill_bound_s(self, candidate: BuiltModel, plan) -> float:
        """Roofline bound of one (max_batch, L, C) prompt forward."""
        terms = self._forward_terms(candidate, plan)
        report = roofline_terms(
            hlo_flops=terms[0], hlo_bytes=terms[1],
            collective_bytes=terms[2], n_chips=1,
            chip=self.generator.target.chip)
        return float(report.bound_s)

    def _decode_step_s(self, candidate: BuiltModel) -> float:
        """Analytic bound of one continuous-batching decode step: the
        whole active batch advances one token.  Compute scales with the
        batch; memory streams the parameters once per step plus each
        sequence's decode state at the traffic's mean context depth."""
        spec = self.serving
        chip = self.generator.target.chip
        seq_len = max(1, int(candidate.input_shape[-1]))
        flops_per_token = candidate.flops / seq_len
        mean_prompt = sum(l * w for l, w in spec.traffic.prompt_lens.items())
        mean_gen = sum(l * w for l, w in spec.traffic.gen_lens.items())
        mean_ctx = mean_prompt + 0.5 * mean_gen
        state_bytes = spec.max_batch * spec.dtype_bytes * (
            candidate.state_elems_fixed
            + candidate.state_elems_per_token * mean_ctx)
        param_bytes = candidate.n_params * 4  # f32 weights
        compute_s = spec.max_batch * flops_per_token / chip.peak_flops_bf16
        memory_s = (param_bytes + state_bytes) / chip.hbm_bandwidth
        return max(compute_s, memory_s)

    # -- the traffic simulation ---------------------------------------------

    def _simulate(self, candidate: BuiltModel, context=None) -> Dict[str, Any]:
        plan = self._schedule_plan(candidate, context)
        spec = self.serving
        prefill_bound = self._prefill_bound_s(candidate, plan)
        seq_len = max(1, int(candidate.input_shape[-1]))
        costs = ServingCosts(
            prefill_s_per_token=prefill_bound / (spec.max_batch * seq_len),
            decode_step_s=self._decode_step_s(candidate),
        )

        def run():
            sim = ServingSim(max_batch=spec.max_batch,
                             queue_limit=spec.queue_limit)
            summary = sim.run(spec.traffic.requests(), costs)
            summary.pop("shed_ids", None)  # keys must stay JSON-scalar-ish
            return summary

        key = self._program_key("serving_sim", candidate, plan[1]) \
            + (("serving", self._serving_sig),)
        return self.cache.get_or_compute(key, run)


@ESTIMATORS.register("prefill_latency_s")
class PrefillLatencyEstimator(_ServingEstimator):
    """Modelled latency of one full-batch prompt forward (the engine's
    prefill step) at ``(max_batch, L, C)``."""

    name = "prefill_latency_s"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        plan = self._schedule_plan(candidate, context)
        return self._prefill_bound_s(candidate, plan)


@ESTIMATORS.register("decode_latency_s")
class DecodeLatencyEstimator(_ServingEstimator):
    """Analytic per-step decode latency at the declared concurrency:
    max(compute, parameter + decode-state bandwidth) per engine step."""

    name = "decode_latency_s"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        return self._decode_step_s(candidate)


@ESTIMATORS.register("kv_cache_peak_bytes")
class KVCachePeakBytesEstimator(_ServingEstimator):
    """Peak decode-state bytes the declared traffic actually reaches:
    simulated peak cached tokens × per-token state elements, plus the
    fixed (context-independent) state of every concurrently-active
    sequence."""

    name = "kv_cache_peak_bytes"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        summary = self._simulate(candidate, context)
        spec = self.serving
        grown = summary["kv_peak_tokens"] * candidate.state_elems_per_token
        fixed = summary["peak_concurrency"] * candidate.state_elems_fixed
        return float((grown + fixed) * spec.dtype_bytes)


@ESTIMATORS.register("throughput_tok_s")
class ThroughputEstimator(_ServingEstimator):
    """Decoded tokens per second over the simulated run (maximize)."""

    name = "throughput_tok_s"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        return float(self._simulate(candidate, context)["throughput_tok_s"])


@ESTIMATORS.register("p99_latency_s")
class P99LatencyEstimator(_ServingEstimator):
    """99th-percentile request latency (arrival to last token) under the
    declared traffic mix — the serving criterion sweeps rank by."""

    name = "p99_latency_s"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        return float(self._simulate(candidate, context)["p99_latency_s"])
