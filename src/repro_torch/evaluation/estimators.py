"""Cost estimators (paper §V).

  * ParamCountEstimator / FlopsEstimator / ActivationMemoryEstimator —
    analytical, from BuiltModel metadata (fast, nothing runs)
  * CompiledLatencyEstimator — hardware-in-the-loop: places the candidate
    on the target's device through the generator and returns its measured
    forward time (``metric="measured"``; a ``roofline`` target such as
    ``edge_npu`` runs nothing and gives the bound below), or the roofline
    bound of its forward on the target's chip (``metric="modelled"``:
    counted on the ``meta`` device, nothing runs)
  * CompiledMemoryEstimator — the candidate's own peak device memory in
    one forward, from the CUDA allocator; on a CPU target, which keeps no
    allocator statistics, the peak counted on the ``meta`` device

The names are the JAX package's, so one experiment names the same
estimators in both.  A kernel-schedule tuner (``tuner=``) or schedules in
the trial's context retarget the candidate's kernels, and the effective
schedules' signature joins the cache keys, as in the reference.

  * TrainedAccuracyEstimator (``val_accuracy``) — trains the candidate
    briefly on the data in the context (SGD with momentum) and returns
    its validation accuracy, reporting it to the trial for pruning
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from repro_torch.core.builder import BuiltModel
from repro_torch.device import resolve_device
from repro_torch.evaluation.api import Estimator
from repro_torch.evaluation.cache import EvaluationCache
from repro_torch.explorer.registry import ESTIMATORS
from repro_torch.hwgen.autotune import ScheduleTuner, discover_kernel_calls
from repro_torch.hwgen.generator import (
    HardwareManager, TorchGenerator, measurement_gate, meta_forward, program_cost)
from repro_torch.hwgen.roofline import roofline_terms
from repro_torch.hwgen.targets import TargetSpec
from repro_torch.kernels import schedule as ksched


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
    and memory for one candidate cost one generate.  ``cache`` may also be
    a store-directory path (or ``True`` for the default ``results/cache/``),
    which wraps a fresh cache around the disk tier so values survive
    restarts.  A disk-tiered cache also gets the artifact store
    (:class:`~repro_torch.evaluation.artifact_store.ArtifactStore`): each
    generated candidate's program persists next to the values, and a
    later process (``serve --from-report``, a warm restart) loads it
    instead of generating (``REPRO_ARTIFACTS=0`` opts out).
    """

    def __init__(self, target: TargetSpec | str, batch: int = 1,
                 cache: Optional[EvaluationCache | str] = None,
                 tuner: Optional[ScheduleTuner] = None):
        self.generator = TorchGenerator(target)
        self.batch = batch
        if cache is None:
            cache = EvaluationCache()
        elif not isinstance(cache, EvaluationCache):
            cache = EvaluationCache(disk=cache)
        self.cache = cache
        self.tuner = tuner
        self.artifacts = None
        if cache.disk is not None and self.generator.target.measurement != "roofline":
            from repro_torch.evaluation.artifact_store import ArtifactStore, store_enabled

            if store_enabled():
                self.artifacts = ArtifactStore(cache.disk.path)

    def _program_key(self, name: str, candidate: BuiltModel, sig=None):
        """Key for values the program determines, scoped by the target's
        ``mesh_scope``.  ``sig`` is the *effective* kernel-schedule
        signature; ``None`` (no tuning, no context schedules) keeps the
        untuned key shape."""
        key = (name, self.generator.target.mesh_scope, self.batch,
               EvaluationCache.candidate_key(candidate))
        return key if sig is None else key + (("sched", sig),)

    def _target_key(self, name: str, candidate: BuiltModel, sig=None):
        """Key for deployment-specific values (measurements)."""
        key = (name, self.generator.target.name, self.batch,
               EvaluationCache.candidate_key(candidate))
        return key if sig is None else key + (("sched", sig),)

    def _schedule_plan(self, candidate: BuiltModel, context=None):
        """(schedules, effective-signature) for this candidate.

        ``(None, None)`` — the untuned path — when no schedules arrived
        via context (``kernel_tuning.mode: search`` trial params) and no
        tuner is attached, or when a forward on the ``meta`` device shows
        the candidate reaches no schedulable kernel: cache keys then keep
        the untuned shape.  Otherwise the plan is: per discovered kernel,
        context schedule > tuner override > tuned winner, and the
        signature is taken from a second recording meta forward so it
        reflects the *effective* (shape-clamped) schedules."""
        from_context = (context or {}).get("schedules")
        if from_context is None and self.tuner is None:
            return None, None
        l, c = candidate.input_shape[-1], candidate.input_shape[0]
        x = torch.empty((self.batch, l, c), dtype=torch.float32, device="meta")
        calls = discover_kernel_calls(candidate, (x,))
        if not calls:
            return None, None
        plan: Dict[str, ksched.KernelSchedule] = {}
        for entry in calls.values():
            kernel = entry["kernel"]
            if kernel in plan:
                continue
            if from_context and kernel in from_context:
                plan[kernel] = ksched.as_schedule(kernel, from_context[kernel])
            elif self.tuner is not None:
                if kernel in self.tuner.overrides:
                    plan[kernel] = self.tuner.overrides[kernel]
                else:
                    record = self.tuner.tune(kernel, entry["shapes"], entry["meta"])
                    plan[kernel] = ksched.as_schedule(kernel, record["schedule"])
            else:
                plan[kernel] = ksched.default_schedule(kernel)
        sink: Dict = {}
        with ksched.use_schedules(plan), ksched.record_kernel_calls(sink):
            meta_forward(candidate, (x,))
        sig = ksched.effective_signature(sink)
        trial = (context or {}).get("trial")
        set_attr = getattr(trial, "set_user_attr", None)
        if set_attr is not None:
            set_attr("kernel_schedules",
                     {k: s.to_dict() for k, s in sorted(plan.items())})
        return plan, sig

    def _count(self, candidate: BuiltModel, plan):
        """One forward of the candidate at ``self.batch`` on the plan's
        schedules, counted on the ``meta`` device (nothing runs)."""
        l, c = candidate.input_shape[-1], candidate.input_shape[0]
        x = torch.empty((self.batch, l, c), dtype=torch.float32, device="meta")
        return program_cost(candidate, (x,), schedules=plan[0])

    def _roofline_terms(self, candidate: BuiltModel, plan):
        """The chip-independent ``[flops, bytes, collective bytes]`` of one
        forward (:meth:`_count`), cached under ``roofline_terms`` and the
        target's ``mesh_scope``: every estimator that needs them (modelled
        latency, the serving estimators) and every target of the same
        scope (``host_cpu`` and ``edge_npu``) counts a candidate once."""
        def compute_terms():
            cost = self._count(candidate, plan)
            return [cost.flops, cost.bytes_accessed, cost.collective_bytes]

        return self.cache.get_or_compute(
            self._program_key("roofline_terms", candidate, plan[1]), compute_terms)

    def _artifact(self, candidate: BuiltModel, plan=None):
        """The candidate with weights drawn from seed 0, run once on the
        target's device on a zero batch of ``self.batch`` examples, its
        kernels on the plan's schedules.  The weights are drawn on the
        device (far faster than on the host) but kept on the host with the
        batch: the generator places both on the device for each run and
        counts them in the candidate's peak.  Drawing them is device work, so
        it holds the measurement gate: a sibling process's timing must not
        run beside it.  With a store attached, a stored program is loaded
        and bound to those weights instead of generating (read-through),
        and a generated one is stored (write-through)."""
        schedules, sig = plan if plan is not None else (None, None)
        key = self._program_key("artifact", candidate, sig)

        def produce():
            device = resolve_device(self.generator.target.device)
            l, c = candidate.input_shape[-1], candidate.input_shape[0]
            with measurement_gate(device):
                gen = torch.Generator(device=device).manual_seed(0)
                model = candidate.init(gen, device).to("cpu")
            x = torch.zeros((self.batch, l, c), dtype=torch.float32)
            if self.artifacts is not None:
                loaded = self.artifacts.get(key, target=self.generator.target,
                                            fn=model, example_args=(x,))
                if loaded is not None:
                    return loaded
            generated = self.generator.generate(model, (x,), schedules=schedules)
            if self.artifacts is not None:
                self.artifacts.put(key, generated)
            return generated

        artifact = self.cache.get_or_compute(key, produce)
        if artifact.target is not self.generator.target:
            # generated for a sibling target of the same mesh scope: the
            # program is the same, but its measurement is this target's
            artifact = dataclasses.replace(artifact, target=self.generator.target)
        return artifact


@ESTIMATORS.register("latency_s")
class CompiledLatencyEstimator(_CompiledEstimator):
    """Hardware-in-the-loop latency via the generator pipeline (paper §VI
    mode 2).  Results are cached by full architecture signature.

    ``metric="measured"`` returns the mean time of one forward on the
    target's device; ``metric="modelled"`` the roofline bound of one
    forward (:func:`~repro_torch.hwgen.generator.program_cost` against
    the target's chip constants): deterministic across runs, and nothing
    is placed on a device or run.  As in the reference, its compute term
    divides by the chip's bf16 peak whatever the candidate's dtype, so
    for fp32 candidates it is the bound of the same work in bf16.
    """

    name = "latency_s"

    def __init__(self, target: TargetSpec | str, batch: int = 1,
                 manager: Optional[HardwareManager] = None,
                 cache: Optional[EvaluationCache | str] = None,
                 metric: str = "measured",
                 tuner: Optional[ScheduleTuner] = None):
        super().__init__(target, batch=batch, cache=cache, tuner=tuner)
        if metric not in ("measured", "modelled"):
            raise ValueError(
                f"unknown latency metric {metric!r}; expected 'measured' or 'modelled'")
        self.manager = manager or HardwareManager()
        self.metric = metric

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        plan = self._schedule_plan(candidate, context)
        if self.metric == "modelled":
            # the chip-independent terms are cached, the target's chip is
            # applied afterwards: a sibling target of the same mesh scope
            # gets its modelled latency from the cached terms
            terms = self._roofline_terms(candidate, plan)
            report = roofline_terms(
                hlo_flops=terms[0], hlo_bytes=terms[1], collective_bytes=terms[2],
                n_chips=1, chip=self.generator.target.chip)
            return float(report.bound_s)

        def compute() -> float:
            artifact = self._artifact(candidate, plan)
            return float(self.manager.benchmark(artifact)["latency_s"])

        return self.cache.get_or_compute(
            ("measured",) + self._target_key(self.name, candidate, plan[1]), compute)


@ESTIMATORS.register("peak_bytes")
class CompiledMemoryEstimator(_CompiledEstimator):
    """Peak bytes the CUDA allocator held for one forward of the candidate
    (its weights, inputs, activations and output), whatever else the card
    holds.  A CPU target keeps no such statistics: there the peak is
    counted on the ``meta`` device (``ProgramCost.peak_bytes``: weights,
    input and the largest pair of consecutive activations, the
    counterpart of the reference's memory analysis), and nothing runs."""

    name = "peak_bytes"

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        plan = self._schedule_plan(candidate, context)

        def compute() -> float:
            if self.generator.target.device != "cuda":
                return float(self._count(candidate, plan).peak_bytes)
            artifact = self._artifact(candidate, plan)
            if "peak_bytes_per_device" not in artifact.memory:
                # loaded from a store entry that no process ran
                artifact.memory.update(self.generator.run_once(artifact))
            return float(artifact.memory["peak_bytes_per_device"])

        return self.cache.get_or_compute(self._program_key(self.name, candidate, plan[1]),
                                         compute)


def refuse_kernel_candidate(estimator: str, candidate: BuiltModel, batch: int) -> None:
    """Raise ``NotImplementedError`` if a forward of ``candidate`` at
    ``batch`` reaches a kernel, found by a forward on the ``meta`` device
    (nothing is drawn, placed or run): ``estimator`` needs its gradient,
    and the CUDA kernels are forward-only, as the reference's Pallas
    kernels have no gradient."""
    l, c = candidate.input_shape[-1], candidate.input_shape[0]
    x = torch.empty((batch, l, c), dtype=torch.float32, device="meta")
    kernels = sorted({entry["kernel"] for entry in
                      discover_kernel_calls(candidate, (x,)).values()})
    if kernels:
        raise NotImplementedError(
            f"{estimator} needs the gradient through the {', '.join(kernels)} "
            f"kernel(s) this candidate reaches ({candidate.arch.signature()}); the "
            f"CUDA kernels are forward-only, as the reference's Pallas kernels have "
            f"no gradient, so the reference cannot differentiate such a candidate "
            f"either: train on impl 'xla'")


Weights = Dict[str, Dict[str, torch.Tensor]]


@ESTIMATORS.register("val_accuracy")
class TrainedAccuracyEstimator(Estimator):
    """Short-budget training + validation accuracy (maximize).

    context/data: {"x_train", "y_train", "x_val", "y_val"} (numpy).
    Reports intermediate accuracy to the trial for pruning when provided.
    The reference's loop: SGD with momentum on the mean cross-entropy,
    batches drawn by ``np.random.default_rng(0)``, ``trial.report(i + 1,
    -acc)`` every ``report_every`` steps.

    Where the port differs from the reference:

    * It trains on the card unless the caller asks for the CPU
      (``device=``), holding
      :func:`~repro_torch.hwgen.generator.measurement_gate` while it runs,
      so no sibling worker times a candidate beside it.
    * The weights are drawn from a ``torch.Generator`` seeded 0 by one
      overridable method, :meth:`_weights` (the reference's
      ``candidate.init(PRNGKey(0))``; a test feeds both the same
      converted weights).
    * A candidate that reaches a kernel is refused before any step: the
      CUDA kernels are forward-only, and the reference cannot
      differentiate its Pallas kernels either.
    """

    name = "val_accuracy"

    def __init__(self, steps: int = 60, batch: int = 32, lr: float = 1e-3,
                 momentum: float = 0.9, report_every: int = 20, device="cuda"):
        self.steps = steps
        self.batch = batch
        self.lr = lr
        self.momentum = momentum
        self.report_every = report_every
        self.device = resolve_device(device)

    def _weights(self, candidate: BuiltModel) -> Weights:
        """Each layer's weights, ``{"layer_<i>": {leaf: tensor}}`` on this
        estimator's device, drawn from a generator seeded 0 on that device."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        return {f"layer_{i}": {k: v.to(self.device) for k, v in layer.init(gen).items()}
                for i, layer in enumerate(candidate.layers)}

    @staticmethod
    def _apply(candidate: BuiltModel, params: Weights, x: torch.Tensor) -> torch.Tensor:
        """The candidate's forward (pre-processing included) on ``params``."""
        if candidate.preprocess is not None:
            x = candidate.preprocess(x)
        for i, layer in enumerate(candidate.layers):
            x = layer.apply(params[f"layer_{i}"], x)
        return x

    def accuracy(self, candidate: BuiltModel, params: Weights, x, y) -> float:
        with torch.no_grad():
            x = torch.as_tensor(x, device=self.device)
            y = torch.as_tensor(y, device=self.device)
            pred = torch.argmax(self._apply(candidate, params, x), dim=-1)
            # the reference's fp32 mean, which XLA computes as the sum times
            # fp32(1/n): 20 of 96 is one ulp above the division's rounding
            return float((pred == y).to(torch.float32).sum() * (1.0 / y.numel()))

    def fit(self, candidate: BuiltModel, data, trial=None) -> Tuple[Weights, float]:
        """Train ``candidate`` for ``steps`` steps on ``data``.  Returns the
        trained weights and the last step's loss; raises ``TrialPruned``
        when the trial says so at a report."""
        from repro_torch.search.study import TrialPruned

        refuse_kernel_candidate(self.name, candidate, self.batch)
        x_train = torch.as_tensor(data["x_train"], device=self.device)
        y_train = torch.as_tensor(data["y_train"], device=self.device).long()
        params = self._weights(candidate)
        momentum = {name: {k: torch.zeros_like(v) for k, v in leaves.items()}
                    for name, leaves in params.items()}
        rng = np.random.default_rng(0)
        n = x_train.shape[0]
        loss = torch.tensor(float("nan"))
        for i in range(self.steps):
            idx = torch.as_tensor(rng.integers(0, n, self.batch), device=self.device)
            leaves = {name: {k: v.detach().requires_grad_(True) for k, v in p.items()}
                      for name, p in params.items()}
            with torch.enable_grad():
                logits = self._apply(candidate, leaves, x_train[idx])
                yb = y_train[idx]
                loss = (torch.logsumexp(logits, dim=-1)
                        - torch.gather(logits, -1, yb[:, None])[:, 0]).mean()
                flat = [v for p in leaves.values() for v in p.values()]
                grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
            with torch.no_grad():
                for name, p in params.items():
                    for k, w in p.items():
                        g = next(grads)
                        m = momentum[name][k]
                        m.copy_(self.momentum * m + (torch.zeros_like(w) if g is None else g))
                        w.copy_(w - self.lr * m)
            if trial is not None and (i + 1) % self.report_every == 0:
                acc = self.accuracy(candidate, params, data["x_val"], data["y_val"])
                trial.report(i + 1, -acc)  # studies minimize by default
                if trial.should_prune():
                    raise TrialPruned()
        return params, float(loss.detach())

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        data = (context or {}).get("data")
        if data is None:
            raise ValueError("TrainedAccuracyEstimator needs context['data']")
        with measurement_gate(self.device):
            params, _ = self.fit(candidate, data, (context or {}).get("trial"))
            return self.accuracy(candidate, params, data["x_val"], data["y_val"])
