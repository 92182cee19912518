"""Zero-cost proxy estimators: tier 0 of the fidelity cascade (the JAX
package's ``evaluation/proxies.py`` on the port).

One eager pass on the candidate's layers — no
:class:`~repro_torch.hwgen.generator.TorchGenerator` — so a candidate
screened out by a proxy is never generated (``generate_call_count()``
stays where it was).  The scores follow the standard zero-cost NAS proxies
(Benmeziane et al., arXiv:2101.09336 survey; Abdelfattah et al.
"Zero-Cost Proxies for Lightweight NAS"):

  * ``synflow``   — sum over parameters of ``|θ ⊙ ∂R/∂θ|`` where ``R``
    is the summed output of the network run on an all-ones input with
    absolute-valued weights; computed with a single forward pass via
    the saliency-conservation identity (see :class:`SynFlowEstimator`),
    reported on a log scale so the score stays finite and
    JSON-serializable for arbitrarily deep candidates;
  * ``grad_norm`` — the global l2 norm of the loss gradient from one
    forward/backward on a fixed random batch.

Both are *rankings*, not costs: a quality-seeking screen runs them with
``direction: maximize``, a latency-minimizing search can invert the
screen with ``direction: minimize``.

Where the port differs from the reference:

* The proxies run on the card unless the caller asks for the CPU
  (``device=``; the Explorer passes its target's device, and a card-less
  host submitting a CUDA target's trials to remote daemons passes its own,
  so its screen draws the weights and runs on the CPU).  On CUDA each
  forward holds :func:`~repro_torch.hwgen.generator.measurement_gate`:
  the cascade screens cohorts in the parent while process workers time
  candidates on the same card, and a proxy's forward beside a timing would
  show up in that candidate's ``latency_s``.
* The weights are drawn from a ``torch.Generator`` seeded 0 by one
  overridable method, :meth:`ZeroCostProxy._weights` (the reference's
  ``candidate.init(PRNGKey(0))``; the two frameworks draw different
  numbers from one seed, so a test feeds both the same converted
  weights), and the inputs likewise by :meth:`ZeroCostProxy._input` and
  :meth:`GradNormEstimator._labels`.
* ``grad_norm`` refuses a candidate that reaches a kernel: the CUDA
  kernels are forward-only, as the reference's Pallas kernels have no
  gradient, so the reference cannot differentiate such candidates either.

Scores are deterministic and memoized in the shared
:class:`EvaluationCache` keyed by the candidate's full architecture
signature + the proxy batch size, so they ride the same flock-safe disk
tier as measured values and survive restarts.  The default batch comes
from ``REPRO_PROXY_BATCH``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.builder import BuiltModel
from repro_torch.device import resolve_device
from repro_torch.envvars import read_env
from repro_torch.evaluation.api import Estimator
from repro_torch.evaluation.cache import EvaluationCache
from repro_torch.evaluation.estimators import refuse_kernel_candidate
from repro_torch.explorer.registry import ESTIMATORS
from repro_torch.hwgen.generator import measurement_gate

# Small on purpose: a proxy exists to cost milliseconds next to a
# measured forward, and the score is a ranking — batch size barely moves
# it.  REPRO_PROXY_BATCH overrides for spaces whose first layers are
# batch-sensitive.
DEFAULT_PROXY_BATCH = 2

Weights = Dict[str, Dict[str, torch.Tensor]]


class ZeroCostProxy(Estimator):
    """Shared machinery: cache wiring, the device, the weights and the
    eager input construction.

    Subclasses implement ``_score(candidate) -> float``; ``estimate``
    memoizes it under ``(name, batch, signature)`` — JSON-able, so the
    disk tier persists proxy scores exactly like measured values.
    """

    def __init__(self, batch: Optional[int] = None,
                 cache: Optional[EvaluationCache | str] = None,
                 device="cuda"):
        if batch is None:
            batch = read_env("REPRO_PROXY_BATCH", DEFAULT_PROXY_BATCH)
        self.batch = max(1, int(batch))
        if cache is None:
            cache = EvaluationCache()
        elif not isinstance(cache, EvaluationCache):
            cache = EvaluationCache(disk=cache)
        self.cache = cache
        self.device = resolve_device(device)

    def _weights(self, candidate: BuiltModel) -> Weights:
        """Each layer's weights, ``{"layer_<i>": {leaf: tensor}}`` on this
        proxy's device, drawn from a generator seeded 0 on that device."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        return {f"layer_{i}": {k: v.to(self.device) for k, v in layer.init(gen).items()}
                for i, layer in enumerate(candidate.layers)}

    def _input(self, candidate: BuiltModel, fill: str) -> torch.Tensor:
        # mirror the measured estimators: YAML input order is (channels,
        # length), the forward wants (batch, length, channels)
        l, c = candidate.input_shape[-1], candidate.input_shape[0]
        shape = (self.batch, l, c)
        if fill == "ones":
            return torch.ones(shape, dtype=torch.float32, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(1)
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=self.device)

    @staticmethod
    def _apply_net(candidate: BuiltModel, params: Weights, x):
        # the layer stack only, WITHOUT the data-preprocessing stage:
        # proxies measure architecture saliency, and a normalizer maps
        # the synflow all-ones probe to a constant zero (zscore/minmax of
        # a constant input), which would zero every proxy score
        for i, layer in enumerate(candidate.layers):
            x = layer.apply(params[f"layer_{i}"], x)
        return x

    def _score(self, candidate: BuiltModel) -> float:
        raise NotImplementedError

    def estimate(self, candidate: BuiltModel, context=None) -> float:
        key = (self.name, self.batch, EvaluationCache.candidate_key(candidate))
        return self.cache.get_or_compute(key, lambda: float(self._score(candidate)))


@ESTIMATORS.register("synflow")
class SynFlowEstimator(ZeroCostProxy):
    """Synaptic-flow saliency (log scale) via the conservation identity.

    Synflow accumulates ``|θ ⊙ ∂R/∂θ|`` where ``R`` is the summed output
    on an all-ones input with absolute-valued weights.  Tanaka et al.
    (arXiv:2006.05467) prove layerwise saliency is *conserved*: with the
    whole network positive (abs weights, positive input, ReLU/pooling
    transparent) ``R`` is degree-1 homogeneous in each affine layer's
    weights, so every parameterized layer's saliency sum equals ``R``
    and the total is ``n_param_layers * R`` — one eager forward pass,
    no autodiff.  Bias (1-D) leaves are zeroed in the probe to keep the
    identity exact; the tests check it against ``torch.autograd``."""

    name = "synflow"

    def _probe(self, candidate: BuiltModel):
        """|θ| with bias (1-D) leaves zeroed, plus the count of layers
        that carry any parameters at all."""
        probe = {name: {k: torch.zeros_like(v) if v.dim() == 1 else v.abs()
                        for k, v in leaves.items()}
                 for name, leaves in self._weights(candidate).items()}
        n_param_layers = sum(1 for leaves in probe.values() if leaves)
        return probe, n_param_layers

    def _score(self, candidate: BuiltModel) -> float:
        # the weight draws and the forward are device work: no sibling's
        # timing may run beside them
        with measurement_gate(self.device), torch.inference_mode():
            x = self._input(candidate, "ones")
            probe, n_param_layers = self._probe(candidate)
            r = float(self._apply_net(candidate, probe, x).sum())
        total = n_param_layers * max(r, 0.0)
        # log1p: raw synflow grows multiplicatively with depth/width and
        # overflows float ranges for deep candidates; log keeps the
        # ranking and stays strict-JSON-serializable on the disk tier
        return math.log1p(total)


@ESTIMATORS.register("grad_norm")
class GradNormEstimator(ZeroCostProxy):
    """Global l2 norm of the cross-entropy gradient from one
    forward/backward on a fixed random batch with random labels."""

    name = "grad_norm"

    def _labels(self, candidate: BuiltModel) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(2)
        return torch.randint(0, max(1, candidate.output_dim), (self.batch,),
                             generator=gen, device=self.device)

    def _score(self, candidate: BuiltModel) -> float:
        # refused before anything runs: on the CPU the plain versions would
        # differentiate, but on the card the forward-only kernels would not,
        # so the score would depend on the device
        refuse_kernel_candidate(self.name, candidate, self.batch)
        with measurement_gate(self.device):
            x = self._input(candidate, "normal")
            y = self._labels(candidate)
            params = {name: {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
                      for name, leaves in self._weights(candidate).items()}
            with torch.enable_grad():
                logits = self._apply_net(candidate, params, x)
                loss = (torch.logsumexp(logits, dim=-1)
                        - logits.gather(-1, y[:, None])[:, 0]).mean()
                leaves = [v for layer in params.values() for v in layer.values()]
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            sq = sum(float((g * g).sum()) for g in grads if g is not None)
        return math.sqrt(max(sq, 0.0))
