"""The port's zero-cost proxies on the CPU, case for case with the JAX
package's proxy tests in ``tests/test_cascade.py``, and against the
reference on its own (converted) weights and inputs: ``synflow`` and
``grad_norm`` equal, the conservation identity against ``torch.autograd``,
the disk tier, no generate, and ``grad_norm``'s refusal of a candidate
that reaches a forward-only kernel."""
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from repro_torch.core.builder import ModelBuilder  # noqa: E402
from repro_torch.core.space import parse_search_space  # noqa: E402
from repro_torch.core.translate import sample_architecture  # noqa: E402
from repro_torch.evaluation.cache import EvaluationCache  # noqa: E402
from repro_torch.evaluation.proxies import GradNormEstimator, SynFlowEstimator  # noqa: E402
from repro_torch.explorer.registry import ESTIMATORS  # noqa: E402
from repro_torch.hwgen.generator import generate_call_count  # noqa: E402

EXPERIMENTS = Path(__file__).resolve().parents[1] / "examples" / "experiments"
# the proxies against the reference's on the same (converted) weights and
# inputs: fp32 sums in another order
PROXY_REL = 1e-5

# the canonical tiny space of tests/test_parity_matrix.py (which imports
# the JAX package at module level, so it is copied, not imported)
TINY_SPACE = {
    "input": [2, 64],
    "output": 3,
    "sequence": [
        {"block": "features", "op_candidates": "conv1d",
         "conv1d": {"kernel_size": [3, 5], "out_channels": [4, 8]}},
        {"block": "head", "op_candidates": "linear",
         "linear": {"width": [8, 16]}},
    ],
}


def build_tiny_models(n=4, seed=0, space=TINY_SPACE):
    from repro_torch.search.samplers import RandomSampler
    from repro_torch.search.study import Study

    space = parse_search_space(dict(space))
    builder = ModelBuilder(space.input_shape, space.output_dim)
    study = Study(sampler=RandomSampler(seed=seed))
    return [builder.build(sample_architecture(space, study.ask())) for _ in range(n)]


# ---------------------------------------------------------------------------
# zero-cost proxies
# ---------------------------------------------------------------------------

def test_proxies_registered_as_estimators():
    assert ESTIMATORS.get("synflow") is SynFlowEstimator
    assert ESTIMATORS.get("grad_norm") is GradNormEstimator


def test_proxies_run_on_the_card_unless_asked_for_the_cpu():
    from repro_torch.device import NoCudaCardError

    if torch.cuda.is_available():
        assert SynFlowEstimator().device.type == "cuda"
    else:
        with pytest.raises(NoCudaCardError):
            SynFlowEstimator()
    assert GradNormEstimator(device="cpu").device.type == "cpu"


def test_proxies_deterministic_and_capacity_ordered():
    models = build_tiny_models(4, seed=3)
    syn, gn = SynFlowEstimator(device="cpu"), GradNormEstimator(device="cpu")
    for m in models:
        assert syn.estimate(m) == SynFlowEstimator(device="cpu").estimate(m)
        assert gn.estimate(m) == GradNormEstimator(device="cpu").estimate(m)
        assert math.isfinite(syn.estimate(m)) and syn.estimate(m) > 0.0


def test_proxies_never_touch_the_generator(monkeypatch):
    from repro_torch.hwgen.generator import TorchGenerator

    def refuse(*a, **k):
        raise AssertionError("a proxy generated a candidate")

    monkeypatch.setattr(TorchGenerator, "generate", refuse)
    models = build_tiny_models(2)
    before = generate_call_count()
    for m in models:
        SynFlowEstimator(device="cpu").estimate(m)
        GradNormEstimator(device="cpu").estimate(m)
    assert generate_call_count() == before
    assert all(p.is_meta for m in models for p in m.parameters())  # weights drawn apart


def test_synflow_conservation_identity_matches_autograd():
    """The one-forward fast path equals the classical |θ ⊙ ∂R/∂θ|
    backward-pass formulation on the same probe."""
    for m in build_tiny_models(3, seed=5):
        syn = SynFlowEstimator(device="cpu")
        probe, _ = syn._probe(m)
        probe = {name: {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
                 for name, leaves in probe.items()}
        x = torch.ones((syn.batch, m.input_shape[-1], m.input_shape[0]))
        saliency = SynFlowEstimator._apply_net(m, probe, x).sum()
        leaves = [v for layer in probe.values() for v in layer.values()]
        grads = torch.autograd.grad(saliency, leaves, allow_unused=True)
        total = sum(float((g * p).abs().sum().detach()) for g, p in zip(grads, leaves)
                    if g is not None)
        assert syn._score(m) == pytest.approx(math.log1p(total), rel=1e-5)


def test_proxy_scores_ride_the_disk_cache(tmp_path):
    model = build_tiny_models(1)[0]
    store = str(tmp_path / "cache")
    first = SynFlowEstimator(cache=EvaluationCache(disk=store), device="cpu")
    score = first.estimate(model)

    class Broken(SynFlowEstimator):
        def _score(self, candidate):
            raise AssertionError("disk tier missed: proxy recomputed")

    second = Broken(cache=EvaluationCache(disk=store), device="cpu")
    assert second.estimate(model) == score


def test_proxy_batch_env_knob(monkeypatch):
    monkeypatch.setenv("REPRO_PROXY_BATCH", "5")
    assert SynFlowEstimator(device="cpu").batch == 5
    monkeypatch.delenv("REPRO_PROXY_BATCH")
    assert SynFlowEstimator(batch=3, device="cpu").batch == 3


# -- against the reference, on its weights and inputs ---------------------------

def _jax_twin(candidate):
    """The JAX package's build of the port candidate's architecture."""
    from repro.core.builder import ModelBuilder as JBuilder
    from repro.core.translate import ArchitectureIR, LayerIR

    arch = ArchitectureIR(layers=[LayerIR(l.op, dict(l.params), l.path)
                                  for l in candidate.arch.layers],
                          preprocessing=[dict(p) for p in candidate.arch.preprocessing])
    jm = JBuilder(candidate.input_shape, candidate.output_dim).build(arch)
    assert jm.arch.signature() == candidate.arch.signature()
    return jm


def _jax_weights(candidate):
    """The reference proxy's weights (``init(PRNGKey(0))`` of the JAX
    build), converted onto the port's layout, as ``_weights`` returns them."""
    import jax
    from repro_torch.convert import candidate_from_jax

    jm = _jax_twin(candidate)
    twin = ModelBuilder(candidate.input_shape, candidate.output_dim).build(candidate.arch)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    twin = candidate_from_jax(twin, params, device="cpu")
    return {f"layer_{i}": dict(getattr(twin, f"layer_{i}").items())
            for i in range(len(candidate.layers))}


class JaxWeightsSynFlow(SynFlowEstimator):
    def _weights(self, candidate):
        return _jax_weights(candidate)


class JaxInputsGradNorm(GradNormEstimator):
    """The reference's weights, normal batch (PRNGKey(1)) and labels
    (PRNGKey(2))."""

    def _weights(self, candidate):
        return _jax_weights(candidate)

    def _input(self, candidate, fill):
        import jax

        shape = (self.batch, candidate.input_shape[-1], candidate.input_shape[0])
        return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), shape)))

    def _labels(self, candidate):
        import jax

        return torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(2), (self.batch,), 0, max(1, candidate.output_dim)))).long()


@pytest.mark.parametrize("proxy", ["synflow", "grad_norm"])
@pytest.mark.parametrize("index", range(4))
def test_proxies_equal_the_reference_on_converted_weights(proxy, index):
    pytest.importorskip("jax")
    from repro.evaluation.proxies import GradNormEstimator as JGradNorm
    from repro.evaluation.proxies import SynFlowEstimator as JSynFlow

    model = build_tiny_models(4, seed=3)[index]
    ours, theirs = {"synflow": (JaxWeightsSynFlow, JSynFlow),
                    "grad_norm": (JaxInputsGradNorm, JGradNorm)}[proxy]
    want = theirs().estimate(_jax_twin(model))
    got = ours(device="cpu").estimate(model)
    assert got == pytest.approx(want, rel=PROXY_REL)


def _kernel_candidate(weights):
    """An ``ssm`` candidate on ``impl: pallas`` (kernel_tuning.yaml's space):
    its weights as built (``meta``) or drawn on the CPU."""
    raw = yaml.safe_load((EXPERIMENTS / "kernel_tuning.yaml").read_text())["search_space"]
    model = build_tiny_models(1, space=raw)[0]
    if weights == "cpu":
        model.init(torch.Generator().manual_seed(0), "cpu")
    return model


@pytest.mark.parametrize("weights", ["meta", "cpu"])
def test_grad_norm_refuses_a_kernel_candidate_before_any_forward(weights, monkeypatch):
    """The CUDA kernels are forward-only, as the reference's Pallas kernels
    are, so grad_norm refuses a candidate that reaches one, whatever device
    it runs on: found by a forward on ``meta``, before the weights are
    drawn or any forward runs."""
    from repro_torch.kernels import ref

    model = _kernel_candidate(weights)

    def never(*a, **k):
        raise AssertionError("ran before the refusal")

    monkeypatch.setattr(ref, "ssm_scan_ref", never)
    monkeypatch.setattr(GradNormEstimator, "_weights", never)
    with pytest.raises(NotImplementedError, match="forward-only") as e:
        GradNormEstimator(device="cpu").estimate(model)
    assert "ssm_scan" in str(e.value)


def test_synflow_takes_a_kernel_candidate():
    """synflow needs no gradient: on the CPU its forward runs the kernel's
    plain version (on the card, the kernel)."""
    score = SynFlowEstimator(device="cpu").estimate(_kernel_candidate("meta"))
    assert math.isfinite(score) and score > 0.0
