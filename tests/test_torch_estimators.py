"""The port's hardware-in-the-loop estimators, without JAX: artifacts stay
on the host between runs, and a candidate's peak memory is its own,
whatever was evaluated before it."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.builder import ModelBuilder  # noqa: E402
from repro_torch.core.translate import ArchitectureIR, LayerIR  # noqa: E402
from repro_torch.device import NoCudaCardError  # noqa: E402
from repro_torch.evaluation import estimators  # noqa: E402
from repro_torch.evaluation.cache import EvaluationCache  # noqa: E402

INPUT = (16, 64)  # [channels, length]


def _candidate(*ops):
    """A candidate of the given mixer layers, then a pool and a head."""
    layers = [LayerIR(op, params, f"mixer/{i}") for i, (op, params) in enumerate(ops)]
    layers += [LayerIR("global_avg_pool", {}, "pool/0"),
               LayerIR("linear", {"width": 8}, "head/0")]
    return ModelBuilder(INPUT, 4).build(ArchitectureIR(layers))


SSM = ("ssm", {"impl": "pallas", "d_state": 16, "d_head": 8, "expand": 2})
ATTENTION = ("attention", {"impl": "pallas", "heads": 2})


def test_artifact_is_kept_on_the_host():
    """On the CPU target the forward runs and the artifact the cache keeps
    holds the candidate's weights and its zero batch on the host."""
    cache = EvaluationCache()
    latency = estimators.CompiledLatencyEstimator(
        "host_cpu", batch=2, cache=cache,
        manager=estimators.HardwareManager(warmup=1, iters=1))
    model = _candidate(SSM)
    assert latency.estimate(model) > 0
    artifact = latency._artifact(model)
    assert artifact.fn is model and artifact.memory == {}
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert artifact.example_args[0].shape == (2, INPUT[1], INPUT[0])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_cuda_target_without_a_card_raises():
    """An h100 estimator never runs the candidate on the CPU in its place."""
    with pytest.raises(NoCudaCardError):
        estimators.CompiledLatencyEstimator("h100").estimate(_candidate(SSM))


@pytest.mark.cuda
def test_peak_bytes_is_the_candidates_own_in_either_order():
    """Two candidates measured in both orders, each study with its own
    cache: each gets the same peak, at least its weights and input, and
    the cached artifacts leave nothing on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    small, large = _candidate(SSM), _candidate(SSM, ATTENTION, SSM)
    # a first forward makes the libraries' workspaces, which stay on the card
    estimators.CompiledMemoryEstimator("h100", batch=2).estimate(large)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    peaks = []
    for order in ((small, large), (large, small)):
        memory = estimators.CompiledMemoryEstimator("h100", batch=2,
                                                    cache=EvaluationCache())
        peaks.append({id(m): memory.estimate(m) for m in order})
        assert torch.cuda.memory_allocated() == held
    assert peaks[0] == peaks[1]
    x_bytes = 2 * INPUT[0] * INPUT[1] * 4
    for m in (small, large):
        weights = sum(p.numel() * p.element_size() for p in m.parameters())
        assert peaks[0][id(m)] >= weights + x_bytes
    assert peaks[0][id(large)] > peaks[0][id(small)]
