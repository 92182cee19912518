"""``metric: modelled`` on the port against the JAX package on the CPU: the
program's operations and bytes (``hwgen.generator.program_cost``) against
XLA's cost analysis of the same candidates, the modelled latency's ranking
through both packages, and what counting leaves alone (nothing is
generated, placed or launched).  The peak a CPU target counts and the
kernels' work are in ``tests/test_torch_program_cost.py``."""
from functools import lru_cache
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from repro_torch.core import builder as tbuilder  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import translate as ttranslate  # noqa: E402
from repro_torch.evaluation import estimators as test  # noqa: E402
from repro_torch.evaluation.cache import EvaluationCache  # noqa: E402
from repro_torch.hwgen import generator as tgen  # noqa: E402
from repro_torch.hwgen.roofline import roofline_terms  # noqa: E402
from repro_torch.hwgen.targets import get_target  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.search import samplers as tsamplers  # noqa: E402
from repro_torch.search import study as tstudy  # noqa: E402

EXPERIMENTS = Path(__file__).resolve().parents[1] / "examples" / "experiments"
BATCH = 8  # hw_parallel.yaml's latency batch

# The port's FLOPs leave out elementwise work (FlopCounterMode counts
# products and convolutions), XLA's count it: measured 2-7% low on these
# candidates, held to within 10%.
FLOPS_REL = 0.10
# Bytes at the level of layers (each stage reads its input and weights
# once and writes its output once) against XLA's "bytes accessed", which
# counts every fusion's operands: measured 0.65-1.11x, held to 0.5-1.5x.
BYTES_RATIO = (0.5, 1.5)
# The modelled latency's rank correlation between the packages over these
# ten candidates on host_cpu: measured 0.770.  The chip's constants bound
# every one of them by bytes, where the layer rule and XLA's count of
# fusion operands differ by 0.65-1.11x (not one factor), so the ranking
# is not the reference's; held to at least 0.7.
MIN_SPEARMAN = 0.7


def _space(name):
    raw = yaml.safe_load((EXPERIMENTS / name).read_text())
    raw = raw.get("search_space", raw)
    if set(raw) == {"file"}:
        raw = yaml.safe_load((EXPERIMENTS / raw["file"]).read_text())
    return raw


# six seeded candidates of hw_parallel.yaml's conv_pool space, four of
# cascade.yaml's: none reaches a kernel
CASES = [("hw_parallel.yaml", i) for i in range(6)] + [("cascade.yaml", i) for i in range(4)]


@lru_cache(maxsize=None)
def _drawn(name, n):
    """The first ``n`` candidates RandomSampler(seed=0) draws, built by both
    packages: [(jax model, torch model)]."""
    from repro.core import builder as jbuilder
    from repro.core import space as jspace
    from repro.core import translate as jtranslate
    from repro.search import samplers as jsamplers
    from repro.search import study as jstudy

    out = []
    for space_mod, translate, builder, samplers, study in (
            (jspace, jtranslate, jbuilder, jsamplers, jstudy),
            (tspace, ttranslate, tbuilder, tsamplers, tstudy)):
        space = space_mod.parse_search_space(_space(name))
        b = builder.ModelBuilder(space.input_shape, space.output_dim)
        st = study.Study(sampler=samplers.RandomSampler(seed=0))
        out.append([b.build(translate.sample_architecture(space, st.ask())) for _ in range(n)])
    return list(zip(*out))


@lru_cache(maxsize=None)
def _reference(name, i):
    """XLA's flops, bytes accessed and peak bytes for candidate ``i``, read
    from the compiled program as the JAX package's ``XLAGenerator`` reads
    them (compiled here directly, so the reference's process-wide generate
    count, which its cascade tests read, does not move)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.compat import cost_analysis_dict

    jm, _ = _drawn(name, 6)[i]
    l, c = jm.input_shape[-1], jm.input_shape[0]
    compiled = jax.jit(jm.apply).lower(jm.init(jax.random.PRNGKey(0)),
                                       jnp.zeros((BATCH, l, c), jnp.float32)).compile()
    cost = cost_analysis_dict(compiled)
    ma = compiled.memory_analysis()
    peak = (ma.argument_size_in_bytes + ma.output_size_in_bytes + ma.temp_size_in_bytes
            - ma.alias_size_in_bytes)
    return float(cost.get("flops", 0.0)), float(cost.get("bytes accessed", 0.0)), peak


def _cost(tm, batch=BATCH, schedules=None):
    l, c = tm.input_shape[-1], tm.input_shape[0]
    return tgen.program_cost(tm, (torch.empty(batch, l, c, device="meta"),),
                             schedules=schedules)


@pytest.mark.parametrize("name, i", CASES)
def test_flops_within_10_percent_of_xla(name, i):
    jm, tm = _drawn(name, 6)[i]
    assert jm.arch.signature() == tm.arch.signature()
    want, _, _ = _reference(name, i)
    cost = _cost(tm)
    assert cost.kernel_calls == [] and cost.collective_bytes == 0.0
    assert abs(cost.flops / want - 1) <= FLOPS_REL, (cost.flops, want)


@pytest.mark.parametrize("name, i", CASES)
def test_bytes_within_half_and_one_and_a_half_of_xla(name, i):
    _, tm = _drawn(name, 6)[i]
    _, want, _ = _reference(name, i)
    ratio = _cost(tm).bytes_accessed / want
    assert BYTES_RATIO[0] <= ratio <= BYTES_RATIO[1], ratio


def test_modelled_latency_ranks_the_candidates_as_jax_does():
    """``latency_s`` at ``metric: modelled`` on host_cpu through both
    packages over the ten candidates (the reference's value is its
    estimator's: ``roofline_terms`` of XLA's counts against the host_cpu
    chip, no collectives on one device): the rank correlation is stated
    and printed on failure."""
    pytest.importorskip("jax")
    from repro.hwgen.roofline import roofline_terms as jroofline
    from repro.hwgen.targets import get_target as jtarget
    from repro_torch.explorer.explorer import _spearman

    tlat = test.CompiledLatencyEstimator("host_cpu", batch=BATCH, metric="modelled")
    want, got = [], []
    for name, i in CASES:
        flops, nbytes, _ = _reference(name, i)
        want.append(jroofline(hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=0.0,
                              n_chips=1, chip=jtarget("host_cpu").chip).bound_s)
        got.append(tlat.estimate(_drawn(name, 6)[i][1]))
    rho = _spearman(got, want)
    assert rho is not None and rho >= MIN_SPEARMAN, (
        f"Spearman of modelled latency, port against JAX: {rho} "
        f"(port {got}, JAX {want})")


def test_modelled_latency_is_the_roofline_of_the_count_and_runs_nothing():
    """The value is ``roofline_terms`` of the program's count against the
    target's chip (``h100`` here, on a machine without a card: nothing is
    placed); the chip-independent terms are cached under
    ``roofline_terms`` and a second estimate reads them."""
    _, tm = _drawn("hw_parallel.yaml", 6)[0]
    cache = EvaluationCache()
    est = test.CompiledLatencyEstimator("h100", batch=BATCH, metric="modelled", cache=cache)
    generated, launches = tgen.generate_call_count(), dict(ops.LAUNCHES)
    value = est.estimate(tm)
    cost = _cost(tm)
    want = roofline_terms(hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
                          collective_bytes=0.0, n_chips=1, chip=get_target("h100").chip)
    assert value == want.bound_s and want.dominant in ("compute", "memory")
    assert est.estimate(tm) == value
    assert cache.stats.misses == 1 and cache.stats.hits == 1
    key = est._program_key("roofline_terms", tm)
    assert cache.get_or_compute(key, lambda: None) == [cost.flops, cost.bytes_accessed, 0.0]
    assert tgen.generate_call_count() == generated and dict(ops.LAUNCHES) == launches
    assert all(p.is_meta for p in tm.parameters())  # weights never drawn
