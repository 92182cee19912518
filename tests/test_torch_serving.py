"""The port's traffic-shaped serving estimators
(``repro_torch.evaluation.serving``) and the ``serving:`` section against
the JAX package's on the CPU: ``ServingSpec`` validation message for
message, the analytic decode step, all five estimators and
``serving.yaml``'s ranking with the reference's XLA terms injected, the
same without injection (the port's own counts), backend determinism, and
one count serving both modelled latency and prefill."""
import functools
from functools import lru_cache
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from repro_torch.core import builder as tbuilder  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import translate as ttranslate  # noqa: E402
from repro_torch.evaluation import estimators as test  # noqa: E402
from repro_torch.evaluation import serving as tserving  # noqa: E402
from repro_torch.evaluation.cache import EvaluationCache  # noqa: E402
from repro_torch.explorer.experiment import ExperimentSpec, ServingSpec  # noqa: E402
from repro_torch.explorer.explorer import Explorer, _spearman  # noqa: E402
from repro_torch.search import samplers as tsamplers  # noqa: E402
from repro_torch.search import study as tstudy  # noqa: E402

EXPERIMENTS = Path(__file__).resolve().parents[1] / "examples" / "experiments"
SERVING_YAML = EXPERIMENTS / "serving.yaml"
ESTIMATORS = {"prefill_latency_s": "PrefillLatencyEstimator",
              "decode_latency_s": "DecodeLatencyEstimator",
              "kv_cache_peak_bytes": "KVCachePeakBytesEstimator",
              "throughput_tok_s": "ThroughputEstimator",
              "p99_latency_s": "P99LatencyEstimator"}
# the reference test's serving section (tests/test_parity_matrix.py)
CANONICAL_SERVING = {
    "max_batch": 2,
    "queue_limit": 4,
    "traffic": {"seed": 5, "n_requests": 12, "arrival": "poisson",
                "rate_rps": 100.0, "prompt_lens": [4, 8], "gen_lens": [2, 4]},
}
# serving.yaml's 8 candidates without injection, the port's own counts
# against the reference's values: the same best trial (#6), and a
# Spearman of p99_latency_s of 1.0, each p99 within 0.32% of the
# reference's.  The requests' decode steps, analytic and the same in both
# packages, outweigh the prefills, whose bytes-bound bound differs with
# the count (tests/test_torch_modelled.py: bytes 0.65-1.11x XLA's).  Held
# to at least 0.9
MIN_P99_SPEARMAN = 0.9


def _raw(tmp_path, trials=8, **overrides):
    raw = yaml.safe_load(SERVING_YAML.read_text())
    raw["search_space"] = yaml.safe_load((EXPERIMENTS / raw["search_space"]["file"])
                                         .read_text())
    raw.pop("cache")  # memory only: injected values must not reach a store
    raw.update(budget={"n_trials": trials}, report_dir=str(tmp_path), **overrides)
    return raw


@lru_cache(maxsize=None)
def _candidates():
    """serving.yaml's 8 candidates (RandomSampler(seed=7) over conv_pool),
    built by both packages: [(jax model, torch model)]."""
    from repro.core import builder as jbuilder
    from repro.core import space as jspace
    from repro.core import translate as jtranslate
    from repro.search import samplers as jsamplers
    from repro.search import study as jstudy

    raw = _raw(Path("."))
    out = []
    for space_mod, translate, builder, samplers, study in (
            (jspace, jtranslate, jbuilder, jsamplers, jstudy),
            (tspace, ttranslate, tbuilder, tsamplers, tstudy)):
        space = space_mod.parse_search_space(dict(raw["search_space"]))
        b = builder.ModelBuilder(space.input_shape, space.output_dim)
        st = study.Study(sampler=samplers.RandomSampler(seed=7))
        out.append([b.build(translate.sample_architecture(space, st.ask())) for _ in range(8)])
    return list(zip(*out))


@lru_cache(maxsize=None)
def _xla_terms(i):
    """XLA's [flops, bytes accessed, collective bytes] of candidate ``i``'s
    forward at (max_batch, L, C), read from the compiled program as the
    reference's generator reads them (compiled here with ``jax.jit``, so the
    reference's process-wide compile count, which its cascade tests read,
    does not move; one device, no collectives)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.compat import cost_analysis_dict

    jm, _ = _candidates()[i]
    l, c = jm.input_shape[-1], jm.input_shape[0]
    batch = _raw(Path("."))["serving"]["max_batch"]
    compiled = jax.jit(jm.apply).lower(jm.init(jax.random.PRNGKey(0)),
                                       jnp.zeros((batch, l, c), jnp.float32)).compile()
    cost = cost_analysis_dict(compiled)
    return [float(cost.get("flops", 0.0)), float(cost.get("bytes accessed", 0.0)), 0.0]


def _injected(cls):
    """Patch ``cls._forward_terms`` to give XLA's terms, by signature."""
    terms = {tm.arch.signature(): _xla_terms(i) for i, (_, tm) in enumerate(_candidates())}
    return mock.patch.object(cls, "_forward_terms",
                             lambda self, candidate, plan: list(
                                 terms[candidate.arch.signature()]))


def _values(serving_module, model):
    """The five estimators of ``serving_module`` (either package's) on
    ``model`` under serving.yaml's section, on host_cpu."""
    serving = _raw(Path("."))["serving"]
    return {name: getattr(serving_module, cls)("host_cpu", serving=serving).estimate(model)
            for name, cls in ESTIMATORS.items()}


@pytest.mark.parametrize("raw", [
    CANONICAL_SERVING, None, {"max_batch": 0}, {"queue_limit": 0}, {"dtype_bytes": 3},
    {"traffic": {"arrival": "flood"}}, {"burst": 1}, "fast"],
    ids=["canonical", "none", "max_batch", "queue_limit", "dtype_bytes", "arrival",
         "unknown-key", "not-a-mapping"])
def test_serving_spec_validation_matches_jax(raw):
    """The same spec, or the same error class name and message."""
    pytest.importorskip("jax")
    from repro.explorer.experiment import ServingSpec as JServingSpec

    def parse(cls):
        try:
            spec = cls.from_raw(raw)
        except Exception as e:  # noqa: BLE001 - the error itself is compared
            return type(e).__name__, str(e)
        return None if spec is None else spec.to_dict()

    assert parse(ServingSpec) == parse(JServingSpec)
    if raw is CANONICAL_SERVING:
        spec = ServingSpec.from_raw(dict(CANONICAL_SERVING))
        assert spec.max_batch == 2 and spec.queue_limit == 4 and spec.traffic.seed == 5


def test_decode_latency_matches_jax_on_serving_yaml():
    """The analytic decode step on serving.yaml's 8 candidates, within
    1e-12 relative (it reads only ``ModelBuilder``'s analytic counts)."""
    pytest.importorskip("jax")
    from repro.evaluation import serving as jserving

    serving = _raw(Path("."))["serving"]
    for jm, tm in _candidates():
        want = jserving.DecodeLatencyEstimator("host_cpu", serving=serving).estimate(jm)
        got = tserving.DecodeLatencyEstimator("host_cpu", serving=serving).estimate(tm)
        assert abs(got - want) <= 1e-12 * want, (tm.arch.signature(), got, want)


def test_injected_xla_terms_give_the_reference_values():
    """With XLA's terms in place of the port's count, all five estimators
    equal the reference's (given the same terms) to 1e-9 relative."""
    pytest.importorskip("jax")
    from repro.evaluation import serving as jserving

    with _injected(tserving._ServingEstimator), _injected(jserving._ServingEstimator):
        for jm, tm in _candidates():
            want, got = _values(jserving, jm), _values(tserving, tm)
            for name in ESTIMATORS:
                assert abs(got[name] - want[name]) <= 1e-9 * abs(want[name]), (name, got, want)


def _trials(study):
    return [(t.number, t.state.value, t.values, t.user_attrs.get("signature"))
            for t in study.trials]


def test_injected_xla_terms_rank_serving_yaml_as_jax(tmp_path):
    """serving.yaml through both facades with XLA's terms injected in both:
    the same trials with the same values, so the same ranking and best
    trial."""
    pytest.importorskip("jax")
    from repro.evaluation import serving as jserving
    from repro.explorer.explorer import Explorer as JExplorer

    raw = _raw(tmp_path)
    with _injected(tserving._ServingEstimator), _injected(jserving._ServingEstimator):
        jx = JExplorer.from_dict(raw)
        jreport = jx.run(save_report=False)
        tx = Explorer.from_dict(raw, device="cpu")
        treport = tx.run(save_report=False)
    for (tn, ts, tv, tsig), (jn, js, jv, jsig) in zip(_trials(tx.study), _trials(jx.study)):
        assert (tn, ts, tsig) == (jn, js, jsig)
        assert abs(tv[0] - jv[0]) <= 1e-9 * abs(jv[0])
    order = sorted(range(8), key=lambda n: tx.study.trials[n].values[0])
    assert order == sorted(range(8), key=lambda n: jx.study.trials[n].values[0])
    assert treport.best["number"] == jreport.best["number"] == 6
    assert treport.best["signature"] == jreport.best["signature"]


def test_own_counts_find_the_reference_best_and_p99_order(tmp_path):
    """Without injection: serving.yaml's best trial through the port is the
    reference's (#6), and its p99_latency_s ranks the 8 candidates with a
    Spearman of at least ``MIN_P99_SPEARMAN`` against the reference's."""
    pytest.importorskip("jax")
    from repro.evaluation import serving as jserving

    report = Explorer.from_dict(_raw(tmp_path), device="cpu").run(save_report=False)
    assert report.best["number"] == 6
    serving = _raw(Path("."))["serving"]
    got = [tserving.P99LatencyEstimator("host_cpu", serving=serving).estimate(tm)
           for _, tm in _candidates()]
    with _injected(jserving._ServingEstimator):
        want = [jserving.P99LatencyEstimator("host_cpu", serving=serving).estimate(jm)
                for jm, _ in _candidates()]
    rho = _spearman(got, want)
    assert rho is not None and rho >= MIN_P99_SPEARMAN, (
        f"Spearman of p99_latency_s, port against JAX: {rho} (port {got}, JAX {want})")
    assert min(range(8), key=got.__getitem__) == min(range(8), key=want.__getitem__) == 6


def test_serial_and_process_backends_give_the_same_values(tmp_path):
    """The modelled serving criteria are pure functions of the candidate and
    the spec: the same best trial, parameters, values and criteria on the
    serial backend, on 2 spawned process workers, and on a repeat."""
    def run(backend, sub):
        raw = _raw(tmp_path / sub, trials=6, executor={"backend": backend, "n_workers": 2},
                   cache={"dir": str(tmp_path / sub / "cache")})
        report = Explorer.from_dict(raw, device="cpu").run(save_report=False)
        return (report.best["number"], report.best["params"], report.best["values"],
                report.criteria_values)

    serial = run("serial", "serial")
    assert run("process", "process") == serial
    assert run("serial", "again") == serial


def test_one_count_serves_modelled_latency_and_prefill():
    """``latency_s`` at ``metric: modelled`` and ``batch: max_batch`` and
    ``prefill_latency_s`` read one cache entry: one forward counted on
    ``meta``, the same bound; the simulation adds no count."""
    _, model = _candidates()[0]
    serving = _raw(Path("."))["serving"]
    cache = EvaluationCache()
    counted = []
    count = test.program_cost

    def counting(*args, **kwargs):
        counted.append(1)
        return count(*args, **kwargs)

    with mock.patch.object(test, "program_cost", counting):
        latency = test.CompiledLatencyEstimator(
            "host_cpu", batch=serving["max_batch"], cache=cache,
            metric="modelled").estimate(model)
        prefill = tserving.PrefillLatencyEstimator("host_cpu", serving=serving,
                                                   cache=cache).estimate(model)
        p99 = tserving.P99LatencyEstimator("host_cpu", serving=serving,
                                           cache=cache).estimate(model)
    assert counted == [1] and prefill == latency and p99 > 0
    assert all(p.is_meta for p in model.parameters())  # nothing was placed


def test_the_section_round_trips_and_reaches_the_estimators(tmp_path):
    """``serving:`` parses as in the reference, round-trips through
    ``to_dict``, and the Explorer injects it: the estimators see
    serving.yaml's max_batch, not the default."""
    pytest.importorskip("jax")
    from repro.explorer.experiment import ExperimentSpec as JSpec

    raw = _raw(tmp_path)
    spec = ExperimentSpec.from_dict(raw)
    assert spec.to_dict() == JSpec.from_dict(raw).to_dict()
    assert ExperimentSpec.from_dict(spec.to_dict()).to_dict() == spec.to_dict()
    seen = []
    init = tserving._ServingEstimator.__init__

    @functools.wraps(init)  # the Explorer injects by the constructor's signature
    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.append(self.serving.max_batch)

    with mock.patch.object(tserving._ServingEstimator, "__init__", recording):
        Explorer.from_dict(dict(raw, budget={"n_trials": 1}), device="cpu").run(
            save_report=False)
    assert seen and set(seen) == {raw["serving"]["max_batch"]} != {8}
