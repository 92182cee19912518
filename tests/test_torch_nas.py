"""The port's NAS loop against the JAX package's, on the same numpy inputs
and the same (converted) weights: the 1-D conv and pool primitives, the
pre-processing stages, the Mamba2 block, every candidate a seeded sampler
draws from the repo's example spaces, the quickstart study, and the
hardware-in-the-loop estimators on the host's CPU."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from repro.core import builder as jbuilder  # noqa: E402
from repro.core import preprocess as jpre  # noqa: E402
from repro.core import space as jspace  # noqa: E402
from repro.core import translate as jtranslate  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro.search import samplers as jsamplers  # noqa: E402
from repro.search import study as jstudy  # noqa: E402
from repro_torch.convert import candidate_from_jax  # noqa: E402
from repro_torch.core import builder as tbuilder  # noqa: E402
from repro_torch.core import preprocess as tpre  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import translate as ttranslate  # noqa: E402
from repro_torch.evaluation import api as tapi  # noqa: E402
from repro_torch.evaluation import estimators as test  # noqa: E402
from repro_torch.evaluation.cache import EvaluationCache  # noqa: E402
from repro_torch.nn import conv as tconv  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.search import samplers as tsamplers  # noqa: E402
from repro_torch.search import study as tstudy  # noqa: E402

EXPERIMENTS = Path(__file__).resolve().parents[1] / "examples" / "experiments"
ATOL = 3e-5  # fp32, sums in another order


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _space(name):
    raw = yaml.safe_load((EXPERIMENTS / name).read_text())
    return raw.get("search_space", raw)


# -- primitives -------------------------------------------------------------------

@pytest.mark.parametrize("length, k, stride, padding", [
    (16, 3, 1, "SAME"), (16, 4, 2, "SAME"), (15, 5, 2, "SAME"),
    (16, 3, 1, "VALID"), (17, 3, 2, "VALID"),
])
def test_conv1d(length, k, stride, padding):
    jp, _ = split(jconv.conv1d_init(jax.random.PRNGKey(0), 3, 5, k))
    x = _rand(1, 2, length, 3)
    want = jconv.conv1d_apply(jp, jnp.asarray(x), stride=stride, padding=padding)
    tp = {"w": torch.from_numpy(np.asarray(jp["w"]).transpose(2, 1, 0).copy()),
          "b": torch.from_numpy(np.array(jp["b"]))}
    got = tconv.conv1d_apply(tp, torch.from_numpy(x), stride=stride, padding=padding)
    assert got.shape[1] == jconv.conv1d_out_len(length, k, stride, padding) \
        == tconv.conv1d_out_len(length, k, stride, padding)
    _close(got, want)


@pytest.mark.parametrize("pool", ["maxpool1d", "avgpool1d"])
@pytest.mark.parametrize("window, stride", [(2, None), (3, 1), (3, 2)])
def test_pools_valid(pool, window, stride):
    x = _rand(2, 2, 11, 4)
    want = getattr(jconv, pool)(jnp.asarray(x), window=window, stride=stride)
    got = getattr(tconv, pool)(torch.from_numpy(x), window=window, stride=stride)
    assert got.shape[1] == tconv.pool_out_len(11, window, stride)
    _close(got, want)


@pytest.mark.parametrize("stage", [
    {"stage": "filter", "taps": 15, "cutoff": 0.2, "kind": "lowpass"},
    {"stage": "filter", "taps": 8, "cutoff": 0.1, "kind": "highpass"},
    {"stage": "downsample", "factor": 3},
    {"stage": "window", "size": 20, "offset": 7},
    {"stage": "event_window", "size": 16, "energy_window": 5},
    {"stage": "normalize", "kind": "zscore"},
    {"stage": "normalize", "kind": "minmax"},
    {"stage": "normalize", "kind": "none"},
], ids=lambda s: "-".join(str(v) for v in s.values()))
def test_preprocessing_stage(stage):
    x = _rand(3, 3, 40, 2)
    x[1, 25:30] *= 8.0  # an event off-centre
    jfn, jshape = jpre.build_stage(stage, (40, 2))
    tfn, tshape = tpre.build_stage(stage, (40, 2))
    assert jshape == tshape
    _close(tfn(torch.from_numpy(x)), jfn(jnp.asarray(x)), atol=1e-5)


@pytest.mark.parametrize("impl, length, chunk", [("xla", 32, 8), ("xla", 200, 128),
                                                 ("pallas", 64, 16)])
def test_mamba2_apply(impl, length, chunk):
    """chunk 128 at L=200 exercises the decrement (100)."""
    kw = dict(d_model=16, d_state=8, d_head=8, n_groups=2, chunk=chunk, impl=impl)
    jcfg, tcfg = jssm.Mamba2Config(**kw), tssm.Mamba2Config(**kw)
    jp = {k: np.asarray(v) for k, v in split(jssm.mamba2_init(jcfg, jax.random.PRNGKey(0)))[0].items()}
    jp["dt_bias"] = _rand(4, tcfg.n_heads)  # exercise the softplus bias
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in tssm.mamba2_init(tcfg).items()}
    x = _rand(5, 2, length, 16)
    want = jax.jit(jssm.mamba2_apply, static_argnums=1)(
        {k: jnp.asarray(v) for k, v in jp.items()}, jcfg, jnp.asarray(x))
    _close(tssm.mamba2_apply(tp, tcfg, torch.from_numpy(x)), want, atol=1e-4)


def test_mamba2_init_decays_are_the_reference_ones():
    cfg = tssm.Mamba2Config(d_model=32, d_head=8)
    tp = tssm.mamba2_init(cfg, torch.Generator().manual_seed(0))
    jp, _ = split(jssm.mamba2_init(jssm.Mamba2Config(d_model=32, d_head=8),
                                   jax.random.PRNGKey(0)))
    for leaf in ("A_log", "D", "dt_bias", "conv_b", "norm_scale"):
        _close(tp[leaf], jp[leaf], atol=1e-6)


# -- candidates -------------------------------------------------------------------

# an attention/ssm space at a Pallas-block multiple (L=128; ROADMAP Queue 3
# has the reference's non-causal padding fault at other lengths)
MIXER_SPACE = {
    "input": [16, 128], "output": 3,
    "sequence": [
        {"block": "mixer", "op_candidates": ["ssm", "attention", "layernorm"],
         "type_repeat": {"type": "vary_all", "depth": [1, 2]},
         "ssm": {"impl": ["pallas", "xla"], "d_state": [8], "d_head": [8]},
         "attention": {"impl": ["pallas", "xla"], "heads": [2, 4]}},
        {"block": "pool", "op_candidates": ["global_avg_pool", "identity"]},
        {"block": "head", "op_candidates": "linear",
         "linear": {"width": [8], "activation": ["relu", "gelu"]}},
    ],
    "preprocessing": {"filter": {"taps": [9]}, "downsample": {"factor": [1, 2]}},
}
SPACES = {"quickstart": lambda: _space("quickstart.yaml"),
          "conv_pool": lambda: _space("spaces/conv_pool.yaml"),
          "kernel_tuning": lambda: _space("kernel_tuning.yaml"),
          "mixer": lambda: MIXER_SPACE}
N_DRAWN = 4


def _metadata(model):
    return [(l.name, l.out_shape, l.out_format, l.flops, l.n_params,
             l.state_elems_per_token, l.state_elems_fixed) for l in model.layers]


def _drawn(raw, n):
    """The first ``n`` architectures RandomSampler(seed=0) draws, through
    each package's translator."""
    out = {}
    for pkg, space_mod, translate, samplers, study in (
            ("jax", jspace, jtranslate, jsamplers, jstudy),
            ("torch", tspace, ttranslate, tsamplers, tstudy)):
        space, archs = space_mod.parse_search_space(raw), []
        study.Study(name="draw", sampler=samplers.RandomSampler(seed=0)).optimize(
            lambda t: archs.append(translate.sample_architecture(space, t)) or 0.0, n)
        out[pkg] = (space, archs)
    return out


@pytest.mark.parametrize("name", sorted(SPACES))
def test_sampled_candidates_match_jax(name):
    """Same signatures and builder metadata; logits of the same weights
    and inputs to 1e-4 (fp32, several layers deep)."""
    drawn = _drawn(SPACES[name](), N_DRAWN)
    jspace_, jarchs = drawn["jax"]
    tspace_, tarchs = drawn["torch"]
    jb = jbuilder.ModelBuilder(jspace_.input_shape, jspace_.output_dim)
    tb = tbuilder.ModelBuilder(tspace_.input_shape, tspace_.output_dim)
    c, l = jspace_.input_shape
    x = _rand(9, 2, l, c)
    for i, (ja, ta) in enumerate(zip(jarchs, tarchs)):
        assert ja.signature() == ta.signature()
        jm, tm = jb.build(ja), tb.build(ta)
        assert _metadata(jm) == _metadata(tm)
        assert (jm.flops, jm.n_params) == (tm.flops, tm.n_params)
        params = jm.init(jax.random.PRNGKey(i))
        model = candidate_from_jax(tm, jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
        want = jm.apply(params, jnp.asarray(x))
        with torch.inference_mode():
            got = model(torch.from_numpy(x))
        assert got.shape == (2, jspace_.output_dim)
        _close(got, want, atol=1e-4)


def test_candidate_from_jax_rejects_a_tree_that_does_not_fit():
    raw = _space("quickstart.yaml")
    drawn = _drawn(raw, 1)
    (ja,), (ta,) = drawn["jax"][1], drawn["torch"][1]
    space = drawn["jax"][0]
    params = jbuilder.ModelBuilder(space.input_shape, space.output_dim).build(ja).init(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["layer_0"]["extra"] = np.zeros(3, np.float32)
    del tree["layer_0"]["b"]
    tm = tbuilder.ModelBuilder(space.input_shape, space.output_dim).build(ta)
    with pytest.raises(ValueError, match=r"missing \['layer_0.b'\].*unexpected \['layer_0.extra'\]"):
        candidate_from_jax(tm, tree, device="cpu")


def test_built_model_init_and_state_dict_keys():
    drawn = _drawn(MIXER_SPACE, 1)
    (ja,), (ta,) = drawn["jax"][1], drawn["torch"][1]
    space = drawn["torch"][0]
    tm = tbuilder.ModelBuilder(space.input_shape, space.output_dim).build(ta)
    assert all(v.is_meta for v in tm.state_dict().values())
    jm = jbuilder.ModelBuilder(space.input_shape, space.output_dim).build(ja)
    jkeys = {f"{layer}.{leaf}" for layer, leaves in jm.init(jax.random.PRNGKey(0)).items()
             for leaf in leaves}
    assert set(tm.state_dict()) == jkeys
    tm.init(torch.Generator().manual_seed(0), "cpu")
    assert all(v.device.type == "cpu" and not v.requires_grad
               for v in tm.state_dict().values())


# -- the loop ---------------------------------------------------------------------

def _quickstart_study(space_mod, translate, builder, samplers, study):
    """examples/quickstart.py::hand_wired through one package."""
    raw = yaml.safe_load((EXPERIMENTS / "quickstart.yaml").read_text())
    space = space_mod.parse_search_space(raw["search_space"])
    b = builder.ModelBuilder(space.input_shape, space.output_dim)

    def objective(trial):
        arch = translate.sample_architecture(space, trial)
        model = b.build(arch)
        trial.set_user_attr("signature", arch.signature())
        return model.flops + 0.1 * model.n_params

    s = study.Study(name="quickstart", sampler=samplers.TPESampler(seed=0))
    s.optimize(objective, raw["budget"]["n_trials"])
    return s


def test_quickstart_loop_matches_jax():
    """TPE seed 0, 25 trials, flops + 0.1 n_params: the same parameters
    and value for every trial and the same best trial."""
    js = _quickstart_study(jspace, jtranslate, jbuilder, jsamplers, jstudy)
    ts = _quickstart_study(tspace, ttranslate, tbuilder, tsamplers, tstudy)
    assert len(ts.trials) == len(js.trials) == 25
    for jt, tt in zip(js.trials, ts.trials):
        assert tt.params == jt.params and tt.values == jt.values
        assert tt.user_attrs["signature"] == jt.user_attrs["signature"]
    assert ts.best_trial.number == js.best_trial.number
    assert ts.best_trial.params == js.best_trial.params


def test_measured_latency_on_host_cpu_over_kernel_tuning_space():
    """The hardware-in-the-loop criteria on the host's CPU: measured
    latency is finite and positive, an n_params hard constraint prunes
    before anything runs, and a repeated candidate is a cache hit."""
    raw = _space("kernel_tuning.yaml")
    space = tspace.parse_search_space(raw)
    b = tbuilder.ModelBuilder(space.input_shape, space.output_dim)
    cache = EvaluationCache()
    latency = test.CompiledLatencyEstimator(
        "host_cpu", batch=2, manager=test.HardwareManager(warmup=1, iters=2))
    runner = tapi.CriteriaRunner([
        tapi.OptimizationCriteria(test.ParamCountEstimator(), kind="hard_constraint",
                                  limit=50000.0),
        tapi.OptimizationCriteria(latency, kind="objective"),
    ], cache=cache)
    assert latency.cache is cache

    def objective(trial):
        return runner.evaluate(b.build(ttranslate.sample_architecture(space, trial)),
                               trial=trial)

    study = tstudy.Study(name="hil", sampler=tsamplers.RandomSampler(seed=3))
    study.optimize(objective, 6)
    done = [t for t in study.trials if t.state.name == "COMPLETE"]
    pruned = [t for t in study.trials if t.state.name != "COMPLETE"]
    assert done and pruned  # a width-32 head exceeds the budget, width 16 does not
    assert all(np.isfinite(t.value) and t.value > 0 for t in done)
    assert all(t.user_attrs["latency_s"] == t.value for t in done)
    assert cache.stats.misses >= 2 and cache.stats.hits >= 1


def test_unported_estimator_options_raise():
    """What the port's estimators do not take raises, naming it: an
    unknown latency metric.  The trained accuracy of Queue 1 item 11 is
    registered (tests/test_torch_train_infra.py holds it to the
    reference).  (``metric: modelled`` is ported; a CPU target's
    ``peak_bytes`` is counted: tests/test_torch_modelled.py; the serving
    family of item 10a is registered: tests/test_torch_serving.py.)"""
    from repro_torch.explorer.registry import ESTIMATORS

    with pytest.raises(ValueError, match="unknown latency metric"):
        test.CompiledLatencyEstimator("h100", metric="simulated")
    assert ESTIMATORS.get("val_accuracy") is test.TrainedAccuracyEstimator
    assert "p99_latency_s" in ESTIMATORS
