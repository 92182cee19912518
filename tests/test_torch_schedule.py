"""The port's kernel schedules, resolver, discovery and tuner against the
JAX package's: effective schedules and signatures over a table of calls,
the resolver's precedence and chunk halving on the same call, the kernel
calls a candidate reaches, and the tuner's buckets and default winners;
plus the CUDA flash kernel's tile rule, which has no counterpart (the
Pallas kernel takes any block)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import schedule as tsched  # noqa: E402


def _jax():
    """The JAX package's schedule and ops modules, imported only by the
    tests that compare with them (the machine with the card need not have
    JAX)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import schedule as jsched

    return jax, jops, jsched


# (kernel, schedule fields or None, L, T)
EFFECTIVE_TABLE = [
    ("flash_attention", None, 2048, None),
    ("flash_attention", None, 64, None),
    ("flash_attention", {"block_q": 256, "block_kv": 256}, 40, None),
    ("flash_attention", {"block_q": 64, "block_kv": 128}, 200, 100),
    ("flash_attention", {"block_q": 8, "block_kv": 8}, 4, 4),
    ("flash_attention", {"block_kv": 64}, 512, 512),
    ("ssm_scan", None, 2048, None),
    ("ssm_scan", {"chunk": 32}, 48, None),
    ("ssm_scan", {"chunk": 64}, 96, None),
    ("ssm_scan", {"chunk": 1024}, 200, None),
    ("ssm_scan", {"chunk": 8}, 7, None),
    ("mlstm_scan", {"chunk": 512}, 192, None),
    ("mlstm_scan", {"chunk": 512}, 2048, None),
    ("mlstm_scan", None, 100, None),
]


@pytest.mark.parametrize("kernel, fields, l, t", EFFECTIVE_TABLE)
def test_effective_schedule_and_signature_match_jax(kernel, fields, l, t):
    _, _, jsched = _jax()
    want = jsched.effective_schedule(
        kernel, None if fields is None else jsched.KernelSchedule(**fields), seq_len=l, kv_len=t)
    got = tsched.effective_schedule(
        kernel, None if fields is None else tsched.KernelSchedule(**fields), seq_len=l, kv_len=t)
    assert got.to_dict() == want.to_dict()
    assert (tsched.schedule_signature(kernel, got)
            == jsched.schedule_signature(kernel, want))


def test_candidate_grids_defaults_and_search_choices_match_jax():
    _, _, jsched = _jax()
    assert tsched.KERNEL_FIELDS == jsched.KERNEL_FIELDS
    assert tsched.SEARCH_CHOICES == jsched.SEARCH_CHOICES
    assert (tsched.MIN_SIZE, tsched.MAX_SIZE) == (jsched.MIN_SIZE, jsched.MAX_SIZE)
    for kernel in jsched.KERNEL_FIELDS:
        assert ([c.to_dict() for c in tsched.CANDIDATE_SCHEDULES[kernel]]
                == [c.to_dict() for c in jsched.CANDIDATE_SCHEDULES[kernel]])
        assert (tsched.default_schedule(kernel).to_dict()
                == jsched.default_schedule(kernel).to_dict())


@pytest.mark.parametrize("kernel, raw, message", [
    ("ssm_scan", {"chunk": 24}, "power of two"),
    ("ssm_scan", {"chunk": 2048}, "outside the legal range"),
    ("flash_attention", {"chunk": 64}, "does not apply"),
    ("mlstm_scan", {"chunk": 64.0}, "must be an integer"),
    ("mlstm_scan", {"chunks": 64}, "unknown schedule field"),
])
def test_validation_errors_match_jax(kernel, raw, message):
    _, _, jsched = _jax()
    with pytest.raises(jsched.ScheduleError, match=message):
        jsched.as_schedule(kernel, raw)
    with pytest.raises(tsched.ScheduleError, match=message):
        tsched.as_schedule(kernel, raw)


# -- the resolver: precedence and halving, recorded ------------------------------

L, H, P = 48, 2, 8


def _scan_arrays(kernel):
    rng = np.random.default_rng(0)
    if kernel == "ssm_scan":
        return [rng.standard_normal(s).astype(np.float32)
                for s in ((1, L, H, P), (1, L, H), (H,), (1, L, 1, 4), (1, L, 1, 4))]
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((1, L, H, P),) * 3 + ((1, L, H),) * 2]


def _recorded(sched, call):
    sink = {}
    with sched.record_kernel_calls(sink):
        call()
    (entry,) = sink.values()
    return entry


# (legacy chunk kwarg, explicit schedule, active context): every precedence
# case, and legacy chunks that do not divide L (halved, unvalidated)
RESOLVER_CASES = [
    (None, None, None),
    (12, None, None),
    (40, None, None),
    (5, None, None),
    (128, None, {"chunk": 32}),
    (None, {"chunk": 64}, {"chunk": 32}),
    (20, {"chunk": 16}, None),
    (None, None, {"chunk": 1024}),
]


@pytest.mark.parametrize("kernel", ["ssm_scan", "mlstm_scan"])
@pytest.mark.parametrize("legacy, explicit, active", RESOLVER_CASES)
def test_scan_resolver_matches_jax(kernel, legacy, explicit, active):
    """The same call through both wrappers records the same requested and
    effective schedule and shapes; the port's runs on the meta device,
    the reference's under ``jax.eval_shape``."""
    jax, jops, jsched = _jax()
    arrays = _scan_arrays(kernel)
    kw = {"chunk": legacy}

    def jcall():
        with jsched.use_schedules({kernel: active} if active else None):
            jax.eval_shape(lambda *a: getattr(jops, kernel)(
                *a, schedule=None if explicit is None else jsched.KernelSchedule(**explicit),
                **kw), *arrays)

    def tcall():
        with tsched.use_schedules({kernel: active} if active else None):
            getattr(ops, kernel)(
                *[torch.empty(a.shape, device="meta") for a in arrays],
                schedule=None if explicit is None else tsched.KernelSchedule(**explicit), **kw)

    want, got = _recorded(jsched, jcall), _recorded(tsched, tcall)
    for field in ("requested", "effective"):
        assert (tsched.schedule_signature(kernel, got[field])
                == jsched.schedule_signature(kernel, want[field])), field
    assert got["shapes"] == want["shapes"]
    assert got["meta"] == want["meta"]
    assert got["launched"] == {"chunk": got["effective"].chunk}


@pytest.mark.parametrize("legacy, explicit, active", [
    ((None, None), None, None),
    ((64, 32), None, None),
    ((None, None), {"block_q": 256, "block_kv": 64}, None),
    ((16, 16), None, {"block_q": 64, "block_kv": 128}),
    ((None, None), {"block_q": 8, "block_kv": 256}, {"block_q": 64}),
])
def test_flash_resolver_matches_jax(legacy, explicit, active):
    jax, jops, jsched = _jax()
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 200, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((1, 100, 2, 16)).astype(np.float32)
    kw = {"causal": False, "block_q": legacy[0], "block_kv": legacy[1]}

    def jcall():
        with jsched.use_schedules({"flash_attention": active} if active else None):
            jax.eval_shape(lambda q, k, v: jops.flash_attention(
                q, k, v, schedule=None if explicit is None else jsched.KernelSchedule(**explicit),
                **kw), q, kv, kv)

    def tcall():
        with tsched.use_schedules({"flash_attention": active} if active else None):
            ops.flash_attention(
                torch.empty(q.shape, device="meta"), torch.empty(kv.shape, device="meta"),
                torch.empty(kv.shape, device="meta"),
                schedule=None if explicit is None else tsched.KernelSchedule(**explicit), **kw)

    want, got = _recorded(jsched, jcall), _recorded(tsched, tcall)
    for field in ("requested", "effective"):
        assert (tsched.schedule_signature("flash_attention", got[field])
                == jsched.schedule_signature("flash_attention", want[field])), field
    assert got["shapes"] == want["shapes"] and got["meta"] == want["meta"]
    eff = got["effective"]
    assert got["launched"] == dict(zip(("block_q", "block_kv"), ops.flash_launch_tiles(
        eff.block_q, eff.block_kv, 16, torch.float32)))


def test_halved_legacy_chunk_runs_the_plain_version_as_jax_does():
    """A legacy chunk that does not divide L is halved until it does (20 ->
    10 -> 5 -> 2 on L = 48): the CPU path's output equals the reference
    wrapper's, which halves the same way."""
    jax, jops, _ = _jax()
    arrays = _scan_arrays("ssm_scan")
    want, _ = jops.ssm_scan(*[jax.numpy.asarray(a) for a in arrays], chunk=20)
    got, _ = ops.ssm_scan(*[torch.from_numpy(a) for a in arrays], chunk=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)


def test_meta_call_records_and_returns_shapes_without_launching():
    before = dict(ops.LAUNCHES)
    x = torch.empty(2, 64, 4, 8, device="meta")
    y, state = ops.ssm_scan(x, torch.empty(2, 64, 4, device="meta"),
                            torch.empty(4, device="meta"),
                            torch.empty(2, 64, 1, 16, device="meta"),
                            torch.empty(2, 64, 1, 16, device="meta"), chunk=32)
    assert y.shape == (2, 64, 4, 8) and state.shape == (2, 4, 16, 8) and y.is_meta
    h, none = ops.mlstm_scan(*(torch.empty(1, 64, 2, 8, device="meta"),) * 3,
                             *(torch.empty(1, 64, 2, device="meta"),) * 2, chunk=16)
    assert h.shape == (1, 64, 2, 8) and none is None
    assert dict(ops.LAUNCHES) == before


# -- the flash kernel's tile rule ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tile_rule_covers_every_head_dim(dtype):
    """Every head dim the kernel takes (multiples of 4 to 256) has a built
    pair; at D <= 96 both query tiles are built; above 128 only one."""
    for d in range(4, 257, 4):
        pairs = [(bq, bk) for bq in ops.FLASH_Q_TILES for bk in ops.FLASH_KV_TILES
                 if ops.flash_takes(d, dtype, bq, bk)]
        assert (64, 32) in pairs, d
        assert ({bq for bq, _ in pairs} == {64, 128}) == (d <= 96 or (d <= 112 and dtype == torch.bfloat16)), d
    assert not ops.flash_takes(260, dtype, 64, 32) and not ops.flash_takes(42, dtype, 64, 32)


@pytest.mark.parametrize("d, dtype, want", [
    (80, torch.float32, (128, 32)), (80, torch.bfloat16, (128, 64)),
    (128, torch.float32, (64, 64)), (128, torch.bfloat16, (64, 64)),
    (192, torch.float32, (64, 32)), (256, torch.bfloat16, (64, 32)),
])
def test_default_schedule_launches_the_tiles_the_kernel_had(d, dtype, want):
    """The named default (128, 128) maps onto the pre-schedule tiles at the
    NAS (D = 80) and served (D = 128) head dims, and onto the one query
    tile above 128."""
    assert ops.flash_launch_tiles(128, 128, d, dtype) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 36, 80, 96, 112, 128, 160, 192, 256])
def test_flash_launch_tiles_is_the_largest_built_pair_at_or_below(d, dtype):
    sizes = (8, 16, 32, 64, 128, 256, 1024)
    built = [(bq, bk) for bq in ops.FLASH_Q_TILES for bk in ops.FLASH_KV_TILES
             if ops.flash_takes(d, dtype, bq, bk)]
    for block_q in sizes:
        for block_kv in sizes:
            bq, bk = ops.flash_launch_tiles(block_q, block_kv, d, dtype)
            assert (bq, bk) in built
            qs = [q for q, _ in built if q <= block_q]
            assert bq == (max(qs) if qs else min(q for q, _ in built))
            ks = [k for q, k in built if q == bq and k <= block_kv]
            assert bk == (max(ks) if ks else min(k for q, k in built if q == bq))
    assert ops.flash_launch_tiles(128, 128, d, torch.float64) is None


# -- discovery and the tuner -----------------------------------------------------

# a candidate with ssm and attention on impl pallas (sequence 64, chunk 128
# clamped to 64, blocks clamped to 64)
SPACE = {
    "input": [8, 64], "output": 4,
    "sequence": [
        {"block": "mixer", "op_candidates": ["ssm", "attention"],
         "type_repeat": {"type": "vary_all", "depth": [2]},
         "ssm": {"impl": ["pallas"], "d_state": [8], "d_head": [4], "expand": [2]},
         "attention": {"impl": ["pallas"], "heads": [2]}},
        {"block": "pool", "op_candidates": "global_avg_pool"},
        {"block": "head", "op_candidates": "linear", "linear": {"width": [8]}},
    ],
}
PARAMS = {"mixer.depth": 2, "mixer.0.op": "ssm", "mixer.1.op": "attention"}


def _built_pair():
    """The candidate of ``PARAMS`` in both packages: sampled by each one's
    random sampler until that architecture comes up (seeded, so the same
    trial number in both)."""
    jax, _, _ = _jax()
    from repro.core import builder as jbuilder
    from repro.core import space as jspace
    from repro.core import translate as jtranslate
    from repro.search import samplers as jsamplers
    from repro.search import study as jstudy
    from repro_torch.core import builder as tbuilder
    from repro_torch.core import space as tspace
    from repro_torch.core import translate as ttranslate
    from repro_torch.search import samplers as tsamplers
    from repro_torch.search import study as tstudy

    def find(space_mod, translate, builder_mod, samplers, study_mod):
        space = space_mod.parse_search_space(SPACE)
        builder = builder_mod.ModelBuilder(space.input_shape, space.output_dim)
        study = study_mod.Study(name="find", sampler=samplers.RandomSampler(seed=0))
        for _ in range(64):
            trial = study.ask()
            arch = translate.sample_architecture(space, trial)
            study.tell(trial, 0.0)
            if all(trial.params.get(k) == v for k, v in PARAMS.items()):
                return trial.number, builder.build(arch)
        raise AssertionError("the sampler never drew the ssm + attention candidate")

    return (jax, find(jspace, jtranslate, jbuilder, jsamplers, jstudy),
            find(tspace, ttranslate, tbuilder, tsamplers, tstudy))


def _jax_calls(jax, model, batch=2):
    from repro.hwgen.autotune import discover_kernel_calls

    l, c = model.input_shape[-1], model.input_shape[0]
    x = jax.ShapeDtypeStruct((batch, l, c), jax.numpy.float32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return discover_kernel_calls(model.apply, (params, x))


def _torch_calls(model, batch=2):
    from repro_torch.hwgen.autotune import discover_kernel_calls

    l, c = model.input_shape[-1], model.input_shape[0]
    return discover_kernel_calls(model, (torch.empty(batch, l, c, device="meta"),))


def test_discovery_finds_the_same_kernel_calls_as_jax():
    jax, (jn, jmodel), (tn, tmodel) = _built_pair()
    assert jn == tn
    want, got = _jax_calls(jax, jmodel), _torch_calls(tmodel)
    assert sorted(got) == sorted(want) and len(got) == 2
    for key in want:
        assert got[key]["shapes"] == want[key]["shapes"]
        assert got[key]["meta"] == want[key]["meta"]


def test_discovery_leaves_the_candidate_as_it_was():
    _, _, (_, model) = _built_pair()
    model.init(torch.Generator().manual_seed(0), "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _torch_calls(model)
    after = model.state_dict()
    assert all(not after[k].is_meta and torch.equal(after[k], before[k]) for k in before)


def _tuners(tmp_path, budget):
    from repro.evaluation.cache import EvaluationCache as JCache
    from repro.hwgen.autotune import ScheduleTuner as JTuner
    from repro.hwgen.targets import get_target as jtarget
    from repro_torch.evaluation.cache import EvaluationCache as TCache
    from repro_torch.hwgen.autotune import ScheduleTuner as TTuner
    from repro_torch.hwgen.targets import get_target as ttarget

    def pair(tag):
        return (JTuner(jtarget("host_cpu"), cache=JCache(disk=str(tmp_path / f"j{tag}")),
                       budget=budget, warmup=0, iters=1),
                TTuner(ttarget("host_cpu"), cache=TCache(disk=str(tmp_path / f"t{tag}")),
                       budget=budget, warmup=1, iters=1))
    return pair


def test_tuner_at_budget_one_gives_the_same_buckets_and_default_winners(tmp_path):
    jax, (_, jmodel), (_, tmodel) = _built_pair()
    jcalls, tcalls = _jax_calls(jax, jmodel), _torch_calls(tmodel)
    jtuner, ttuner = _tuners(tmp_path, 1)("a")
    for key in jcalls:
        j, t = jcalls[key], tcalls[key]
        assert (ttuner.shape_bucket(j["kernel"], t["shapes"], t["meta"])
                == jtuner.shape_bucket(j["kernel"], j["shapes"], j["meta"]))
        jr = jtuner.tune(j["kernel"], j["shapes"], j["meta"])
        tr = ttuner.tune(t["kernel"], t["shapes"], t["meta"])
        assert tr["bucket"] == jr["bucket"]
        assert tr["schedule"] == jr["schedule"] == tsched.default_schedule(j["kernel"]).to_dict()
        assert [c["effective"] for c in tr["candidates"]] == \
            [c["effective"] for c in jr["candidates"]]
        assert tr["launched"] is None  # the CPU runs the plain version
    assert {k: v for k, v in ttuner.stats().items() if k != "tune_time_s"} == \
        {k: v for k, v in jtuner.stats().items() if k != "tune_time_s"} == \
        {"tunes": 2, "cache_hits": 0}
    assert [(r["kernel"], r["bucket"]) for r in ttuner.records()] == sorted(
        (j["kernel"], jtuner.shape_bucket(j["kernel"], j["shapes"], j["meta"]))
        for j in jcalls.values())


def test_tuner_sweeps_the_same_deduplicated_candidates_and_a_warm_cache_tunes_nothing(tmp_path):
    from repro_torch.evaluation.cache import EvaluationCache
    from repro_torch.hwgen.autotune import ScheduleTuner
    from repro_torch.hwgen.targets import get_target

    jax, (_, jmodel), (_, tmodel) = _built_pair()
    jcalls, tcalls = _jax_calls(jax, jmodel), _torch_calls(tmodel)
    jtuner, ttuner = _tuners(tmp_path, 8)("b")
    for key in jcalls:
        j, t = jcalls[key], tcalls[key]
        jr = jtuner.tune(j["kernel"], j["shapes"], j["meta"])
        tr = ttuner.tune(t["kernel"], t["shapes"], t["meta"])
        assert ([(c["schedule"], c["effective"]) for c in tr["candidates"]]
                == [(c["schedule"], c["effective"]) for c in jr["candidates"]])
    warm = ScheduleTuner(get_target("host_cpu"), budget=8,
                         cache=EvaluationCache(disk=str(tmp_path / "tb")))
    for t in tcalls.values():
        warm.tune(t["kernel"], t["shapes"], t["meta"])
    assert warm.stats() == {"tunes": 0, "cache_hits": 2, "tune_time_s": 0.0}
