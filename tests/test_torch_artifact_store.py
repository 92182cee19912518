"""The port's artifact store (``repro_torch.evaluation.artifact_store``)
against the reference's store cases on the CPU, and the exported program
it keeps: canonical keys equal exactly when content is equal, torn
records and blobs as misses, ``REPRO_ARTIFACTS=0``, two processes
putting into one store, a JAX-package store in the same directory, a
program whose ops are not registered; then a narrow candidate with
attention and ssm on ``impl: pallas``: its graph holds the kernels' ops,
its blob does not grow with its weights, a fresh process gives the eager
forward bit for bit, and it agrees with the JAX package's
``candidate.apply`` (Pallas in interpret mode, weights through
``convert.py``).  A ``-m cuda`` case holds each registered op to the
``ctypes`` launch the wrappers made before the ops were registered."""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers

from repro_torch.core import builder as tbuilder  # noqa: E402
from repro_torch.core import space as tspace  # noqa: E402
from repro_torch.core import translate as ttranslate  # noqa: E402
from repro_torch.evaluation.artifact_store import ArtifactStore, content_hash  # noqa: E402
from repro_torch.hwgen import generator as tgen  # noqa: E402
from repro_torch.hwgen.targets import get_target  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.search import samplers as tsamplers  # noqa: E402
from repro_torch.search import study as tstudy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HOST = get_target("host_cpu")

# program keys as the estimators build them: (name, mesh scope, batch,
# signature[, ("sched", effective signature)])
_SIG_A = "conv1d(kernel_size=3,out_channels=4)|linear(width=8)"
_SIG_B = "conv1d(kernel_size=5,out_channels=4)|linear(width=8)"
_BASE = ("artifact", "1x1@cpu", 4, _SIG_A)
KEY_PAIRS = [
    (_BASE, _BASE, True),
    (_BASE + (("sched", "ssm_scan:chunk=64"),), _BASE + (("sched", "ssm_scan:chunk=64"),), True),
    (_BASE, ("latency_s",) + _BASE[1:], False),
    (_BASE, ("artifact", "1x1@cuda", 4, _SIG_A), False),
    (_BASE, ("artifact", "1x1@cpu", 8, _SIG_A), False),
    (_BASE, ("artifact", "1x1@cpu", 4, _SIG_B), False),
    (_BASE, _BASE + (("sched", "ssm_scan:chunk=64"),), False),
    (_BASE + (("sched", "ssm_scan:chunk=64"),), _BASE + (("sched", "ssm_scan:chunk=128"),),
     False),
]

# a narrow candidate with the SSD scan and flash attention on the kernels
# (an L that is a multiple of the Pallas blocks)
MIXED_SPACE = {
    "input": [16, 128], "output": 3,
    "sequence": [
        {"block": "mamba2", "op_candidates": "ssm",
         "ssm": {"impl": ["pallas"], "d_state": [8], "d_head": [8]}},
        {"block": "attention", "op_candidates": "attention",
         "attention": {"impl": ["pallas"], "heads": [2]}},
        {"block": "pool", "op_candidates": "global_avg_pool"},
        {"block": "head", "op_candidates": "linear", "linear": {"width": [8]}},
    ],
}
NAS_ATOL = 1e-4  # tests/test_torch_nas.py's for sampled candidates


def _program(width=16):
    """(unbuilt candidate, its space): the one architecture of
    ``MIXED_SPACE`` at input width ``width``."""
    raw = dict(MIXED_SPACE, input=[width, 128])
    space = tspace.parse_search_space(raw)
    archs = []
    tstudy.Study(name="draw", sampler=tsamplers.RandomSampler(seed=0)).optimize(
        lambda t: archs.append(ttranslate.sample_architecture(space, t)) or 0.0, 1)
    return tbuilder.ModelBuilder(space.input_shape, space.output_dim).build(archs[0]), raw


def _export(candidate, batch=2):
    c, l = candidate.input_shape
    x = torch.empty((batch, l, c), device="meta")
    return tgen.export_candidate(candidate, (x,), HOST)


def _tiny_program():
    return torch.export.export(torch.nn.Linear(4, 4), (torch.zeros(2, 4),))


def _put(store, key, program):
    return store.put(key, tgen.Artifact(target=HOST, fn=None, program=program))


def _run(code, *args, timeout=240):
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args],
                          capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


# -- keys ------------------------------------------------------------------------

@pytest.mark.parametrize("k1, k2, equal", KEY_PAIRS)
def test_store_keys_equal_iff_content_equal(k1, k2, equal):
    c1, c2 = ArtifactStore.canonical(k1), ArtifactStore.canonical(k2)
    assert c1 is not None and c2 is not None
    assert (c1 == c2) == equal == (k1 == k2)
    assert (content_hash(c1) == content_hash(c2)) == equal
    assert ArtifactStore.canonical(k1) == c1  # deterministic
    assert '"framework":"torch"' in c1  # the port's salt


@pytest.mark.parametrize("where", range(4))
def test_store_key_with_uncacheable_component_is_unstorable(where, tmp_path):
    broken = tuple(None if i == where else v for i, v in enumerate(_BASE))
    store = ArtifactStore(str(tmp_path))
    assert ArtifactStore.canonical(broken) is None
    assert not _put(store, broken, _tiny_program()) and len(store) == 0


# -- the store's files -------------------------------------------------------------

def test_torn_records_and_blobs_read_back_as_misses(tmp_path):
    store = ArtifactStore(str(tmp_path))
    good, torn, rotted = (("artifact", "1x1@cpu", b, _SIG_A) for b in (1, 2, 3))
    for key in (good, torn, rotted):
        assert _put(store, key, _tiny_program())
    manifest = Path(store.path) / ArtifactStore.MANIFEST
    lines = manifest.read_text().splitlines()
    rec = json.loads(lines[2])
    rec["crc"] += 1  # a record whose checksum no longer matches
    manifest.write_text("\n".join(lines[:2] + [json.dumps(rec), lines[0][:40]]) + "\n")
    blob = Path(store.path) / (json.loads(lines[1])["blob"] + ArtifactStore.SUFFIX)
    blob.write_bytes(blob.read_bytes()[:100])  # a torn archive

    fresh = ArtifactStore(str(tmp_path))
    assert len(fresh) == 2 and rotted not in fresh
    assert fresh.get(good, target=HOST) is not None
    assert fresh.get(torn, target=HOST) is None and fresh.get(rotted, target=HOST) is None
    assert fresh.stats() | {"export_s": 0.0} == {
        "entries": 2, "hits": 1, "misses": 2, "puts": 0, "bad_blobs": 1, "export_s": 0.0,
        "blob_bytes": 0}


def test_disabled_store_stores_nothing(tmp_path, monkeypatch):
    store = ArtifactStore(str(tmp_path))
    assert _put(store, _BASE, _tiny_program())
    monkeypatch.setenv("REPRO_ARTIFACTS", "0")
    assert not _put(store, ("latency_s",) + _BASE[1:], _tiny_program())
    assert store.get(_BASE, target=HOST) is None
    assert sorted(os.listdir(store.path)) == sorted(
        [ArtifactStore.MANIFEST, content_hash(ArtifactStore.canonical(_BASE)) + ".pt2"])


def test_two_processes_putting_into_one_store_leave_a_readable_manifest(tmp_path):
    code = """
    import sys, torch
    from repro_torch.evaluation.artifact_store import ArtifactStore
    from repro_torch.hwgen.generator import Artifact
    from repro_torch.hwgen.targets import get_target
    store, who = ArtifactStore(sys.argv[1]), int(sys.argv[2])
    ep = torch.export.export(torch.nn.Linear(4, 4), (torch.zeros(2, 4),))
    for i in range(6):
        for key in (("artifact", "1x1@cpu", i, f"linear(width={who})"),
                    ("artifact", "1x1@cpu", i, "shared")):
            assert store.put(key, Artifact(target=get_target("host_cpu"), fn=None, program=ep))
    print("ok")
    """
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), str(tmp_path),
                               str(who)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for who in (1, 2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    store = ArtifactStore(str(tmp_path))
    assert len(store) == 18
    for key in store.keys():
        assert store.get(tuple(json.loads(key)["key"]), target=HOST) is not None
    assert store.stats()["bad_blobs"] == 0


def test_a_jax_package_store_in_the_same_directory_is_never_read(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.evaluation import artifact_store as jstore

    compiled = jax.jit(lambda x: x * 2.0).lower(jnp.zeros(3)).compile()
    jax_artifact = mock.Mock(compiled=compiled, flops=1.0, bytes_accessed=2.0,
                             collective_bytes=0.0, memory={}, schedules=None)
    jstore.ArtifactStore(str(tmp_path)).put(_BASE, jax_artifact)

    with mock.patch.object(pickle, "loads", side_effect=AssertionError("unpickled")), \
            mock.patch.object(pickle, "load", side_effect=AssertionError("unpickled")):
        store = ArtifactStore(str(tmp_path))
        assert len(store) == 0 and _BASE not in store
        assert store.get(_BASE, target=HOST) is None
        assert _put(store, _BASE, _tiny_program()) and len(store) == 1
    assert len(jstore.ArtifactStore(str(tmp_path))) == 1  # the JAX store reads its own only


def test_loading_without_the_ops_registered_is_a_miss(tmp_path):
    """A program that calls an op the loading process has not registered:
    ``torch.export.load`` refuses it, and the store counts a miss."""
    if not hasattr(torch.ops.repro_torch_storetest, "twice"):
        @torch.library.custom_op("repro_torch_storetest::twice", mutates_args=())
        def twice(x: torch.Tensor) -> torch.Tensor:
            return 2 * x

        twice.register_fake(lambda x: torch.empty_like(x))

    class Twice(torch.nn.Module):
        def forward(self, x):
            return torch.ops.repro_torch_storetest.twice(x)

    store = ArtifactStore(str(tmp_path))
    assert _put(store, _BASE, torch.export.export(Twice(), (torch.zeros(3),)))
    assert store.get(_BASE, target=HOST) is not None  # registered here
    code = """
    import sys, json
    from repro_torch.evaluation.artifact_store import ArtifactStore
    store = ArtifactStore(sys.argv[1])
    print(json.dumps([store.get(tuple(json.loads(sys.argv[2])), target="host_cpu") is None,
                      store.stats()]))
    """
    missed, stats = json.loads(_run(code, str(tmp_path), json.dumps(list(_BASE))))
    assert missed and stats["bad_blobs"] == 1 and stats["misses"] == 1 and stats["entries"] == 1


# -- the exported program ----------------------------------------------------------

def test_exported_graph_holds_the_kernels_ops_and_no_weights():
    candidate, _ = _program()
    program = _export(candidate)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"repro_torch.flash_attention.default", "repro_torch.ssm_scan.default"} <= targets
    assert not program.state_dict and not program.constants
    names = {spec.arg.name for spec in program.graph_signature.input_specs}
    assert len(names) == len(dict(candidate.named_parameters())) + 1  # params + x


def test_blob_does_not_grow_with_the_weights_and_the_record_counts_it(tmp_path):
    store = ArtifactStore(str(tmp_path))
    sizes, weights = [], []
    for width in (16, 256):
        candidate, _ = _program(width)
        c, l = candidate.input_shape
        key = ("artifact", "1x1@cpu", 2, candidate.arch.signature() + f"@{width}")
        assert store.put(key, tgen.Artifact(target=HOST, fn=candidate,
                                            example_args=(torch.zeros(2, l, c),)))
        meta = store.record(key)["meta"]
        cost = tgen.program_cost(candidate, (torch.zeros(2, l, c),))
        assert (meta["flops"], meta["bytes_accessed"], meta["collective_bytes"]) == (
            cost.flops, cost.bytes_accessed, 0.0) and meta["flops"] > 0
        sizes.append(meta["blob_bytes"])
        weights.append(sum(p.numel() * 4 for p in candidate.parameters()))
    assert weights[1] > 100 * weights[0] and weights[1] > 10 * sizes[1]
    assert sizes[1] < 1.2 * sizes[0]


def test_loaded_program_gives_the_eager_forward_bit_for_bit_in_a_fresh_process(tmp_path):
    candidate, raw = _program()
    model = candidate.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 128, 16))
                         .astype(np.float32))
    with torch.inference_mode():
        eager = model(x)
    key = ("artifact", "1x1@cpu", 2, model.arch.signature())
    assert ArtifactStore(str(tmp_path)).put(key, tgen.Artifact(target=HOST, fn=model,
                                                               example_args=(x,)))
    torch.save({"state": model.state_dict(), "x": x, "eager": eager}, tmp_path / "run.pt")
    code = """
    import sys, json, torch
    from repro_torch.core import builder, space, translate
    from repro_torch.evaluation.artifact_store import ArtifactStore
    from repro_torch.search import samplers, study
    raw, key = json.loads(sys.argv[2]), tuple(json.loads(sys.argv[3]))
    sp, archs = space.parse_search_space(raw), []
    study.Study(name="d", sampler=samplers.RandomSampler(seed=0)).optimize(
        lambda t: archs.append(translate.sample_architecture(sp, t)) or 0.0, 1)
    model = builder.ModelBuilder(sp.input_shape, sp.output_dim).build(archs[0])
    run = torch.load(sys.argv[1] + "/run.pt")
    model.load_state_dict(run["state"], assign=True)
    artifact = ArtifactStore(sys.argv[1]).get(key, target="host_cpu", fn=model)
    with torch.inference_mode():
        got = artifact(run["x"])
    print(json.dumps([artifact.program is not None, bool(torch.equal(got, run["eager"]))]))
    """
    assert json.loads(_run(code, str(tmp_path), json.dumps(raw), json.dumps(list(key)))) \
        == [True, True]


def test_loaded_program_matches_the_jax_candidate(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import builder as jbuilder
    from repro.core import space as jspace
    from repro.core import translate as jtranslate
    from repro.search import samplers as jsamplers
    from repro.search import study as jstudy
    from repro_torch.convert import candidate_from_jax

    candidate, raw = _program()
    space, archs = jspace.parse_search_space(raw), []
    jstudy.Study(name="draw", sampler=jsamplers.RandomSampler(seed=0)).optimize(
        lambda t: archs.append(jtranslate.sample_architecture(space, t)) or 0.0, 1)
    jm = jbuilder.ModelBuilder(space.input_shape, space.output_dim).build(archs[0])
    assert archs[0].signature() == candidate.arch.signature()
    params = jm.init(jax.random.PRNGKey(0))
    model = candidate_from_jax(candidate, jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 128, 16)).astype(np.float32)
    store = ArtifactStore(str(tmp_path))
    key = ("artifact", "1x1@cpu", 2, model.arch.signature())
    assert store.put(key, tgen.Artifact(target=HOST, fn=model,
                                        example_args=(torch.from_numpy(x),)))
    artifact = ArtifactStore(str(tmp_path)).get(key, target=HOST, fn=model)
    with torch.inference_mode():
        got = artifact(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=NAS_ATOL, rtol=0)


# -- on the card -----------------------------------------------------------------

def _ctypes_flash(q, k, v, causal, window, scale, tiles):
    """The flash launch as the wrapper made it before the op was registered."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    assert ops._flash_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ops._DTYPES[q.dtype],
        b, s, t, h, kh, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), 0 if window is None else window, scale,
        tiles[0], tiles[1], stream) == 0
    return out


def _ctypes_ssm(x, dt, a, b, c, chunk):
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    fn, floats, _ = ops._ssm_fns()
    dt, a = dt.float(), a.float().contiguous()
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    scratch = torch.empty((max(1, floats(bsz, l, g, chunk, ops._DTYPES[x.dtype])),),
                          dtype=torch.float32, device=x.device)
    assert fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
              y.data_ptr(), state.data_ptr(), scratch.data_ptr(), ops._DTYPES[x.dtype],
              bsz, l, h, g, n, p, chunk, *x.stride()[:3], *dt.stride()[:3], *b.stride()[:3],
              *c.stride()[:3], torch.cuda.current_stream(x.device).cuda_stream) == 0
    return y, state


def _ctypes_mlstm(q, k, v, i_log, f_log, chunk):
    bsz, l, h, p = q.shape
    fn, floats = ops._mlstm_fns()
    i_log, f_log = i_log.float(), f_log.float()
    out = torch.empty((bsz, l, h, p), dtype=q.dtype, device=q.device)
    scratch = torch.empty((floats(bsz, l, h, p, chunk),), dtype=torch.float32, device=q.device)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_log.data_ptr(), f_log.data_ptr(),
              out.data_ptr(), scratch.data_ptr(), ops._DTYPES[q.dtype], bsz, l, h, p, chunk,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *i_log.stride()[:3],
              *f_log.stride()[:3], torch.cuda.current_stream(q.device).cuda_stream) == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_ops_give_the_ctypes_launch_bit_for_bit(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = rand(2, 256, 8, 64), rand(2, 256, 4, 64), rand(2, 256, 4, 64)
    tiles = ops.flash_launch_tiles(128, 128, 64, dtype)
    want = _ctypes_flash(q, k, v, True, None, 0.125, tiles)
    before = ops.LAUNCHES["flash_attention"]
    got = torch.ops.repro_torch.flash_attention(q, k, v, True, None, 0.125, *tiles)
    assert torch.equal(got, want) and ops.LAUNCHES["flash_attention"] == before + 1

    x, dt, a = rand(2, 256, 4, 64), rand(2, 256, 4, dt=torch.float32).abs(), -rand(
        4, dt=torch.float32).abs()
    b, c = rand(2, 256, 1, 64), rand(2, 256, 1, 64)
    want = _ctypes_ssm(x, dt, a, b, c, 128)
    got = torch.ops.repro_torch.ssm_scan(x, dt, a, b, c, 128)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    q, k, v = rand(1, 256, 2, 128), rand(1, 256, 2, 128), rand(1, 256, 2, 128)
    i_log, f_log = rand(1, 256, 2, dt=torch.float32), -rand(1, 256, 2, dt=torch.float32).abs()
    want = _ctypes_mlstm(q, k, v, i_log, f_log, 64)
    got = torch.ops.repro_torch.mlstm_scan(q, k, v, i_log, f_log, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_program_traced_for_the_card_bakes_in_the_tiles_and_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    candidate, _ = _program()
    program = tgen.export_candidate(candidate, (torch.empty((2, 128, 16), device="meta"),),
                                    get_target("h100"))
    (flash,) = [n for n in program.graph.nodes
                if str(n.target) == "repro_torch.flash_attention.default"]
    assert tuple(flash.args[-2:]) == ops.flash_launch_tiles(128, 128, 8, torch.float32)
    model = candidate.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    x = torch.randn(2, 128, 16, device="cuda")
    before = dict(ops.LAUNCHES)
    with torch.inference_mode():
        got = program.module()(dict(model.named_parameters()), x)
        want = model(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert all(ops.LAUNCHES[k] == before.get(k, 0) + 2 for k in ("flash_attention", "ssm_scan"))
