"""The port's dry run against the JAX package's on the CPU: the collective
counter against ``hlo_analysis.analyze_collectives`` kind for kind, the
dry run's pure functions and skip reasons, per-device parameter and
optimizer bytes against the JAX resolver's shard shapes, ``model_flops``,
FLOPs counted once on local shards, the CLI on a swapped-in (2, 4) mesh
and ``--all`` resuming; then per-layer remat (on, off, ``"dots"``) against
itself bit for bit and against ``jax.value_and_grad``, and the decode
path's sharded pieces.  Each fake process group is destroyed after use."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro_torch.hwgen import sharded  # noqa: E402
from repro_torch.hwgen.collectives import COLLECTIVES, CollectiveCounter  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# fp32 against fp32, the sums in another order (tests/test_torch_train.py)
REL = 1e-5


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                JAX_PLATFORMS="cpu")


@pytest.fixture
def fake_group():
    """Start the fake process group at ``world`` ranks; destroyed after."""
    import torch.distributed as dist

    def start(world):
        assert not dist.is_initialized()
        sharded.start_fake_group(world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference_dryrun():
    """The JAX package's dry-run module.  Importing it sets XLA_FLAGS to
    512 host devices, which only a JAX not yet started would read: start
    JAX first and put the variable back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


# -- the collective counter ------------------------------------------------------

JAX_COLLECTIVES = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.hwgen.hlo_analysis import analyze_collectives
mesh = Mesh(np.array(jax.devices()).reshape(8), ("x",))
progs = {
    "psum": lambda a: jax.lax.psum(a, "x"),
    "all_gather": lambda a: jax.lax.all_gather(a, "x", tiled=True),
    "psum_scatter": lambda a: jax.lax.psum_scatter(a, "x", scatter_dimension=0, tiled=True),
    "all_to_all": lambda a: jax.lax.all_to_all(a, "x", 0, 0, tiled=True),
    "ppermute": lambda a: jax.lax.ppermute(a, "x", [(i, (i + 1) % 8) for i in range(8)]),
}
out = {}
for name, f in progs.items():
    if hasattr(jax, "shard_map"):
        g = jax.shard_map(f, mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_vma=False)
    else:
        from jax.experimental.shard_map import shard_map
        g = shard_map(f, mesh=mesh, in_specs=P("x"), out_specs=P("x"), check_rep=False)
    x = jnp.zeros((8 * 16, 32), jnp.float32)
    out[name] = analyze_collectives(jax.jit(g).lower(x).compile().as_text())
print("COLLECTIVES " + json.dumps(out))
"""


def test_counter_counts_each_kind_as_the_hlo_parser(fake_group):
    """Five one-collective ``shard_map`` programs on 8 spoofed devices,
    parsed by ``analyze_collectives``, against the same functional
    collectives on the same local shapes (16 x 32 fp32 a device) issued on
    an 8-rank fake group under :class:`CollectiveCounter`: counts and
    operand bytes equal per kind."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    r = subprocess.run([sys.executable, "-c", JAX_COLLECTIVES], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.split("COLLECTIVES ", 1)[1])
    fake_group(8)
    group = dist.group.WORLD
    local = torch.zeros(16, 32)
    issue = {
        "psum": lambda: funcol.all_reduce(local, "sum", group),
        "all_gather": lambda: funcol.all_gather_tensor(local, 0, group),
        "psum_scatter": lambda: funcol.reduce_scatter_tensor(local, "sum", 0, group),
        "all_to_all": lambda: funcol.all_to_all_single(local, None, None, group),
        "ppermute": lambda: dist.send(local, 1),
    }
    for name, fn in issue.items():
        with CollectiveCounter() as counter:
            out = fn()
            if isinstance(out, torch.Tensor):
                out = out + 0  # waits on an async collective's result
        assert set(counter.stats) == set(want[name]) == set(COLLECTIVES)
        assert counter.stats == want[name], name
        assert sum(v["count"] for v in counter.stats.values()) == 1


# -- the reference's pure functions ----------------------------------------------------

def _assert_same(port, ref, path="spec"):
    """Field by field; a field only the JAX dataclass has is at its
    default (tests/test_torch_lm_space.py's rule)."""
    if dataclasses.is_dataclass(port):
        names = {f.name for f in dataclasses.fields(port)}
        for f in dataclasses.fields(ref):
            if f.name in names:
                _assert_same(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
            else:
                default = (f.default if f.default is not dataclasses.MISSING
                           else f.default_factory())
                assert getattr(ref, f.name) == default, f"{path}.{f.name}"
    elif isinstance(port, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    else:
        assert port == ref, path


VARIANTS = ("chunked_attn", "remat_dots", "no_remat", "moe_2d", "seq_shard", "kvc512",
            "chunked_loss,remat_dots,seq_shard,moe_2d", "chunked_attn,last_logit,kvc256")


def test_pure_functions_and_skips_match_the_reference():
    """``apply_variant`` for every flag and ``_slice_units`` over the ten
    configs (long context too), ``optimized_variant``, ``_cell_id``,
    ``all_cells``, ``TRAIN_MICROBATCHES``, ``PATTERN_UNITS``,
    ``DEFAULT_OUT`` and the skip records of every arch x shape x mesh
    (``cell_supported``'s reason) equal the JAX package's."""
    from repro.configs import get_arch as jax_get_arch

    ref = _reference_dryrun()
    assert dryrun.TRAIN_MICROBATCHES == ref.TRAIN_MICROBATCHES
    assert dryrun.PATTERN_UNITS == ref.PATTERN_UNITS
    assert dryrun.DEFAULT_OUT == ref.DEFAULT_OUT
    assert list(dryrun.all_cells()) == list(ref.all_cells())
    skipped = 0
    for arch in ARCHS:
        for long_context in (False, True):
            port = get_arch(arch).spec(long_context=long_context)
            want = jax_get_arch(arch).spec(long_context=long_context)
            for variant in VARIANTS:
                _assert_same(dryrun.apply_variant(port, variant),
                             ref.apply_variant(want, variant), f"{arch}:{variant}")
            for k in (1, 2):
                _assert_same(dryrun._slice_units(port, arch, k),
                             ref._slice_units(want, arch, k), f"{arch}:{k}")
        for shape in SHAPES:
            assert dryrun.optimized_variant(arch, shape) == ref.optimized_variant(arch, shape)
            for mesh in ("single", "multi"):
                assert dryrun._cell_id(arch, shape, mesh) == ref._cell_id(arch, shape, mesh)
                if get_arch(arch).cell_supported(SHAPES[shape])[0]:
                    continue
                got = dryrun.run_cell(arch, shape, mesh == "multi")
                want = ref.run_cell(arch, shape, mesh == "multi")
                assert got["status"] == "skipped"
                # the same reason, the port's config base ending it in its own words
                stem = f"long_500k requires sub-quadratic sequence mixing; {arch} is a " \
                       f"full-attention arch"
                assert got.pop("reason").startswith(stem) and want.pop("reason").startswith(stem)
                assert got == want
                skipped += 1
    assert skipped == 16


# -- per-device bytes and model_flops against the JAX resolver ----------------------------

def _jax_shard_bytes(arch, variant, mesh_name, n_units=None, mesh_shape=None):
    """(parameter bytes, AdamW bytes) a device holds under the JAX
    resolver, on an ``AbstractMesh``: each leaf's shard shape x its dtype
    (bf16 parameters, fp32 moments, the int32 step), and the JAX
    package's ``model_flops`` of the train cell."""
    import functools

    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import get_arch as jax_get_arch
    from repro.distributed.sharding import default_rules, shapes_shardings_from_axes
    from repro.evaluation.model_flops import model_flops
    from repro.models.lm import LM as JaxLM
    from repro.nn.types import split
    from repro.train.optimizer import Optimizer, OptimizerConfig

    ref = _reference_dryrun()
    spec = ref.apply_variant(jax_get_arch(arch).spec(), variant)
    if n_units is not None:
        spec = ref._slice_units(spec, arch, n_units)
    shape, names = mesh_shape or MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    model = JaxLM(spec)
    values, axes = split(jax.eval_shape(functools.partial(model.init, dtype=jnp.bfloat16),
                                        jax.random.PRNGKey(0)))
    shardings = shapes_shardings_from_axes(values, axes, mesh, default_rules(mesh))

    def shard_bytes(v, sh, dtype=None):
        sh = sh if isinstance(sh, NamedSharding) else NamedSharding(mesh, sh)
        return int(np.prod(sh.shard_shape(v.shape))) * np.dtype(dtype or v.dtype).itemsize

    params = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(shard_bytes, values,
                                                                  shardings)))
    opt = jax.eval_shape(Optimizer(OptimizerConfig(name="adamw")).init, values)
    moments = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        shard_bytes, opt["mu"], shardings)) + jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(shard_bytes, opt["nu"], shardings)))
    step = opt["step"].size * np.dtype(opt["step"].dtype).itemsize
    cell = SHAPES["train_4k"]
    return params, moments + step, model_flops(spec, "train", cell.batch, cell.seq)


TRAIN_VARIANTS = [(a, "") for a in ARCHS] + [("dbrx-132b", "moe_2d"), ("arctic-480b", "moe_2d")]


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_per_device_bytes_and_model_flops_match_jax(mesh_name, fake_group):
    """Every train cell's ``param_bytes_per_device`` and
    ``opt_bytes_per_device`` on the 256- (512-) rank production mesh over
    the fake group, the two ``moe_2d`` variants included, equal the JAX
    resolver's shard shapes times their dtypes, and the record's
    ``model_flops`` the JAX package's."""
    fake_group(512 if mesh_name == "multi" else 256)
    for arch, variant in TRAIN_VARIANTS:
        _, _, _, meta = dryrun.build_cell(arch, "train_4k", mesh_name == "multi",
                                          variant=variant)
        params, opt, flops = _jax_shard_bytes(arch, variant, mesh_name)
        assert meta["param_bytes_per_device"] == params, (arch, variant)
        assert meta["opt_bytes_per_device"] == opt, (arch, variant)
        assert meta["model_flops"] == flops, (arch, variant)


# -- FLOPs counted once -------------------------------------------------------------------

def _small_mesh(shape, names=("data", "model")):
    from repro_torch.launch import mesh as mesh_lib

    return lambda multi_pod=False, device_type=None: mesh_lib.make_mesh(shape, names,
                                                                         device_type)


def test_flops_are_counted_once_on_local_shards(fake_group, monkeypatch):
    """A column-sharded linear on a (2, 4) mesh of 8 fake ranks counts a
    quarter of the global FLOPs on each device (``FlopCounterMode`` counts
    the global product besides the local one); and on a (1, 1) mesh the
    dry run's FLOPs of qwen3-1.7b's train step (production widths, one
    layer) equal ``FlopCounterMode``'s count of the same step on plain
    meta tensors, and it issues no collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import input_specs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.lm import LM
    from repro_torch.train.optimizer import Optimizer, OptimizerConfig
    from repro_torch.train.step import make_train_step, param_dict

    fake_group(8)
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), "cuda")
    x = distribute_tensor(torch.empty(64, 128, device="meta"), mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(128, 256, device="meta"), mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    with CollectiveCounter() as counter, sharded.LocalCost() as cost:
        y = x @ w
    assert tuple(y.placements) == (Replicate(), Shard(1))
    assert cost.flops == 2 * 64 * 128 * 256 // 4
    assert sum(v["count"] for v in counter.stats.values()) == 0

    monkeypatch.setattr(mesh_lib, "make_production_mesh", _small_mesh((1, 1)))
    record = dryrun.run_cell("qwen3-1.7b", "train_4k", False, n_units=1)
    assert record["status"] == "ok" and record["collective_bytes"] == 0
    spec = dryrun._slice_units(get_arch("qwen3-1.7b").spec(), "qwen3-1.7b", 1)
    model = LM(spec).init(None, torch.bfloat16)
    params = param_dict(model)
    opt = Optimizer(OptimizerConfig(name="adamw"))
    batch, _ = input_specs(get_arch("qwen3-1.7b"), SHAPES["train_4k"], spec)
    step = make_train_step(model, opt)
    with FlopCounterMode(display=False) as plain:
        step(params, opt.init(params), batch)
    assert record["cost"]["flops"] == plain.get_total_flops() > 0
    assert record["cost_mode"] == "full"


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_extrapolated_counts_equal_the_full_count(shape, fake_group, monkeypatch):
    """xlstm-1.3b's train and prefill cells (an sLSTM time loop: too slow to
    count at full depth on the host) are extrapolated from 0 and 1
    layer-pattern units; at production widths on a (2, 4) mesh, with the
    cell's sequence cut to 16, the extrapolated FLOPs, bytes,
    transcendentals and collectives equal the count of all 6 units."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import mesh as mesh_lib

    fake_group(8)
    monkeypatch.setattr(mesh_lib, "make_production_mesh", _small_mesh((2, 4)))
    kind = SHAPES[shape].kind
    monkeypatch.setitem(dryrun.SHAPES, shape, ShapeCell(shape, kind, 16, 8))
    assert dryrun._time_loop("xlstm-1.3b", shape)
    got = dryrun.run_cell("xlstm-1.3b", shape, False)
    full = dryrun.run_cell("xlstm-1.3b", shape, False, n_units=6)
    assert got["cost_mode"] == "extrapolated(k=(0,1),units=6,unit=8)"
    assert full["cost_mode"] == "full"
    assert got["memory"]["argument_bytes"] == full["memory"]["argument_bytes"]
    assert got["model_flops"] == full["model_flops"]
    for key, want in full["cost"].items():
        assert got["cost"][key] == pytest.approx(want, rel=1e-12), key
    assert got["collectives"] == full["collectives"]


# -- the CLI ----------------------------------------------------------------------------

CLI_CELLS = """
import json, sys
from repro_torch.launch import dryrun, mesh as M
M.make_production_mesh = lambda multi_pod=False, device_type=None: M.make_mesh(
    (2, 4), ("data", "model"), device_type)
build = dryrun.build_cell
dryrun.build_cell = lambda *args, **kwargs: build(*args, **{**kwargs, "n_units": 1})
out = sys.argv[1]
codes = [dryrun.main(["--arch", a, "--shape", s, "--out", out]) for a, s in
         [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
          ("qwen3-1.7b", "decode_32k"), ("qwen3-1.7b", "long_500k"),
          ("qwen3-1.7b", "train_4k")]]
codes.append(dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k", "--out", out,
                          "--variant", "seq_shard"]))
print("CODES " + json.dumps(codes))
"""
# the reference's record keys, where the port has ``trace_s`` in place of
# ``lower_s``/``compile_s`` and no ``collectives_scanned`` (the port counts
# the program it runs, at full depth)
RECORD_KEYS = {"arch", "shape", "mesh", "cell", "variant", "n_params", "mesh_shape", "seq",
               "batch", "kind", "memory", "cost", "collective_bytes", "collectives",
               "cost_mode", "status", "total_s", "trace_s", "model_flops",
               "param_bytes_per_device"}


def test_cli_cells_of_each_kind_on_a_small_mesh(tmp_path):
    """``main`` in a subprocess with a (2, 4) mesh swapped in and the depth
    cut to one layer: a train, a prefill and a decode cell at production
    widths are ``ok`` with the reference's record keys, collective bytes
    and a peak above the arguments, and the train cell's parameter bytes
    the JAX resolver's on (2, 4); ``long_500k`` of a full-attention arch is
    skipped with the reference's reason; ``seq_shard`` reshards through
    all-to-all (DTensor's choice on the cards' mesh type)."""
    r = subprocess.run([sys.executable, "-c", CLI_CELLS, str(tmp_path)], capture_output=True,
                       text=True, env=_env(), timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.split("CODES ", 1)[1]) == [0] * 6

    def read(name):
        with open(tmp_path / f"{name}.json") as f:
            return json.load(f)

    for shape, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                        ("decode_32k", "decode")):
        rec = read(f"qwen3-1.7b__{shape}__single")
        keys = RECORD_KEYS | ({"microbatches", "opt_bytes_per_device"} if kind == "train"
                              else set())
        assert set(rec) == keys, (shape, set(rec) ^ keys)
        assert rec["status"] == "ok" and rec["kind"] == kind and rec["mesh_shape"] == [2, 4]
        assert rec["collective_bytes"] > 0 and rec["cost"]["flops"] > 0
        assert rec["memory"]["peak_bytes_per_device"] > rec["memory"]["argument_bytes"] > 0
        assert rec["collective_bytes"] == sum(v["bytes"] for v in rec["collectives"].values())
    train = read("qwen3-1.7b__train_4k__single")
    params, opt, flops = _jax_shard_bytes("qwen3-1.7b", "", None, n_units=1,
                                          mesh_shape=((2, 4), ("data", "model")))
    assert (train["param_bytes_per_device"], train["opt_bytes_per_device"]) == (params, opt)
    assert train["model_flops"] == flops
    skip = read("qwen3-1.7b__long_500k__single")
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]
    seq = read("qwen3-1.7b__train_4k__single__seq_shard")
    assert seq["status"] == "ok" and seq["collectives"]["all-to-all"]["count"] > 0


def test_all_resumes_over_written_cells(tmp_path):
    """``--all`` skips every cell whose file says ``ok`` or ``skipped`` and
    runs (in a subprocess each) the missing ones and the one that errored:
    here three skip cells, so nothing is placed."""
    rerun = {"qwen3-1.7b__long_500k__single", "qwen3-1.7b__long_500k__multi",
             "phi4-mini-3.8b__long_500k__single"}
    for arch, shape, mesh in dryrun.all_cells():
        cid = dryrun._cell_id(arch, shape, mesh)
        if cid in rerun and cid.startswith("qwen3"):
            continue
        status = "error" if cid in rerun else "ok"
        (tmp_path / f"{cid}.json").write_text(json.dumps({"status": status, "mark": 1}))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                        "--out", str(tmp_path)], capture_output=True, text=True, env=_env(),
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    ran = {line.split("] ", 1)[1] for line in r.stdout.splitlines()
           if line.startswith("[dryrun] ") and " x " in line}
    assert ran == {c.replace("__", " x ") for c in rerun}
    assert "failures=0" in r.stdout
    for path in tmp_path.iterdir():
        rec = json.loads(path.read_text())
        if path.stem in rerun:
            assert rec["status"] == "skipped" and "mark" not in rec
        else:
            assert rec == {"status": "ok", "mark": 1}


# -- remat ------------------------------------------------------------------------------

def _lm_pair(arch):
    from repro.configs import get_arch as jax_get_arch
    from repro.models.lm import LM as JaxLM
    from repro.nn.types import split

    jspec = jax_get_arch(arch).smoke_spec_fn()
    jmodel = JaxLM(jspec)
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    return jmodel, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_remat_changes_no_bit_and_matches_jax(arch):
    """The smoke train step's loss and every gradient with remat off, on
    and ``"dots"`` are equal bits (zamba2: the weight-shared layer
    recomputed like the others), and equal to ``jax.value_and_grad`` of the
    reference's step (remat on, its default) to ``REL``; ``"dots"`` keeps
    the layers' matrix products (the backward recomputes no ``mm``, where
    full remat recomputes them all); ``scan_layers`` changes nothing; a
    forward without grad recomputes nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro.train import step as jstep
    from repro_torch.convert import lm_from_jax, lm_tree_from_jax
    from repro_torch.train import step as tstep

    jmodel, jparams, nparams = _lm_pair(arch)
    base = get_arch(arch).smoke_spec_fn()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, base.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, base.vocab, (2, 16)).astype(np.int32)
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}

    class MMs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    got = {}
    for name, fields in {"off": dict(remat=False), "on": dict(remat=True),
                         "dots": dict(remat=True, remat_policy="dots"),
                         "unscanned": dict(remat=True, scan_layers=False)}.items():
        tmodel = lm_from_jax(dataclasses.replace(base, **fields), nparams, device="cpu")
        with MMs() as mms:
            loss, grads = tstep.value_and_grad(tstep.make_loss_fn(tmodel),
                                               tstep.param_dict(tmodel), tb)
        got[name] = (loss, grads, mms.n)
    for name in ("on", "dots", "unscanned"):
        assert torch.equal(got[name][0], got["off"][0]), name
        for k, g in got["off"][1].items():
            assert torch.equal(got[name][1][k], g), (name, k)
    assert got["off"][2] == got["dots"][2] < got["on"][2] == got["unscanned"][2]

    jl, jg = jax.value_and_grad(jstep.make_loss_fn(jmodel))(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    loss, grads, _ = got["on"]
    assert abs(float(loss) - float(jl)) < REL * abs(float(jl))
    want = lm_tree_from_jax(base, jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    floor = 1e-3 * max(float(v.abs().max()) for v in want.values())
    for k, w in want.items():
        err = float((grads[k].double() - w.double()).abs().max())
        assert err < REL * max(float(w.abs().max()), floor), k

    tmodel = lm_from_jax(base, nparams, device="cpu")
    with torch.no_grad(), MMs() as plain:
        tmodel(tb["tokens"])
    with torch.enable_grad(), MMs() as graded:
        tmodel(tb["tokens"])
    assert plain.n == graded.n > 0


# -- the decode path's sharded pieces -------------------------------------------------------

def test_decode_partials_combine_to_the_softmax():
    """One query over a cache cut into 4 parts along its sequence: each
    part's ``decode_partials``, rescaled to the global max by
    ``combine_partials`` and summed, give ``grouped_attention``'s output
    (a part entirely masked included)."""
    from repro_torch.nn import attention as attn

    rng = np.random.default_rng(3)
    b, h, kh, t, dh = 2, 8, 2, 64, 16
    q = torch.from_numpy(rng.standard_normal((b, 1, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, kh, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, kh, dh)).astype(np.float32))
    valid = torch.arange(t)[None] <= torch.tensor([[40], [10]])
    want = attn.grouped_attention(q, k, v, valid[:, None, None, None, :], 0.25)
    parts = [attn.decode_partials(q, k[:, i:i + 16], v[:, i:i + 16], valid[:, i:i + 16], 0.25)
             for i in range(0, t, 16)]
    m_max = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    scaled = [attn.combine_partials(m_max, m, l_sum, o) for m, l_sum, o in parts]
    l_all = sum(l_sum for l_sum, _ in scaled)
    o_all = sum(o for _, o in scaled)
    got = (o_all / l_all.permute(0, 3, 1, 2, 4)).reshape(b, 1, h, dh)
    assert float((got - want).abs().max()) < 1e-6 * float(want.abs().max())


def test_write_at_and_unflatten_on_a_fake_mesh(fake_group):
    """On a (2, 4) fake mesh (rank 0): ``write_at`` writes a position into
    the local shard of a sequence-sharded buffer only where this rank holds
    it, and ``unflatten`` replicates a dim whose leading size does not
    split over its shards; on plain tensors both are the plain ops."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.api import unflatten, write_at
    from repro_torch.launch import mesh as mesh_lib

    fake_group(8)
    mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), "cpu")
    buf = distribute_tensor(torch.zeros(4, 16, 3), mesh, [Shard(0), Shard(1)],
                            src_data_rank=None)
    for pos, hit in ((2, True), (9, False)):
        write_at(buf, 1, pos, torch.full((4, 3), float(pos)))
        assert buf.to_local().shape == (2, 4, 3)
        assert bool((buf.to_local()[:, pos % 4] == pos).all()) == hit
    assert int((buf.to_local() != 0).sum()) == 2 * 3
    plain = torch.zeros(4, 16, 3)
    write_at(plain, 1, 9, torch.ones(4, 3))
    assert torch.equal(plain.nonzero()[:, 1].unique(), torch.tensor([9]))

    x = distribute_tensor(torch.zeros(2, 8), mesh, [Replicate(), Shard(1)], src_data_rank=None)
    assert tuple(unflatten(x, -1, (4, 2)).placements) == (Replicate(), Shard(1))
    assert tuple(unflatten(x, -1, (2, 4)).placements) == (Replicate(), Replicate())
    assert unflatten(torch.arange(8), 0, (2, 4)).tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
