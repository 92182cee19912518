"""The port's sharding substrate against the JAX package on the CPU:
``model_flops`` of every config and shape cell, every parameter's logical
axes and the decode cache's, the resolver's ``PartitionSpec`` of every
leaf on the production meshes (16, 16) and (2, 16, 16), and each leaf's
local shard on a 256- and a 512-rank ``DeviceMesh`` over the fake process
group, against the JAX shard shape.  The JAX side resolves on an
``AbstractMesh``, so no device is spoofed; the port's models are laid out
on the meta device."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.convert import axes_from_jax, placements_from_jax, port_names  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.api import constrain, current_mesh, sharding_context  # noqa: E402
from repro_torch.evaluation.model_flops import active_matmul_params, model_flops  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.nn.types import param_axes, param_bytes, param_count  # noqa: E402

ARCHS = ("qwen3-1.7b", "phi4-mini-3.8b", "nemotron-4-340b", "qwen1.5-4b", "zamba2-2.7b",
         "xlstm-1.3b", "dbrx-132b", "arctic-480b", "paligemma-3b", "whisper-medium")
# (arch, MoEConfig.shard_ff): the ten configs, and the two MoE ones with 2D experts
VARIANTS = [(a, False) for a in ARCHS] + [("dbrx-132b", True), ("arctic-480b", True)]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _shard_ff(spec):
    """``spec`` with every MoE sub-block's ``shard_ff`` on (either package's
    dataclasses)."""
    def layers(ls):
        return tuple(dataclasses.replace(layer, subs=tuple(
            dataclasses.replace(s, cfg=dataclasses.replace(s.cfg, shard_ff=True))
            if s.kind == "moe" else s for s in layer.subs)) for layer in ls)

    return dataclasses.replace(spec, layers=layers(spec.layers))


def _specs(arch, shard_ff):
    from repro.configs import get_arch as jax_get_arch

    port, ref = get_arch(arch).spec(), jax_get_arch(arch).spec()
    return (_shard_ff(port), _shard_ff(ref)) if shard_ff else (port, ref)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch, shard_ff):
    """(the JAX ``LM``, value shapes, axes) of the full-size config."""
    import jax
    import jax.numpy as jnp

    from repro.models.lm import LM as JaxLM
    from repro.nn.types import split

    model = JaxLM(_specs(arch, shard_ff)[1])
    annotated = jax.eval_shape(functools.partial(model.init, dtype=jnp.float32),
                               jax.random.PRNGKey(0))
    values, axes = split(annotated)
    return model, values, axes


@functools.lru_cache(maxsize=None)
def _port_model(arch, shard_ff):
    return LM(_specs(arch, shard_ff)[0])


def _jax_named_shardings(arch, shard_ff, mesh_name):
    """The JAX resolver's tree of ``NamedSharding``s on an abstract
    production mesh."""
    from jax.sharding import AbstractMesh

    from repro.distributed.sharding import default_rules, shapes_shardings_from_axes

    _, values, axes = _jax_tree(arch, shard_ff)
    shape, names = MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    return shapes_shardings_from_axes(values, axes, mesh, default_rules(mesh))


def _jax_shardings(arch, shard_ff, mesh_name):
    """{port state-dict name: (JAX spec, JAX shard shape)} of every leaf on
    an abstract production mesh, the stacked layers dim dropped."""
    import jax

    _, values, _ = _jax_tree(arch, shard_ff)
    shardings = _jax_named_shardings(arch, shard_ff, mesh_name)
    model = _port_model(arch, shard_ff)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = tuple(str(p.key) for p in path)
        value = functools.reduce(lambda t, k: t[k], keys, values)
        spec, shard = tuple(sh.spec), tuple(sh.shard_shape(value.shape))
        names_, stacked = port_names(model, keys)
        if stacked:
            assert spec[0] is None
            spec, shard = spec[1:], shard[1:]
        for name in names_:
            out[name] = (spec, shard)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_jax(arch):
    """``active_matmul_params`` and ``model_flops`` equal the JAX package's
    exactly, for every shape cell the config supports (the long-context
    spec for ``long_500k``)."""
    from repro.configs import get_arch as jax_get_arch
    from repro.evaluation import model_flops as jmf

    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    counted = {}
    for cell in SHAPES.values():
        if not cfg.cell_supported(cell)[0]:
            continue
        spec, jspec = cfg.spec(cell.long_context), jcfg.spec(cell.long_context)
        if cell.long_context not in counted:
            counted[cell.long_context] = (active_matmul_params(spec),
                                          jmf.active_matmul_params(jspec))
            assert counted[cell.long_context][0] == counted[cell.long_context][1]
        got = model_flops(spec, cell.kind, cell.batch, cell.seq)
        assert got == jmf.model_flops(jspec, cell.kind, cell.batch, cell.seq), cell.name
        assert got > 0
    assert counted
    with pytest.raises(ValueError):
        model_flops(cfg.spec(), "serve", 1, 1)


@pytest.mark.parametrize("arch,shard_ff", VARIANTS,
                         ids=[a + ("-shard_ff" if f else "") for a, f in VARIANTS])
def test_param_axes_and_specs_match_jax(arch, shard_ff):
    """Every parameter's logical axes equal the JAX leaf's (through the
    converter's name map), as do the count and bytes; each leaf's
    ``PartitionSpec`` on (16, 16) and (2, 16, 16) equals the JAX
    resolver's; and ``cache_axes`` equals the JAX tree's."""
    from repro.nn.types import param_bytes as jax_bytes
    from repro.nn.types import param_count as jax_count

    jmodel, values, axes = _jax_tree(arch, shard_ff)
    model = _port_model(arch, shard_ff)
    got = param_axes(model)
    assert None not in got.values()
    assert got == axes_from_jax(model, axes)
    assert param_count(model) == jax_count(values)
    assert param_bytes(model) == jax_bytes(values)
    if shard_ff:
        moe = [k for k in got if k.endswith(("inner.w_up", "inner.w_gate"))]
        assert moe and all(got[k] == ("experts", None, "expert_mlp") for k in moe)
    for mesh_name, (shape, names) in MESHES.items():
        want = _jax_shardings(arch, shard_ff, mesh_name)
        specs = tsh.params_shardings(model, dict(zip(names, shape)))
        assert set(specs) == set(want)
        bad = {k: (s, want[k][0]) for k, s in specs.items() if tuple(s) != want[k][0]}
        assert not bad, (mesh_name, sorted(bad.items())[:5])
    if not shard_ff:
        _check_cache_axes(jmodel, values, model)


def _check_cache_axes(jmodel, values, model, batch=16, max_seq=64):
    """``cache_axes`` equals the JAX tree's, and ``shapes_shardings_from_axes``
    over a decode cache (laid out on meta) gives the JAX resolver's specs
    on (16, 16), the stacked layers dim dropped."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.distributed import sharding as jsh

    jcache = jmodel.cache_axes()
    keys, shared = [], iter(k for k in jcache if k.startswith("shared_"))
    for seg in model.segments:
        key = next(shared) if seg.kind == "shared" else seg.name
        keys += [(key, seg.kind == "stack")] * (1 if seg.kind == "shared" else seg.count)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    assert model.cache_axes() == [jax.tree_util.tree_map(tuple, jcache[k], is_leaf=is_axes)
                                  for k, _ in keys]
    shape, names = MESHES["single"]
    mesh = AbstractMesh(shape, names)
    jshapes = jax.eval_shape(lambda p: jmodel.init_cache(p, batch, max_seq), values)
    jspecs = jsh.shapes_shardings_from_axes(jshapes, jcache, mesh, jsh.default_rules(mesh))
    got = tsh.shapes_shardings_from_axes(model.init_cache(batch, max_seq), model.cache_axes(),
                                         dict(zip(names, shape)))
    for (key, stacked), layer in zip(keys, got, strict=True):
        for sub, leaves in layer.items():
            for leaf, spec in leaves.items():
                want = tuple(jspecs[key][sub][leaf].spec)
                assert tuple(spec) == (want[1:] if stacked else want), (key, sub, leaf)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_local_shards_on_a_fake_process_group_match_jax(mesh_name):
    """On a 256- (512-) rank ``DeviceMesh`` over the fake process group,
    each leaf of the twelve variants placed by :func:`placements` has the
    JAX shard shape locally (on the last rank), the converter's placements
    of the JAX specs are the same, and a spec round-trips through
    ``spec_of``."""
    import jax
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, names = MESHES[mesh_name]
    world = 1
    for n in shape:
        world *= n
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1, world_size=world)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        assert tsh.mesh_axes(mesh) == dict(zip(names, shape))
        checked = 0
        for arch, shard_ff in VARIANTS:
            want = _jax_shardings(arch, shard_ff, mesh_name)
            model = _port_model(arch, shard_ff)
            from_jax = placements_from_jax(model, jax.tree_util.tree_map(
                lambda sh: tuple(sh.spec), _jax_named_shardings(arch, shard_ff, mesh_name)),
                mesh)
            for key, spec in tsh.params_shardings(model, mesh).items():
                pl = tsh.placements(spec, mesh)
                assert from_jax[key] == pl, (arch, key)
                assert tsh.spec_of(pl, len(spec), mesh) == spec
                global_shape = tuple(model.get_parameter(key).shape)
                local, _ = compute_local_shape_and_global_offset(global_shape, mesh, pl)
                assert tuple(local) == want[key][1], (arch, key, spec)
                checked += 1
        assert checked > 1000
    finally:
        dist.destroy_process_group()


def test_resolver_reference_cases_and_placements():
    """The JAX package's resolver cases (divisibility fallback, no mesh axis
    twice, a multi-axis batch, leading dims padded) give the same specs;
    placements shard a dim over several mesh axes major first, replicate
    over a size-1 mesh dim, and refuse axes out of the mesh's order."""
    from jax.sharding import AbstractMesh

    from repro.distributed.sharding import default_rules as jax_rules
    from repro.distributed.sharding import partition_spec as jax_spec

    cases = [
        ({"data": 16, "model": 16}, {"embed": ("data",), "mlp": ("model",)},
         ("embed", "mlp"), (1024, 4096)),
        ({"data": 16, "model": 16}, {"kv_heads": ("model",), "embed": ("data",)},
         ("embed", "kv_heads"), (2048, 8)),
        ({"data": 4, "model": 4}, {"a": ("model",), "b": ("model",)}, ("a", "b"), (64, 64)),
        ({"pod": 2, "data": 16, "model": 16}, {"batch": ("pod", "data")},
         ("batch", None), (256, 4096)),
        ({"pod": 2, "data": 16, "model": 16}, {"batch": ("pod", "data")},
         ("batch", None), (24, 4096)),
    ]
    for sizes, rules, axes, shape in cases:
        mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        assert tuple(tsh.partition_spec(axes, shape, sizes, rules)) == tuple(
            jax_spec(axes, shape, mesh, rules))
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert tsh.default_rules(sizes) == jax_rules(AbstractMesh((2, 16, 16), tuple(sizes)))
    assert tsh.logical_to_spec(("embed",), (4, 32), sizes, tsh.default_rules(sizes)) == (
        None, "data")

    class Mesh:  # the fields placements() reads of a DeviceMesh
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    class Mesh1(Mesh):  # a size-1 mesh dim holds the whole tensor
        shape = (1, 16, 16)

    from torch.distributed.tensor import Replicate, Shard

    assert tsh.placements(tsh.PartitionSpec(("pod", "data"), "model"), Mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.placements(tsh.PartitionSpec(None, "data"), Mesh) == (
        Replicate(), Shard(1), Replicate())
    assert tsh.placements(tsh.PartitionSpec(("pod", "data"), "model"), Mesh1) == (
        Replicate(), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="not in the mesh's order"):
        tsh.placements(tsh.PartitionSpec(("data", "pod")), Mesh)


def test_constrain_is_the_identity_outside_a_context():
    """Outside a sharding context ``constrain`` returns its argument itself
    (no copy, no op); inside one a plain tensor is refused."""
    import torch.distributed as dist

    x = torch.randn(2, 3, 4)
    assert constrain(x, ("batch", None, None)) is x
    assert current_mesh() is None
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh("cpu")
        with sharding_context(mesh, tsh.default_rules(mesh)):
            assert current_mesh() is mesh
            with pytest.raises(TypeError, match="plain Tensor"):
                constrain(x, ("batch", None, None))
        assert current_mesh() is None and constrain(x, ("batch",)) is x
    finally:
        dist.destroy_process_group()
