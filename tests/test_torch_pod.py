"""The H100 pod targets and the generator's sharded path against the JAX
package on the CPU: ``h100_pod``/``h100_2pod`` are ``tpu_v5e_pod``/
``tpu_v5e_2pod``'s meshes on the dry run's H100 constants; the sharded
generate (``TorchGenerator.generate(in_shardings=)``, the fake process
group, ``meta`` DTensors) against ``XLAGenerator.generate(in_shardings=)``
on a (2, 4) mesh of 8 spoofed devices for a dense, a MoE and a Mamba2
candidate of ``examples/torch/hw_in_loop_nas_lm.py``'s space at narrow
widths: per-device argument bytes equal XLA's ``argument_size_in_bytes``,
``model_flops`` equal, local FLOPs of one layer held to XLA's (XLA counts
a layer scan as one layer), collective bytes and peaks reported
(DTensor's and XLA's programs differ there); a candidate of each kind
counted at 1 and 2 layers and extrapolated equals its full count on the
256-card pod; the mode-2 study with argument bytes per token as its
objective gives the same trials and best trial in both packages; the
generator's group rules, and training on a real group after a generate;
and a sweep over ``[host_cpu, edge_npu, h100_pod]`` on the CPU."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.evaluation.model_flops import model_flops  # noqa: E402
from repro_torch.hwgen import sharded  # noqa: E402
from repro_torch.hwgen.generator import GeneratorError, TorchGenerator  # noqa: E402
from repro_torch.hwgen.roofline import roofline_terms  # noqa: E402
from repro_torch.hwgen.targets import H100, TargetSpec, get_target  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
# the example's space at narrow widths: the reference's choices cut
NARROW = {"d_models": (256, 512), "depths": (1, 2, 3), "vocab": 512}
BATCH, SEQ = 8, 128
CANDIDATES = {
    "dense": {"d_model": 512, "n_layers": 2, "block_kind": "dense", "ff_mult": 3},
    "moe": {"d_model": 256, "n_layers": 2, "block_kind": "moe", "experts": 8},
    "mamba2": {"d_model": 256, "n_layers": 3, "block_kind": "mamba2"},
}
STUDY_TRIALS = 6
MESH_2x4 = TargetSpec(name="mesh_2x4", chip=H100, mesh_shape=(2, 4),
                      mesh_axes=("data", "model"), measurement="roofline", device="cpu")


def _example():
    spec = importlib.util.spec_from_file_location(
        "hw_in_loop_nas_lm", ROOT / "examples" / "torch" / "hw_in_loop_nas_lm.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Fixed:
    """A trial that answers each suggestion from ``params``."""

    def __init__(self, params):
        self.wanted, self.params = params, {}

    def suggest_categorical(self, name, choices):
        assert self.wanted[name] in choices
        self.params[name] = self.wanted[name]
        return self.wanted[name]


@pytest.fixture(autouse=True)
def _no_group_left():
    """No test leaves a process group behind: a sharded generate ends the
    fake group it started."""
    import torch.distributed as dist

    yield
    left = dist.is_initialized() and dist.get_backend()
    if left:
        dist.destroy_process_group()
    assert not left, f"a {left} process group was left running"


def test_pod_targets_are_the_references_meshes_on_the_dry_runs_h100():
    """Meshes, axes and chip counts of ``tpu_v5e_pod`` and
    ``tpu_v5e_2pod``; the chip the dry run's roofline reads by default;
    counted on the host (roofline, device cpu) under their own mesh
    scopes; the TPU names still refused."""
    pytest.importorskip("jax")
    import inspect

    from repro.hwgen.targets import get_target as jax_target
    from repro_torch.explorer.experiment import ExperimentError, ExperimentSpec
    from repro_torch.hwgen.roofline import roofline_from_record

    for port, ref in (("h100_pod", "tpu_v5e_pod"), ("h100_2pod", "tpu_v5e_2pod")):
        t, r = get_target(port), jax_target(ref)
        assert (t.mesh_shape, t.mesh_axes, t.n_chips) == (r.mesh_shape, r.mesh_axes, r.n_chips)
        assert t.chip is H100 is inspect.signature(roofline_from_record).parameters["chip"].default
        assert (t.measurement, t.device, t.supports_pallas) == ("roofline", "cpu", True)
    scopes = {get_target(n).mesh_scope for n in ("h100", "host_cpu", "h100_pod", "h100_2pod")}
    assert len(scopes) == 4 and "mesh:16x16:data,model@cpu" in scopes
    raw = {"search_space": {"input": [2, 8], "output": 2,
                            "sequence": [{"block": "head", "op_candidates": "linear"}]},
           "criteria": [{"estimator": "flops"}]}
    assert ExperimentSpec.from_dict(dict(raw, target="h100_2pod")).target == "h100_2pod"
    with pytest.raises(ExperimentError, match="no TPU targets"):
        ExperimentSpec.from_dict(dict(raw, target="tpu_v5e_pod"))


JAX_POD = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import functools
import jax, jax.numpy as jnp
from repro.distributed.sharding import default_rules, shapes_shardings_from_axes
from repro.evaluation.model_flops import model_flops
from repro.hwgen.generator import XLAGenerator
from repro.hwgen.targets import TPU_V5E, TargetSpec
from repro.launch.mesh import make_mesh
from repro.models.lm import LM
from repro.models.specs import LayerSpec, ModelSpec, SubBlock, moe_layer, transformer_layer
from repro.nn.ssm import Mamba2Config
from repro.nn.types import split
from repro.search import Study, TPESampler

cfg = json.loads(sys.argv[1])
narrow, batch, seq = cfg["narrow"], cfg["batch"], cfg["seq"]
gen = XLAGenerator(TargetSpec(name="mesh_2x4", chip=TPU_V5E, mesh_shape=(2, 4),
                              mesh_axes=("data", "model"), measurement="roofline"))


def sample_spec(trial):
    # examples/hw_in_loop_nas_lm.py's, at narrow widths
    d_model = trial.suggest_categorical("d_model", narrow["d_models"])
    n_layers = trial.suggest_categorical("n_layers", narrow["depths"])
    kind = trial.suggest_categorical("block_kind", ["dense", "moe", "mamba2"])
    heads = max(d_model // 128, 1)
    if kind == "dense":
        ff_mult = trial.suggest_categorical("ff_mult", [3, 4])
        layer = transformer_layer(d_model, heads, max(heads // 2, 1), ff_mult * d_model)
    elif kind == "moe":
        experts = trial.suggest_categorical("experts", [8, 16])
        layer = moe_layer(d_model, heads, max(heads // 2, 1), 2 * d_model,
                          n_experts=experts, top_k=2)
    else:
        layer = LayerSpec(subs=(SubBlock("mamba2", Mamba2Config(d_model)),))
    return ModelSpec(name=f"nas-{kind}", d_model=d_model, vocab=narrow["vocab"],
                     layers=(layer,) * n_layers,
                     positional="none" if kind == "mamba2" else "rope")


def artifact(spec):
    # the example's pod branch
    model = LM(spec)
    annotated = jax.eval_shape(
        functools.partial(model.init, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    param_sds, axes = split(annotated)
    tokens = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    mesh = make_mesh(gen.target.mesh_shape, gen.target.mesh_axes)
    rules = default_rules(mesh)
    param_sh = shapes_shardings_from_axes(param_sds, axes, mesh, rules)
    tok_sh = shapes_shardings_from_axes({"t": tokens}, {"t": ("batch", None)}, mesh, rules)["t"]
    return gen.generate(lambda p, t: model.apply(p, t), (param_sds, tokens),
                        in_shardings=(param_sh, tok_sh))


class Fixed:
    def __init__(self, params):
        self.params = params

    def suggest_categorical(self, name, choices):
        return self.params[name]


def one_device_flops(spec):
    # the same forward compiled for one device, no shardings
    model = LM(spec)
    params, _ = split(jax.eval_shape(
        functools.partial(model.init, dtype=jnp.bfloat16), jax.random.PRNGKey(0)))
    tokens = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    cost = jax.jit(lambda p, t: model.apply(p, t)).lower(params, tokens).compile().cost_analysis()
    return (cost[0] if isinstance(cost, list) else cost)["flops"]


out = {"candidates": {}}
for name, params in cfg["candidates"].items():
    spec = sample_spec(Fixed(params))
    a = artifact(spec)
    one = sample_spec(Fixed(dict(params, n_layers=1)))
    out["candidates"][name] = {"memory": a.memory, "collective_bytes": a.collective_bytes,
                               "flops": a.flops, "flops_one_layer": artifact(one).flops,
                               "flops_one_layer_one_device": one_device_flops(one),
                               "model_flops": model_flops(spec, "prefill", batch, seq)}


def objective(trial):
    return artifact(sample_spec(trial)).memory["argument_bytes"] / (batch * seq)


study = Study(name="hil-lm", sampler=TPESampler(seed=0, n_startup=4))
study.optimize(objective, cfg["trials"])
out["study"] = {"trials": [[t.params, t.values] for t in study.trials],
                "best": study.best_trial.number}
print("POD " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_pod():
    """The JAX package's generator on the candidates and the study, in a
    subprocess with 8 spoofed host devices."""
    pytest.importorskip("jax")
    cfg = {"narrow": NARROW, "batch": BATCH, "seq": SEQ, "candidates": CANDIDATES,
           "trials": STUDY_TRIALS}
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_POD, json.dumps(cfg)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.split("POD ", 1)[1])


@pytest.mark.parametrize("kind", list(CANDIDATES))
def test_sharded_generate_argument_bytes_match_xla(kind, jax_pod):
    """One device's arguments on (2, 4), bf16 parameters sharded by the
    default rules and the int32 tokens over ``data``, equal XLA's
    ``argument_size_in_bytes`` exactly; ``model_flops`` equal.  The
    roofline is this artifact's counts against the target's chip; the peak
    includes the arguments and fits; collective bytes and peaks beside
    XLA's are printed, not matched."""
    ex = _example()
    gen = TorchGenerator(MESH_2x4)
    spec = ex.sample_spec(Fixed(CANDIDATES[kind]), **NARROW)
    artifact = gen.generate(*ex.sharded_program(spec, MESH_2x4, BATCH, SEQ))
    ref = jax_pod["candidates"][kind]
    assert artifact.memory["argument_bytes"] == ref["memory"]["argument_bytes"] > 0
    assert model_flops(spec, "prefill", BATCH, SEQ) == ref["model_flops"]
    assert artifact.roofline == roofline_terms(
        hlo_flops=artifact.flops, hlo_bytes=artifact.bytes_accessed,
        collective_bytes=artifact.collective_bytes, n_chips=1, chip=H100)
    assert artifact.memory["peak_bytes_per_device"] >= artifact.memory["argument_bytes"]
    assert artifact.fits_memory and artifact.flops > 0 and artifact.collective_bytes > 0
    print(json.dumps({kind: {
        "collective_bytes": [artifact.collective_bytes, ref["collective_bytes"]],
        "peak_bytes_per_device": [artifact.memory["peak_bytes_per_device"],
                                  ref["memory"]["peak_bytes_per_device"]],
        "flops": [artifact.flops, ref["flops"]]}}))


MESH_1x1 = dataclasses.replace(MESH_2x4, name="mesh_1x1", mesh_shape=(1, 1))
# the port's FLOPs are torch.utils.flop_counter's (matrix products and
# attention); XLA's cost analysis also counts elementwise ops
ONE_DEVICE_FLOPS_REL = 0.03
# on (2, 4) XLA's partitioned forward of the dense candidate does 6% more
# than an eighth of its one-device forward; DTensor's does an eighth exactly
DENSE_2x4_FLOPS_REL = 0.10


@pytest.mark.parametrize("kind", list(CANDIDATES))
def test_sharded_generate_flops_per_layer_match_xla(kind, jax_pod):
    """Local FLOPs against XLA's, one layer at a time.  XLA's cost
    analysis counts the body of the JAX model's layer scan once, whatever
    the depth: its count of the candidate equals its count at one layer,
    where the port counts every layer.  At one layer: on one device each kind's FLOPs within
    ``ONE_DEVICE_FLOPS_REL`` below XLA's; on (2, 4) the dense candidate's
    within ``DENSE_2x4_FLOPS_REL`` of XLA's, and an eighth of the
    one-device count exactly (MoE's and Mamba2's printed)."""
    ex = _example()
    ref = jax_pod["candidates"][kind]
    assert ref["flops"] == pytest.approx(ref["flops_one_layer"], rel=0.01)
    one = ex.with_depth(ex.sample_spec(Fixed(CANDIDATES[kind]), **NARROW), 1)
    device = TorchGenerator(MESH_1x1).generate(*ex.sharded_program(one, MESH_1x1, BATCH, SEQ))
    local = TorchGenerator(MESH_2x4).generate(*ex.sharded_program(one, MESH_2x4, BATCH, SEQ))
    xla_device = ref["flops_one_layer_one_device"]
    assert (1 - ONE_DEVICE_FLOPS_REL) * xla_device <= device.flops <= xla_device
    if kind == "dense":
        assert local.flops == device.flops / 8
        assert local.flops == pytest.approx(ref["flops_one_layer"], rel=DENSE_2x4_FLOPS_REL)
    print(json.dumps({kind: {
        "one_device": [device.flops, xla_device],
        "one_layer_2x4": [local.flops, ref["flops_one_layer"]],
        "over_an_even_split": [local.flops * 8 / device.flops,
                               ref["flops_one_layer"] * 8 / xla_device]}}))


@pytest.mark.parametrize("kind", list(CANDIDATES))
def test_extrapolated_artifact_equals_the_full_count(kind):
    """On ``h100_pod`` (256 fake ranks), a candidate of each block kind at
    depth 5 counted at 1 and 2 layers and extrapolated: operations, bytes,
    collectives by kind, argument bytes and the peak equal the count of
    all 5 layers, whatever the process counted before (the counts leave
    out DTensor's one-time sharding propagation)."""
    ex = _example()
    gen = TorchGenerator(get_target("h100_pod"))
    spec = ex.with_depth(ex.sample_spec(Fixed(CANDIDATES[kind]), **NARROW), 5)
    full = gen.generate(*ex.sharded_program(spec, gen.target, 32, SEQ))
    got = ex.counted(gen, spec, 32, SEQ)
    for key in ("flops", "bytes_accessed", "collective_bytes", "collectives", "memory",
                "roofline"):
        assert getattr(got, key) == getattr(full, key), key
    again = gen.generate(*ex.sharded_program(spec, gen.target, 32, SEQ))
    assert (again.bytes_accessed, again.memory) == (full.bytes_accessed, full.memory)


def test_mode2_study_matches_jax(jax_pod):
    """The example's study (TPE seed 0, 4 startup trials) on (2, 4) at
    narrow widths with argument bytes per token as its objective, each
    candidate extrapolated from 1 and 2 layers: the JAX package's trial
    sequence, values and best trial."""
    ex = _example()
    gen = TorchGenerator(MESH_2x4)
    study = ex.run_study(gen, STUDY_TRIALS, BATCH, SEQ, log=lambda line: None,
                         value=lambda a: a.memory["argument_bytes"] / (BATCH * SEQ),
                         sample=lambda trial: ex.sample_spec(trial, **NARROW))
    ref = jax_pod["study"]
    assert [[t.params, list(t.values)] for t in study.trials] == ref["trials"]
    assert study.best_trial.number == ref["best"]
    assert len({json.dumps(t.params, sort_keys=True) for t in study.trials}) > 3


def test_one_group_a_process():
    """A sharded generate holds the fake group at its target's world for
    itself and ends it; a fake group of that world the caller runs is used
    and left running; any other group (a fake one of another world, a real
    one as ``train --mesh`` starts) is refused and left running."""
    import torch.distributed as dist

    ex = _example()
    spec = ex.sample_spec(Fixed(CANDIDATES["dense"]), **NARROW)
    wide = dataclasses.replace(MESH_2x4, name="mesh_4x4", mesh_shape=(4, 4))
    for target in (MESH_2x4, wide):
        TorchGenerator(target).generate(*ex.sharded_program(spec, target, BATCH, SEQ))
        assert not dist.is_initialized()
    sharded.start_fake_group(8)
    try:
        TorchGenerator(MESH_2x4).generate(*ex.sharded_program(spec, MESH_2x4, BATCH, SEQ))
        assert dist.get_backend() == "fake" and dist.get_world_size() == 8
        with pytest.raises(GeneratorError, match="fake process group of 8 ranks"):
            TorchGenerator(wide).generate(*ex.sharded_program(spec, wide, BATCH, SEQ))
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(GeneratorError, match="gloo process group"):
            TorchGenerator(MESH_2x4).generate(*ex.sharded_program(spec, MESH_2x4, BATCH, SEQ))
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_training_after_a_sharded_generate_runs_on_a_real_group():
    """After a study's generate on ``h100_pod`` (256 fake ranks) the same
    process trains sharded on a group whose collectives move data: ``train
    --mesh single`` starts gloo and refuses its one rank for 256 (a fake
    group left running would have let it train on collectives that move
    nothing), and ``train.run(mesh=)`` on a (1, 1) host mesh trains on
    gloo."""
    import math

    import torch.distributed as dist

    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh

    ex = _example()
    pod = TorchGenerator(get_target("h100_pod"))
    ex.counted(pod, ex.sample_spec(Fixed(CANDIDATES["dense"]), **NARROW), 32, SEQ)
    assert not dist.is_initialized()
    smoke = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--seq", "16",
             "--global-batch", "2", "--log-every", "100"]
    with pytest.raises(RuntimeError, match=r"need 256 devices for mesh \(16, 16\), have 1"):
        train_cli.main(smoke + ["--steps", "1", "--mesh", "single"])
    assert not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        summary, _ = train_cli.run(train_cli.build_parser().parse_args(smoke + ["--steps", "2"]),
                                   mesh=mesh)
        assert len(summary["losses"]) == 2 and math.isfinite(summary["final_loss"])
    finally:
        dist.destroy_process_group()


def test_sweep_over_the_pod_target_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.explorer sweep`` over ``[host_cpu, edge_npu,
    h100_pod]`` under ``--device cpu``: the pod cells count on the host
    under their own mesh scope, their modelled latency the roofline of
    the counted forward against the H100, nothing generated."""
    from repro_torch.explorer.__main__ import main
    from repro_torch.hwgen.generator import generate_call_count

    before = generate_call_count()
    assert main(["sweep", str(SRC / "repro_torch" / "experiments" / "sweep_small.yaml"),
                 "--axis", "targets=host_cpu,edge_npu,h100_pod", "--axis", "samplers=random",
                 "--trials", "3", "--device", "cpu", "--report-dir", str(tmp_path)]) == 0
    report = json.loads((tmp_path / "sweep-small.sweep.json").read_text())
    assert generate_call_count() == before
    cells = {c["axes"]["target"]: c for c in report["cells"]}
    assert set(cells) == {"host_cpu", "edge_npu", "h100_pod"}
    pod = cells["h100_pod"]
    assert pod["target"]["mesh_shape"] == [16, 16] and pod["target"]["device"] == "cpu"
    assert pod["states"] == {"complete": 3}
    assert pod["criteria_values"]["latency_s"] < cells["host_cpu"]["criteria_values"]["latency_s"]
