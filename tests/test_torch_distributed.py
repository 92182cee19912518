"""Sharded training of the port against its unsharded path and the JAX
package, on the CPU.

One spawn per file: four gloo ranks run the port's checks on a (2, 2)
and a (4, 1) ``DeviceMesh`` while one process runs the JAX package on 4
spoofed host devices (``tests/torch_distributed_worker.py``); each has
its own time limit and a hung collective fails at the process group's
timeout.  The inputs (the JAX qwen3 smoke weights, batches, gradients)
are drawn here with numpy and shared through files.

Held: the qwen3 smoke model's 3 AdamW steps on (2, 2) (losses,
parameters, the first moment) against the port's unsharded steps and
the JAX step on a (2, 2) mesh, at ``test_torch_train.py``'s tolerances;
parameters and optimizer state as DTensors with the resolved placements,
each rank's shard the JAX device's; the train CLI on the mesh against
the plain CLI; its checkpoint restored on (4, 1) and in one process;
dbrx smoke's loss with and without ``shard_ff`` and a ``seq_shard``
forward against the unsharded ones; one step's gradients of five smoke
configs and one variant whose sharded paths differ against the unsharded
ones; ``compress_decompress`` on DTensors
and ``compressed_psum`` over 2 and 4 ranks bit for bit; ``elastic_remesh``
against the JAX one for worlds of 1 to 8; the production meshes' refusal
of a smaller world.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_from_jax, lm_tree_from_jax, port_names  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_distributed_worker.py")
sys.path.insert(0, str(WORKER.parent))
import torch_distributed_worker as W  # noqa: E402

TIMEOUT = 300  # seconds for each spawned process
REL = 1e-5  # a loss or a logit, of its max: fp32 sums in another order
STEP_REL = 1e-4  # parameters after 3 AdamW steps, of each tensor's max (test_torch_train)
GRAD_REL = 1e-4  # a gradient, of its max (the floor below): fp32 sums in another order
FLOOR = 1e-3  # a tensor whose max is below this share of its tree's is held to the share


def _close_trees(got, want, rel):
    floor = FLOOR * max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    errs = {k: float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))
                     .max()) / max(float(np.abs(want[k]).max()), floor) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] < rel, (worst, errs[worst])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _prefixed(npz, prefix):
    return {k[len(prefix) + 1:]: npz[k] for k in npz.files if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jax_get_arch
    from repro.models.lm import LM as JaxLM
    from repro.nn.types import split

    d = tmp_path_factory.mktemp("distributed")
    jspec = jax_get_arch("qwen3-1.7b").smoke_spec_fn()
    params, _ = split(JaxLM(jspec).init(jax.random.PRNGKey(0), dtype=jnp.float32))
    np.savez(d / "init.npz", **_flat(jax.tree_util.tree_map(np.asarray, params)))
    # the steps' batches are test_torch_train.py's (where STEP_REL was read):
    # AdamW's first update g / (|g| + eps) is ill-conditioned where |g| is
    # near eps, and a (4, 16) draw has a w_gate entry at |g| = 4.1e-9 that
    # puts even the two packages' unsharded steps 1.5e-4 apart
    vocab, dbrx_vocab = jspec.vocab, get_arch("dbrx-132b").smoke_spec_fn().vocab
    batches = {f"tokens_{i}": np.random.default_rng(10 + i).integers(0, vocab, (2, 16))
               .astype(np.int64) for i in range(W.STEPS)}
    rng = np.random.default_rng(0)
    batches["dbrx_tokens"] = rng.integers(0, dbrx_vocab, (4, 16)).astype(np.int64)
    batches["compress_g"] = (rng.standard_normal((6, 260)) * 3.0).astype(np.float32)
    np.savez(d / "batches.npz", **batches)

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}
    jax_env = {**env, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    cmds = {"jax": ([sys.executable, str(WORKER), "jax", str(d)], jax_env)}
    for r in range(4):
        cmds[f"gloo{r}"] = ([sys.executable, str(WORKER), "gloo", str(r), "4", str(d)], env)
    procs = {}
    for name, (cmd, e) in cmds.items():
        log = open(d / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, env=e, stdout=log, stderr=subprocess.STDOUT,
                                        cwd=str(d)), log)
    deadline = time.monotonic() + TIMEOUT
    failed = []
    try:
        for name, (proc, log) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = f"timed out after {TIMEOUT} s"
            if rc != 0:
                failed.append(name)
                for other, _ in procs.values():  # a rank lost: the others would hang
                    other.kill()
    finally:
        for proc, log in procs.values():
            proc.kill()
            proc.wait()
            log.close()
    if failed:
        pytest.fail("\n".join(f"{n}:\n{(d / f'{n}.log').read_text()[-3000:]}" for n in failed))
    return {"dir": d, "gloo": np.load(d / "gloo.npz"), "jax": np.load(d / "jax.npz"),
            "info": json.loads((d / "gloo.json").read_text()),
            "jax_info": json.loads((d / "jax.json").read_text()),
            "init": W.nested(dict(np.load(d / "init.npz"))),
            "batches": np.load(d / "batches.npz")}


def _unsharded_steps(runs):
    """The port's plain steps from the same weights and batches."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep

    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    model = lm_from_jax(spec, runs["init"], device="cpu")
    opt = topt.Optimizer(topt.OptimizerConfig(
        learning_rate=topt.cosine_schedule(*W.LR_STEPS), **W.OPT))
    fn = tstep.make_train_step(model, opt)
    params = tstep.param_dict(model)
    state = opt.init(params)
    losses = []
    for i in range(W.STEPS):
        params, state, m = fn(params, state,
                              {"tokens": torch.from_numpy(runs["batches"][f"tokens_{i}"])})
        losses.append(float(m["loss"]))
    return losses, {k: v.numpy() for k, v in params.items()}, {
        k: v.numpy() for k, v in state["mu"].items()}


def test_sharded_steps_match_the_unsharded_port(runs):
    losses, params, mu = _unsharded_steps(runs)
    got = runs["info"]["steps"]["losses"]
    assert np.allclose(got, losses, rtol=REL, atol=0), (got, losses)
    _close_trees(_prefixed(runs["gloo"], "steps"), params, STEP_REL)
    _close_trees(_prefixed(runs["gloo"], "mu"), mu, STEP_REL)


def test_sharded_steps_match_jax_on_a_2x2_mesh(runs):
    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    want = runs["jax_info"]["losses"]
    got = runs["info"]["steps"]["losses"]
    assert np.allclose(got, want, rtol=REL, atol=0), (got, want)
    for name in ("params", "mu"):
        jtree = lm_tree_from_jax(spec, W.nested(_prefixed(runs["jax"], name)), device="cpu")
        _close_trees(_prefixed(runs["gloo"], "steps" if name == "params" else "mu"),
                     {k: v.numpy() for k, v in jtree.items()}, STEP_REL)


def test_parameters_and_state_are_dtensors_sharded_as_the_jax_devices(runs):
    """After the steps every parameter, and AdamW's moments, is a DTensor
    with the placements the resolver gives on (2, 2); each rank's shard
    has the JAX device's shard shape; ``step`` is replicated; the module's
    parameters are the mapping's storage; the CLI's tree too."""
    from repro_torch.models.lm import LM

    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    model = LM(spec)
    want_specs = tsh.params_shardings(model, {"data": 2, "model": 2})
    jax_shards = {}
    for key, shard in runs["jax_info"]["shards"].items():
        names, stacked = port_names(model, tuple(key.split("/")))
        for n in names:
            jax_shards[n] = shard[1:] if stacked else shard
    info = runs["info"]
    for tree in (info["steps"]["params"], info["steps"]["mu"], info["steps"]["nu"],
                 info["cli"]["params"], info["cli"]["mu"]):
        assert set(tree) == set(want_specs)
        for k, v in tree.items():
            assert v["dtensor"], k
            assert tuple(tuple(e) if isinstance(e, list) else e for e in v["spec"]) == \
                tuple(want_specs[k]), k
            assert v["local"] == jax_shards[k], k
    sharded = [k for k, s in want_specs.items() if any(e is not None for e in s)]
    assert "embed" in sharded and len(sharded) > len(want_specs) // 2
    assert info["steps"]["step"] == {"value": 3, "replicated": True}
    assert info["steps"]["module_is_mapping"]


def _plain_cli(tmp_path):
    from repro_torch.launch import train as train_cli

    args = train_cli.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", str(W.STEPS), "--seq", "16",
         "--global-batch", "2", "--log-every", "100"])
    summary, state = train_cli.run(args)
    return summary, {k: v.numpy() for k, v in state["params"].items()}


def test_train_cli_on_the_mesh_matches_the_plain_cli(runs, tmp_path):
    summary, params = _plain_cli(tmp_path)
    got = runs["info"]["cli"]["losses"]
    assert np.allclose(got, summary["losses"], rtol=REL, atol=0), (got, summary["losses"])
    _close_trees(_prefixed(runs["gloo"], "cli"), params, STEP_REL)


def test_checkpoint_saved_on_2x2_restores_on_4x1_and_in_one_process(runs):
    """The CLI's checkpoint after step 3, saved from (2, 2): restored onto a
    (4, 1) mesh with its placements, and by one process without a mesh,
    each leaf equals the saved one."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models.lm import LM
    from repro_torch.train.step import param_dict

    saved = _prefixed(runs["gloo"], "cli")
    on41 = _prefixed(runs["gloo"], "restore41")
    assert set(on41) == set(saved)
    assert all(np.array_equal(on41[k], saved[k]) for k in saved)
    info = runs["info"]["restore41"]
    assert info["step"] == W.STEPS
    model = LM(get_arch("qwen3-1.7b").smoke_spec_fn())
    # the resolver's specs, less the size-1 model axis (placed as replicated)
    want = {k: tuple(None if e == "model" else e for e in s)
            for k, s in tsh.params_shardings(model, {"data": 4, "model": 1}).items()}
    for k, v in info["params"].items():
        assert v["dtensor"] and tuple(tuple(e) if isinstance(e, list) else e
                                      for e in v["spec"]) == want[k], k
    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    assert info["params"]["embed"] == {"dtensor": True, "spec": [None, "data"],
                                       "local": [spec.vocab, spec.d_model // 4]}

    like = {"params": {k: torch.zeros(v.shape) for k, v in saved.items()}}
    like["opt"] = {"mu": dict(like["params"]), "nu": dict(like["params"]),
                   "step": torch.zeros((), dtype=torch.int32)}
    step, restored = Checkpointer(str(runs["dir"] / "ckpt")).restore(like=like)
    assert step == W.STEPS and int(restored["opt"]["step"]) == W.STEPS
    assert all(torch.equal(restored["params"][k], torch.from_numpy(saved[k])) for k in saved)
    nu41 = _prefixed(runs["gloo"], "restore41_nu")
    assert all(np.array_equal(nu41[k], restored["opt"]["nu"][k].numpy()) for k in saved)
    assert set(param_dict(model)) == set(saved)


def test_dbrx_loss_with_and_without_shard_ff_matches_unsharded(runs):
    from repro_torch.models.lm import LM
    from repro_torch.train import step as tstep

    spec = get_arch("dbrx-132b").smoke_spec_fn()
    model = LM(spec).init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(runs["batches"]["dbrx_tokens"])
    want = float(tstep.make_loss_fn(model)(tstep.param_dict(model), {"tokens": tokens}))
    dbrx = runs["info"]["dbrx"]
    for shard_ff in ("False", "True"):
        assert abs(dbrx[shard_ff]["loss"] - want) < REL * abs(want), (shard_ff, want)
    w_up = [k for k in dbrx["True"]["params"] if k.endswith("inner.w_up")]
    assert w_up
    for k in w_up:
        assert dbrx["False"]["params"][k]["spec"] == ["model", "data", None]
        assert dbrx["True"]["params"][k]["spec"] == ["model", None, "data"]


def test_seq_shard_forward_matches_unsharded(runs):
    from repro_torch.models.lm import LM

    spec = W.with_attention(get_arch("qwen3-1.7b").smoke_spec_fn(), seq_shard=True)
    model = LM(spec).init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(torch.from_numpy(runs["batches"]["tokens_0"])).numpy()
    got = runs["gloo"]["seq_shard_logits"]
    assert np.abs(got - want).max() < REL * np.abs(want).max()


@pytest.mark.parametrize("name", W.GRAD_ARCHS)
def test_sharded_gradients_match_unsharded(runs, name):
    """One step's loss and gradients on (2, 2) against the unsharded ones,
    each gradient with its parameter's placements: configs whose sharded
    path runs other code than qwen3's (the attention core with one KV
    head, a sequence-sharded q, or KV heads that do not split where q's
    do; the SSD and mLSTM scans on local shards; MoE with a dense
    branch)."""
    got = runs["info"]["grads"][name]
    assert got["placed"]
    plain, mesh = got["loss"]
    assert abs(mesh - plain) < REL * abs(plain)
    _close_trees(_prefixed(runs["gloo"], f"grads/{name}/mesh"),
                 _prefixed(runs["gloo"], f"grads/{name}/plain"), GRAD_REL)


@pytest.mark.parametrize("arch", W.DECODE_ARCHS)
def test_sharded_decode_matches_unsharded(runs, arch):
    """Three decode steps on (2, 2) against the unsharded decode, the
    caches placed by their logical axes (the dry run's placement):
    attention's K/V with the sequence split over ``model`` (each new row
    written where its position lies, the softmax's parts combined by
    all-reduces), Mamba2's state with its heads split, whisper's cross
    K/V, the mLSTM and sLSTM states."""
    for i in range(W.DECODE_STEPS):
        want = runs["gloo"][f"decode/{arch}/{i}/plain"]
        got = runs["gloo"][f"decode/{arch}/{i}/mesh"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() < REL * np.abs(want).max(), (arch, i)


def test_compress_decompress_on_sharded_gradients_is_the_global_one(runs):
    """Sharded as (Shard(0), Shard(1)) on (2, 2), the quantized gradient and
    its error equal the unsharded ones bit for bit, and keep the
    gradient's placements."""
    from repro_torch.distributed.compression import GradientCompressor

    comp = GradientCompressor()
    g = {"g": torch.from_numpy(runs["batches"]["compress_g"])}
    out, err = comp.compress_decompress(g, comp.init_state(g))
    assert np.array_equal(runs["gloo"]["compress_out"], out["g"].numpy())
    assert np.array_equal(runs["gloo"]["compress_err"], err["g"].numpy())
    assert runs["info"]["compress"] == {"same": True}


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_jax_shard_map(runs, n):
    """Each rank's ``compressed_psum`` over a group of ``n`` equals the JAX
    package's inside ``shard_map`` on the same inputs, bit for bit."""
    checked = 0
    for r in range(4):
        got = np.load(runs["dir"] / f"psum{n}_rank{r}.npz")
        for k in W.PSUM_SHAPES:
            want = runs["jax"][f"psum{n}/{r}/{k}"]
            assert got[k].dtype == want.dtype and np.array_equal(got[k], want), (r, k)
            checked += 1
    assert checked == 4 * len(W.PSUM_SHAPES)


def test_elastic_remesh_matches_jax(runs, monkeypatch):
    """The mesh shape ``elastic_remesh`` picks for worlds of 1 to 8 (and
    ``min_model``) is the JAX package's; on the 4 gloo ranks it built the
    (1, 4) mesh."""
    import jax
    import torch.distributed as dist

    import repro.launch.mesh as jmesh
    from repro.distributed.fault import elastic_remesh as jax_remesh
    from repro_torch.distributed.fault import elastic_remesh
    from repro_torch.launch import mesh as tmesh

    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    monkeypatch.setattr(tmesh, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    for n in range(1, 9):
        monkeypatch.setattr(jax, "devices", lambda n=n: [None] * n)
        monkeypatch.setattr(dist, "get_world_size", lambda n=n: n)
        for pref, axes, min_model in (((16, 16), ("data", "model"), 1),
                                      ((2, 16, 16), ("pod", "data", "model"), 1),
                                      ((4, 6), ("data", "model"), 2)):
            assert elastic_remesh(pref, axes, min_model) == jax_remesh(pref, axes, min_model)
    assert runs["info"]["elastic"] == {"shape": [1, 4], "names": ["data", "model"]}


def test_production_meshes_refuse_a_smaller_world():
    """Over the fake process group: (16, 16) needs 256 ranks and (2, 16, 16)
    512, with the reference's message below; at their size they build, and
    in a larger world on its first ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    for world, multi, ok in ((255, False, False), (256, False, True), (300, False, True),
                             (256, True, False)):
        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        try:
            if ok:
                mesh = make_production_mesh(multi_pod=multi)
                assert tuple(mesh.shape) == (16, 16)
                assert mesh.mesh_dim_names == ("data", "model")
            else:
                n, shape = (512, r"\(2, 16, 16\)") if multi else (256, r"\(16, 16\)")
                with pytest.raises(RuntimeError,
                                   match=rf"need {n} devices for mesh {shape}, have {world}"):
                    make_production_mesh(multi_pod=multi)
        finally:
            dist.destroy_process_group()
