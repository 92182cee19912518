"""The port's copies of the JAX package's examples (``examples/torch/``)
held to the reference scripts on the CPU at small sizes: quickstart's
facade and hand-wired trials and its winner's output; Listing 3's study
(``nas_conv1d``) from the reference's initial weights with the latency
pinned; ``nas_parallel --tiny`` serial against threads and against the
reference's sampled candidates; ``train_lm``'s losses step for step and a
resume from a checkpoint the reference's state was written into;
``elastic_restart``'s two phases.  The scripts that generate through
``XLAGenerator`` run in a process of their own
(``torch_examples_reference.py``); every run works in ``tmp_path``.
Each example refuses to run without a card unless asked for the CPU.
Also the facade's top-level names, which the examples import, against
the reference's ``repro/__init__.py``, resolved lazily."""
import ast
import importlib.util
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from test_torch_proxies import _jax_weights  # noqa: E402

from repro_torch.convert import candidate_from_jax, lm_from_jax, lm_tree_from_jax, opt_state_from_jax  # noqa: E402
from repro_torch.evaluation.api import Estimator  # noqa: E402
from repro_torch.evaluation.estimators import TrainedAccuracyEstimator  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
NAMES = ("quickstart", "nas_conv1d", "nas_parallel", "train_lm", "elastic_restart")
REFERENCE_RUNNER = Path(__file__).resolve().parent / "torch_examples_reference.py"
LATENCY_S = 0.0625  # both packages' pinned latency: above the 0.050 s soft limit
LOSS_REL = 1e-5


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port(name: str):
    return _load(EXAMPLES / "torch" / f"{name}.py", f"port_example_{name}")


def reference(name: str):
    return _load(EXAMPLES / f"{name}.py", f"reference_example_{name}")


def _reference_constant(name: str, constant: str):
    """A YAML string constant of a reference script, parsed."""
    for node in ast.parse((EXAMPLES / f"{name}.py").read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == constant:
            return yaml.safe_load(node.value.value)
    raise AssertionError(f"no {constant} in examples/{name}.py")


def _start_reference(tmp_path: Path, name: str, latency: str, *argv):
    """The reference script in a process of its own, working in its own
    directory (both packages write ``results/`` under the same names, and
    a study resumes from its storage file)."""
    cwd = tmp_path / "reference"
    cwd.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, str(REFERENCE_RUNNER), name, latency, *argv],
                            cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc) -> dict:
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def _trials(study):
    """Each trial as the reference runner prints it, without the facade's
    ``worker`` record (a process id and its running counts)."""
    return [{"number": t.number, "state": t.state.value, "params": t.params,
             "values": None if t.values is None else list(t.values),
             "user_attrs": {k: v for k, v in t.user_attrs.items() if k != "worker"},
             "intermediate": {str(k): v for k, v in t.intermediate.items()}}
            for t in study.trials]


def _rel(a, b):
    return abs(a - b) / abs(b)


# -- the documents the examples carry as mappings --------------------------------------

@pytest.mark.parametrize("name, constant, source", [
    ("quickstart", "QUICKSTART", None),
    ("nas_conv1d", "SPACE", "SPACE_YAML"),
    ("nas_parallel", "SPACE", "SPACE_YAML"),
    ("nas_parallel", "TINY_SPACE", "TINY_SPACE_YAML"),
])
def test_mappings_equal_the_references_yaml(name, constant, source):
    """The card's machine has no PyYAML, so the examples carry the
    reference's YAML as mappings: each equals the YAML it stands for."""
    if source is None:
        want = yaml.safe_load((EXAMPLES / "experiments" / "quickstart.yaml").read_text())
    else:
        want = _reference_constant(name, source)
    assert getattr(port(name), constant) == want


# -- the facade's top-level names ------------------------------------------------------

def test_top_level_names_are_the_references():
    """``from repro_torch import Explorer`` and the reference's other ten
    top-level names: each is the object of its module (``register_component``
    is the registry's ``register``, which ``register`` also names), and
    ``__all__`` and ``dir()`` are the reference's."""
    import repro_torch
    from repro_torch.explorer import experiment, explorer, registry, sweep

    want = {"Explorer": explorer.Explorer, "ExplorationReport": explorer.ExplorationReport,
            "ExperimentSpec": experiment.ExperimentSpec,
            "ExperimentError": experiment.ExperimentError,
            "ExplorerError": registry.ExplorerError,
            "UnknownComponentError": registry.UnknownComponentError,
            "register_component": registry.register, "SweepSpec": sweep.SweepSpec,
            "SweepReport": sweep.SweepReport, "SweepError": sweep.SweepError,
            "run_sweep": sweep.run_sweep}
    for name, obj in want.items():
        assert getattr(repro_torch, name) is obj, name
    assert repro_torch.register is registry.register  # answers, outside __all__
    reference = ast.parse((ROOT / "src" / "repro" / "__init__.py").read_text())
    exports = next(node.value for node in reference.body if isinstance(node, ast.Assign)
                   and node.targets[0].id == "_EXPORTS")
    assert repro_torch.__all__ == sorted(ast.literal_eval(exports)) == sorted(want)
    assert dir(repro_torch) == repro_torch.__all__
    with pytest.raises(AttributeError, match="no attribute 'Nope'"):
        repro_torch.Nope  # noqa: B018


def test_importing_a_subpackage_leaves_the_facade_out():
    """The top-level names are resolved when first asked for (PEP 562):
    ``import repro_torch.kernels`` imports no explorer module; asking for
    ``repro_torch.Explorer`` does."""
    code = (
        "import sys, repro_torch.kernels\n"
        "print(any(m.startswith('repro_torch.explorer') for m in sys.modules))\n"
        "from repro_torch import Explorer, ExperimentSpec, run_sweep, register\n"
        "print('repro_torch.explorer.explorer' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "True"]


# -- quickstart -------------------------------------------------------------------------

def test_quickstart_matches_the_reference(tmp_path, monkeypatch, capsys):
    """The facade's trials and best trial (#8), ``hand_wired()``'s trials,
    each trial for trial the reference's; ``main`` prints the same best;
    the winner from the reference's weights gives the reference's output
    within 1e-5 of its largest value."""
    from repro.explorer.explorer import Explorer as JExplorer

    from repro_torch import Explorer

    monkeypatch.chdir(tmp_path)
    ex, ref = port("quickstart"), reference("quickstart")
    jx = JExplorer.from_yaml(ref.EXPERIMENT)
    jreport = jx.run(save_report=False)
    tx = Explorer.from_spec(ex.experiment("host_cpu"), device="cpu")
    treport = tx.run(save_report=False)
    assert _trials(tx.study) == _trials(jx.study)
    assert treport.best == jreport.best and treport.best["number"] == 8
    assert _trials(ex.hand_wired()) == _trials(ref.hand_wired())

    out = ex.main(["--device", "cpu"])
    assert out["best"] == jreport.best and out["target"] == "host_cpu"
    assert out["criteria_values"] == jreport.criteria_values
    assert "best score 65,276" in capsys.readouterr().out

    jm = jx.best_model()
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    want = np.asarray(jm.apply(params, jnp.ones((2, 256, 3))))
    got = ex.run_winner(candidate_from_jax(tx.best_model(), params, device="cpu"), "cpu")
    assert got.shape == want.shape == (2, 4)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- nas_conv1d (Listing 3) -------------------------------------------------------------

class JaxInitAccuracy(TrainedAccuracyEstimator):
    """The port's estimator from the reference's ``init(PRNGKey(0))``."""

    def _weights(self, candidate):
        return _jax_weights(candidate)


class PinnedLatency(Estimator):
    name = "latency_s"

    def estimate(self, candidate, context=None) -> float:
        return LATENCY_S


def test_nas_conv1d_matches_the_reference(tmp_path, monkeypatch):
    """``--trials 6 --train-steps 20`` with the reference's initial weights
    and both latencies pinned: each trial's parameters, state, reported
    values, recorded values and score, and so the best trial, are the
    reference's.  Then the winner deploys on ``host_cpu``."""
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.space import parse_search_space
    from repro_torch.hwgen.generator import TorchGenerator

    monkeypatch.chdir(tmp_path)
    proc = _start_reference(tmp_path, "nas_conv1d", str(LATENCY_S),
                            "--trials", "6", "--train-steps", "20")
    try:
        ex = port("nas_conv1d")
        space = parse_search_space(ex.SPACE)
        builder = ModelBuilder(space.input_shape, space.output_dim)
        generator = TorchGenerator("host_cpu")
        runner = ex.make_runner("host_cpu", 20, "cpu",
                                accuracy=JaxInitAccuracy(steps=20, device="cpu"),
                                latency=PinnedLatency())
        study = ex.run_study(space, builder, runner, ex.make_data(), 6,
                             allowed=generator.supported_ops())
        deployed = ex.deploy(space, builder, generator, study.best_trial)
    finally:
        (want,) = _finish(proc)["studies"]
    assert _trials(study) == want
    assert (tmp_path / ex.STORAGE).is_file()
    assert deployed["latency_s"] > 0 and deployed["flops"] > 0 and deployed["fits_memory"]


# -- nas_parallel -------------------------------------------------------------------------

def test_nas_parallel_tiny_serial_threads_and_the_reference(tmp_path, monkeypatch, capsys):
    """``--tiny --trials 8 --workers 2``: the thread run's trials and best
    are the serial run's (the example's own assert), and each run samples
    the reference's candidates, ``n_params`` key for key.  The modelled
    latency is not the reference's (0.69-0.71x), so the best trials are
    printed side by side and held equal only where the two rankings
    agree."""
    monkeypatch.chdir(tmp_path)
    argv = ["--tiny", "--trials", "8", "--workers", "2"]
    proc = _start_reference(tmp_path, "nas_parallel", "-", *argv)
    try:
        ex = port("nas_parallel")
        args = ex.build_parser().parse_args(argv + ["--device", "cpu"])
        args.target = ex.default_target(args.device)
        sx, serial, px, par = ex.run(args)
        out = ex.summarize(args, serial, par)
    finally:
        _, jserial, jpar = _finish(proc)["studies"]
    assert out["serial"]["best"] == out["parallel"]["best"]
    assert "thread best #" in capsys.readouterr().out

    def sampled(trials):
        return [(t["number"], t["state"], t["params"], t["user_attrs"]["signature"],
                 t["user_attrs"]["n_params"]) for t in trials]

    for study, jtrials in ((sx.study, jserial), (px.study, jpar)):
        ours = _trials(study)
        assert sampled(ours) == sampled(jtrials)
        rank = [t["number"] for t in sorted(ours, key=lambda t: t["values"][0])]
        jrank = [t["number"] for t in sorted(jtrials, key=lambda t: t["values"][0])]
        print(f"best: port #{rank[0]}, reference #{jrank[0]}; rankings "
              f"{'agree' if rank == jrank else 'differ'}: {rank} vs {jrank}")
        if rank == jrank:
            assert study.best_trial.number == jrank[0]


# -- train_lm -----------------------------------------------------------------------------

TRAIN_ARGV = ["--steps", "4", "--seq", "32", "--batch", "2"]


@pytest.fixture(scope="module")
def reference_train_lm(tmp_path_factory):
    """The reference script's losses at ``TRAIN_ARGV``, its initial
    weights, and its state after step 2, recorded around its jitted step."""
    ref = reference("train_lm")
    losses, states = [], {}
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "train_step":
            return compiled

        def step(*a, **k):
            out = compiled(*a, **k)
            losses.append(float(out[2]["loss"]))
            if len(losses) == 2:
                states["params"], states["opt"] = jax.tree_util.tree_map(np.asarray, out[:2])
            return out
        return step

    from repro.models.lm import LM as JLM
    from repro.nn.types import split

    params, _ = split(JLM(ref.model_spec(False)).init(jax.random.PRNGKey(0), dtype=jnp.float32))
    work = tmp_path_factory.mktemp("reference_train_lm")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setattr(jax, "jit", recording_jit)
        mp.setattr(sys, "argv", ["train_lm.py", *TRAIN_ARGV, "--ckpt-dir", str(work / "ckpt")])
        runpy.run_path(str(EXAMPLES / "train_lm.py"), run_name="__main__")
    assert len(losses) == 4
    return {"losses": losses, "init": jax.tree_util.tree_map(np.asarray, params), **states}


def test_train_lm_losses_match_the_reference(reference_train_lm, tmp_path, capsys):
    """The demo model from the reference's initial weights: each of the 4
    steps' losses within 1e-5 relative of the reference's."""
    ex = port("train_lm")
    spec = ex.model_spec(False)
    args = ex.build_parser().parse_args(TRAIN_ARGV + ["--device", "cpu",
                                                      "--ckpt-dir", str(tmp_path / "ckpt")])
    out = ex.train(args, model=lm_from_jax(spec, reference_train_lm["init"], device="cpu"))
    assert out["start_step"] == 0 and sorted(out["losses"]) == [1, 2, 3, 4]
    for step, want in enumerate(reference_train_lm["losses"], start=1):
        assert _rel(out["losses"][step], want) <= LOSS_REL, (step, out["losses"][step], want)
    assert f"model lm-demo: {out['n_params']:,} params" in capsys.readouterr().out


def test_train_lm_resumes_from_a_checkpoint_the_reference_wrote(reference_train_lm, tmp_path,
                                                                capsys):
    """The reference's state after step 2, in the port's layout, saved by
    the reference's ``Checkpointer``: the port resumes from step 2 and its
    steps 3 and 4 give the reference's uninterrupted losses (both on the
    schedule of ``--steps 4``)."""
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer

    ex = port("train_lm")
    spec = ex.model_spec(False)
    ref = reference_train_lm
    opt = opt_state_from_jax(spec, ref["opt"], device="cpu")
    tree = {"params": {k: v.numpy() for k, v in lm_tree_from_jax(spec, ref["params"],
                                                                 device="cpu").items()},
            "opt": {"step": np.asarray(int(opt["step"]), np.int32),
                    "mu": {k: v.numpy() for k, v in opt["mu"].items()},
                    "nu": {k: v.numpy() for k, v in opt["nu"].items()}}}
    ckpt = tmp_path / "ckpt"
    JCheckpointer(str(ckpt)).save(2, jax.tree_util.tree_map(jnp.asarray, tree))
    args = ex.build_parser().parse_args(TRAIN_ARGV + ["--device", "cpu", "--ckpt-dir", str(ckpt)])
    out = ex.train(args)
    assert out["start_step"] == 2 and sorted(out["losses"]) == [3, 4]
    assert "resumed from step 2" in capsys.readouterr().out
    for step in (3, 4):
        assert _rel(out["losses"][step], ref["losses"][step - 1]) <= LOSS_REL


# -- elastic_restart -----------------------------------------------------------------------

def test_elastic_restart_matches_the_reference(tmp_path, monkeypatch):
    """From the reference's initial weights: both phases' losses within
    1e-5 relative of the reference's, the restart at step 10, the restored
    parameters equal to the saved ones bit for bit, and no process group
    left."""
    import torch.distributed as dist

    monkeypatch.chdir(tmp_path)
    ref = reference("elastic_restart")
    losses = []
    real_jit = jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "train_step":
            return compiled

        def step(*a, **k):
            out = compiled(*a, **k)
            losses.append(float(out[2]["loss"]))
            return out
        return step

    _, _, params, _, _ = ref.build()
    params = jax.tree_util.tree_map(np.asarray, params)
    monkeypatch.setattr(jax, "jit", recording_jit)
    ref.main()
    monkeypatch.setattr(jax, "jit", real_jit)
    assert len(losses) == 20

    ex = port("elastic_restart")
    out = ex.run("cpu", ckpt_dir=str(tmp_path / "port_ckpt"),
                 weights=lambda spec: lm_from_jax(spec, params, device="cpu"), log=lambda s: None)
    assert out["restart_step"] == 10
    assert out["mesh_a"] == out["mesh_b"] == {"data": 1, "model": 1}
    assert _rel(out["loss_a"], losses[9]) <= LOSS_REL
    assert _rel(out["loss_b"], losses[19]) <= LOSS_REL
    assert out["saved"].keys() == out["restored"].keys()
    assert all(torch.equal(out["saved"][k], out["restored"][k]) for k in out["saved"])
    assert not dist.is_initialized()


# -- without a card -------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_examples_refuse_without_a_card(name, tmp_path, monkeypatch):
    """Without ``--device cpu`` each example runs on the card, and without
    one it refuses (no quiet fallback to the CPU)."""
    from repro_torch.device import NoCudaCardError

    if torch.cuda.is_available():
        pytest.skip("checks the machine without a card")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NoCudaCardError):
        port(name).main([])
