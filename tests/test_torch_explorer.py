"""The port's Explorer facade against the JAX package's on the CPU: the
quickstart experiment's trials and best trial on every executor backend,
every example experiment's parsed spec or sweep (``remote.yaml``'s
``remote`` executor included), the pruners' decisions, kernel tuning
in search mode, the CLI, and the disk tier's toolchain salt; plus what is
the port's own (the device the facade runs on, a warm kernel-tuning run,
``chip_smoke.py``'s copies of the example documents)."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from repro_torch.explorer.experiment import (  # noqa: E402
    ExperimentError, ExperimentSpec, NotPortedError)
from repro_torch.explorer.explorer import Explorer  # noqa: E402
from repro_torch.explorer.registry import UnknownComponentError  # noqa: E402

EXPERIMENTS = Path(__file__).resolve().parents[1] / "examples" / "experiments"
QUICKSTART = EXPERIMENTS / "quickstart.yaml"


def _jax_explorer():
    pytest.importorskip("jax")
    from repro.explorer.experiment import ExperimentSpec as JSpec
    from repro.explorer.explorer import Explorer as JExplorer

    return JSpec, JExplorer


def _quickstart(tmp_path, backend, workers, trials):
    raw = yaml.safe_load(QUICKSTART.read_text())
    raw["executor"] = {"backend": backend, "n_workers": workers}
    raw["budget"] = {"n_trials": trials}
    raw["report_dir"] = str(tmp_path)
    return raw


def _trials(study):
    return [(t.number, t.state.value, t.params, t.values, t.user_attrs.get("signature"))
            for t in study.trials]


@pytest.mark.parametrize("backend, workers, trials", [
    ("serial", 1, 25), ("thread", 3, 12), ("process", 2, 6)])
def test_quickstart_matches_jax_on_every_backend(tmp_path, backend, workers, trials):
    """TPE seed 0 (history-consulting: the batch scheduler), flops + 0.1
    n_params: the same trials, in the same order, with the same values and
    the same best trial as the JAX package's facade on the same backend
    and worker count; process workers are spawned."""
    JSpec, JExplorer = _jax_explorer()
    raw = _quickstart(tmp_path, backend, workers, trials)
    jx = JExplorer(JSpec.from_dict(raw))
    jreport = jx.run(save_report=False)
    tx = Explorer(ExperimentSpec.from_dict(raw), device="cpu")
    treport = tx.run(save_report=False)
    assert _trials(tx.study) == _trials(jx.study)
    assert len(tx.study.trials) == trials
    assert treport.best == jreport.best
    assert treport.criteria_values == jreport.criteria_values
    assert treport.pareto_front == jreport.pareto_front
    assert treport.states == jreport.states and treport.device == "cpu"
    assert treport.kernel_launches == {}


@pytest.mark.parametrize("path", sorted(EXPERIMENTS.glob("*.yaml")), ids=lambda p: p.name)
def test_example_experiments_parse_as_in_jax_or_name_their_unported_section(path):
    """Every example parses as in the JAX package: an experiment to the same
    spec (``remote.yaml``'s ``remote`` executor and its worker pool
    included), a sweep to the same sweep spec (whose ``tpu_v5e`` cells the
    port, which has no TPU target, refuses at expansion).  No example names
    a section the port lacks any more."""
    raw = yaml.safe_load(path.read_text())
    JSpec, _ = _jax_explorer()
    if "base" in raw:
        from repro.explorer.sweep import SweepSpec as JSweepSpec
        from repro_torch.explorer.sweep import SweepError, SweepSpec

        sweep = SweepSpec.from_yaml(str(path))
        assert sweep.to_dict() == JSweepSpec.from_yaml(str(path)).to_dict()
        with pytest.raises(SweepError, match="target=tpu_v5e.*no TPU targets"):
            sweep.expand()
        return
    spec = ExperimentSpec.from_yaml(str(path))
    assert spec.to_dict() == JSpec.from_yaml(str(path)).to_dict()
    if path.name == "remote.yaml":
        assert spec.executor.backend == "remote"
        assert spec.executor.workers == ["127.0.0.1:7471", "127.0.0.1:7472"]


@pytest.mark.parametrize("section, value, item", [
    ("executor", {"backend": "remote", "workers": ["127.0.0.1:7471"]}, "item 12"),
])
def test_unported_sections_raise_a_named_not_implemented_error(section, value, item):
    """The section the port once refused (the ``remote`` executor, ROADMAP
    ``item``) now parses as in the JAX package and builds the port's remote
    executor; no refusal in the facade names the item any more."""
    import inspect

    from repro_torch.explorer import experiment, sweep
    from repro_torch.search.remote.executor import RemoteExecutor

    raw = yaml.safe_load(QUICKSTART.read_text())
    raw[section] = value
    spec = ExperimentSpec.from_dict(raw)
    JSpec, _ = _jax_explorer()
    assert spec.to_dict() == JSpec.from_dict(raw).to_dict()
    executor = spec.executor.build()
    assert isinstance(executor, RemoteExecutor) and executor.workers == value["workers"]
    for module in (experiment, sweep):
        assert item not in inspect.getsource(module)
    assert issubclass(NotPortedError, NotImplementedError)  # kept for item 13


def test_ported_sections_still_validate_eagerly():
    raw = yaml.safe_load(QUICKSTART.read_text())
    raw["executor"] = {"backend": "process", "options": {"mp_context": "fork"}}
    spec = ExperimentSpec.from_dict(raw)  # the option binds; the executor refuses it
    with pytest.raises(ValueError, match="CUDA does not survive a fork"):
        spec.executor.build()
    raw["executor"] = {"backend": "ray"}
    with pytest.raises(UnknownComponentError, match="process"):
        ExperimentSpec.from_dict(raw)


def test_explorer_runs_where_its_target_runs(tmp_path):
    """CUDA unless the caller asks for the CPU (a machine without a card
    refuses it), and the spec's target must run on the device asked for."""
    from repro_torch.device import NoCudaCardError

    raw = _quickstart(tmp_path, "serial", 1, 1)  # target host_cpu
    if torch.cuda.is_available():
        with pytest.raises(ExperimentError, match="host_cpu.*--device cpu"):
            Explorer.from_dict(raw)
    else:
        with pytest.raises(NoCudaCardError):
            Explorer.from_dict(raw)
    with pytest.raises(ExperimentError, match="h100.*--device cuda"):
        Explorer.from_dict(dict(raw, target="h100"), device="cpu")
    assert Explorer.from_dict(raw, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("pruner", [
    {"name": "median", "n_startup_trials": 3, "n_warmup_steps": 1},
    {"name": "successive_halving", "min_resource": 1, "reduction_factor": 2},
])
def test_pruners_make_the_same_decisions_as_jax(pruner):
    """The same reported values (seeded by the trial's sampled parameter)
    through both packages' studies with the same pruner: the same trials
    are pruned at the same steps."""
    pytest.importorskip("jax")
    from repro.search import samplers as jsamplers
    from repro.search import study as jstudy
    from repro.explorer.registry import PRUNERS as JPRUNERS
    from repro_torch.explorer.registry import PRUNERS as TPRUNERS
    from repro_torch.search import samplers as tsamplers
    from repro_torch.search import study as tstudy

    def run(samplers, study_mod, registry):
        options = {k: v for k, v in pruner.items() if k != "name"}
        study = study_mod.Study(name="prune", sampler=samplers.RandomSampler(seed=0),
                                pruner=registry.get(pruner["name"])(**options))

        def objective(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            for step in range(1, 9):
                value = x + 1.0 / step
                trial.report(step, value)
                if trial.should_prune():
                    raise study_mod.TrialPruned()
            return value

        study.optimize(objective, 16)
        return [(t.state.value, sorted(t.intermediate)) for t in study.trials]

    want = run(jsamplers, jstudy, JPRUNERS)
    got = run(tsamplers, tstudy, TPRUNERS)
    assert got == want
    assert any(state == "pruned" for state, _ in got)


SEARCH_SPACE = {
    "input": [8, 64], "output": 4,
    "sequence": [
        {"block": "mixer", "op_candidates": ["ssm", "attention"],
         "type_repeat": {"type": "vary_all", "depth": [1, 2]},
         "ssm": {"impl": ["pallas"], "d_state": [8], "d_head": [4], "expand": [2]},
         "attention": {"impl": ["pallas"], "heads": [2]}},
        {"block": "pool", "op_candidates": "global_avg_pool"},
        {"block": "head", "op_candidates": "linear", "linear": {"width": [8, 16]}},
    ],
}


def test_kernel_tuning_search_mode_matches_jax(tmp_path):
    """``kernel_tuning: search``: each discovered kernel's schedule fields
    become trial parameters (the port discovers on the meta device, the
    reference with ``jax.eval_shape``); with analytic criteria the two
    facades draw the same parameters, schedules included, and report the
    same best trial and its schedules."""
    JSpec, JExplorer = _jax_explorer()
    raw = {"name": "search", "search_space": SEARCH_SPACE,
           "sampler": {"name": "random", "seed": 1},
           "criteria": [{"estimator": "flops"}, {"estimator": "n_params", "weight": 0.5}],
           "kernel_tuning": {"mode": "search", "kernels": {"ssm_scan": {"chunk": 32}}},
           "budget": {"n_trials": 10}, "report_dir": str(tmp_path)}
    jx = JExplorer(JSpec.from_dict(raw))
    jreport = jx.run(save_report=False)
    tx = Explorer(ExperimentSpec.from_dict(raw), device="cpu")
    treport = tx.run(save_report=False)
    assert _trials(tx.study) == _trials(jx.study)
    assert any(name.startswith("schedule:flash_attention:")
               for t in tx.study.trials for name in t.params)
    assert treport.kernel_tuning["schedules"] == jreport.kernel_tuning["schedules"]
    assert treport.best == jreport.best


def test_cached_kernel_tuning_warm_run_tunes_and_measures_nothing(tmp_path):
    """``kernel_tuning: cached`` with measured latency on the host: the cold
    run tunes each (kernel, bucket) once and records the candidates; a
    second run on the same disk store tunes nothing, places no candidate,
    and reads every estimator value from disk; the best trial is the same."""
    from repro_torch.hwgen.generator import generate_call_count

    raw = {"name": "cached", "search_space": SEARCH_SPACE,
           "sampler": {"name": "random", "seed": 0},
           "criteria": [{"estimator": "latency_s", "params": {"batch": 2}}],
           "kernel_tuning": {"mode": "cached", "budget": 3}, "target": "host_cpu",
           "cache": {"dir": str(tmp_path / "cache")}, "budget": {"n_trials": 4},
           "report_dir": str(tmp_path)}
    cold = Explorer.from_dict(raw, device="cpu").run(save_report=False)
    kt = cold.kernel_tuning
    assert kt["tunes"] >= 1 and kt["records"]
    for record in kt["records"]:
        assert 1 <= record["n_candidates"] <= 3
        assert all(c["launched"] is None for c in record["candidates"])  # CPU
    before = generate_call_count()
    warm = Explorer.from_dict(raw, device="cpu").run(save_report=False)
    assert warm.kernel_tuning["tunes"] == 0 and warm.kernel_tuning["cache_hits"] >= 1
    assert warm.cache["misses"] == 0 and warm.cache["disk_hits"] >= 1
    assert generate_call_count() == before
    assert warm.best == cold.best
    assert warm.kernel_tuning["schedules"] == cold.kernel_tuning["schedules"]


def test_cli_reaches_the_same_best_trial_as_jax(tmp_path, capsys, monkeypatch):
    pytest.importorskip("jax")
    from repro.explorer.__main__ import main as jmain
    from repro_torch.explorer.__main__ import main as tmain

    assert jmain([str(QUICKSTART), "--report-dir", str(tmp_path / "j")]) == 0
    assert tmain([str(QUICKSTART), "--device", "cpu", "--report-dir", str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    want = json.loads((tmp_path / "j" / "quickstart.report.json").read_text())
    got = json.loads((tmp_path / "t" / "quickstart.report.json").read_text())
    assert got["best"] == want["best"] and got["n_trials"] == want["n_trials"] == 25
    assert got["toolchain"]["framework"] == "torch" and got["device"] == "cpu"
    assert out.count("best trial #8") == 2
    monkeypatch.chdir(tmp_path)  # sweep_small.yaml's cache: results/cache
    assert tmain(["sweep", str(EXPERIMENTS / "sweep_small.yaml"), "--axis",
                  "targets=host_cpu,edge_npu", "--trials", "2", "--device", "cpu",
                  "--report-dir", str(tmp_path / "s")]) == 0
    out = capsys.readouterr().out
    assert "sweep 'sweep-small': 4 cells (0 resumed)" in out and "wins[latency_s]" in out
    assert (tmp_path / "s" / "sweep-small.sweep.json").is_file()


def test_list_components_names_the_ported_components(capsys):
    from repro_torch.explorer.__main__ import main

    assert main(["--list-components"]) == 0
    out = capsys.readouterr().out
    for name in ("serial", "thread", "process", "median", "successive_halving",
                 "latency_s", "peak_bytes", "h100", "host_cpu", "edge_npu", "tpe", "synflow",
                 "grad_norm", "prefill_latency_s", "decode_latency_s",
                 "kv_cache_peak_bytes", "throughput_tok_s", "p99_latency_s"):
        assert name in out
    assert "remote" in out


def test_jax_and_torch_values_under_one_key_are_not_read_as_each_other(tmp_path):
    """A shared store directory: the JAX package writes a value under an
    estimator key, the port another under the same key; each reads back
    its own, and a fresh port store does not see the JAX value."""
    pytest.importorskip("jax")
    from repro.evaluation.disk_cache import DiskEvaluationCache as JDisk
    from repro_torch.evaluation.disk_cache import DiskEvaluationCache as TDisk
    from repro_torch.evaluation.disk_cache import toolchain_versions

    key = ("latency_s", "h100", 4, "ssm(d_state=64)|linear(width=64)")
    store = str(tmp_path / "shared")
    assert JDisk(store).store(key, 0.25)
    assert TDisk(store).lookup(key) == (False, None)
    assert TDisk(store).store(key, 0.5)
    assert JDisk(store).lookup(key) == (True, 0.25)
    assert TDisk(store).lookup(key) == (True, 0.5)
    salt = toolchain_versions()
    assert salt["framework"] == "torch" and salt["torch"] == torch.__version__
    assert set(salt) == {"framework", "torch", "cuda", "triton"}
    assert [v for _, v in TDisk(store).entries()] == [0.5]  # the port's salt only


def test_chip_smoke_documents_are_the_examples():
    """``chip_smoke.py`` passes dicts (the card's machine has no PyYAML):
    the port's sweep_small.yaml, hw_parallel.yaml and serving.yaml, each
    with its space inlined and, for the two experiments, target ``h100``;
    nothing else may drift from the YAML files."""
    import importlib.util

    from repro_torch.explorer.sweep import SweepSpec

    root = EXPERIMENTS.parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    port = root / "src" / "repro_torch" / "experiments"
    assert (SweepSpec.from_dict(smoke.SWEEP_SMALL).to_dict()
            == SweepSpec.from_yaml(str(port / "sweep_small.yaml")).to_dict())
    for name, doc in (("hw_parallel.yaml", smoke.HW_PARALLEL),
                      ("serving.yaml", smoke.SERVING_EXPERIMENT)):
        raw = yaml.safe_load((EXPERIMENTS / name).read_text())
        raw["target"] = "h100"
        want = ExperimentSpec.from_dict(raw, base_dir=str(EXPERIMENTS)).to_dict()
        assert ExperimentSpec.from_dict(doc).to_dict() == want, name
    assert (smoke.CONV_POOL_SPACE
            == yaml.safe_load((EXPERIMENTS / "spaces" / "conv_pool.yaml").read_text()))
