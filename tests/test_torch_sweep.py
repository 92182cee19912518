"""The port's sweeps (``repro_torch.explorer.sweep``) against the JAX
package's on the CPU: the reference test's tiny analytic sweep merged key
for key through both packages, expansion and axis errors case for case,
resume, ``edge_npu``'s reuse of ``host_cpu``'s counts, the device each cell
runs on, the refusals (TPU targets), the remote fan-out of cells (``workers``
validated as the reference's, an unreachable pool run locally), and the
reference's ``sweep_small.yaml`` through both command lines."""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from repro_torch.core.builder import ModelBuilder  # noqa: E402
from repro_torch.core.space import parse_search_space  # noqa: E402
from repro_torch.core.translate import sample_architecture  # noqa: E402
from repro_torch.evaluation import estimators as test  # noqa: E402
from repro_torch.evaluation.cache import EvaluationCache  # noqa: E402
from repro_torch.explorer.experiment import (  # noqa: E402
    ExperimentError, ExperimentSpec)
from repro_torch.explorer.explorer import Explorer  # noqa: E402
from repro_torch.explorer.sweep import (  # noqa: E402
    SweepError, SweepSpec, _axis_label, merge_reports, run_sweep)
from repro_torch.hwgen import generator as tgen  # noqa: E402
from repro_torch.hwgen.targets import H100, TargetSpec, get_target  # noqa: E402
from repro_torch.search.samplers import RandomSampler  # noqa: E402
from repro_torch.search.study import Study  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXPERIMENTS = ROOT / "examples" / "experiments"
PORT_EXPERIMENTS = ROOT / "src" / "repro_torch" / "experiments"

# the reference test's tiny sweep (tests/test_sweep.py): analytic criteria
TINY_SPACE = {
    "input": [2, 64],
    "output": 3,
    "sequence": [
        {"block": "features", "op_candidates": "conv1d",
         "conv1d": {"kernel_size": [3, 5], "out_channels": [4, 8]}},
        {"block": "head", "op_candidates": "linear",
         "linear": {"width": [8, 16]}},
    ],
}
BASE = {
    "name": "tiny",
    "search_space": TINY_SPACE,
    "sampler": {"name": "random", "seed": 0},
    "executor": {"backend": "serial"},
    "criteria": [
        {"estimator": "flops", "kind": "objective", "weight": 1.0},
        {"estimator": "n_params", "kind": "objective", "weight": 0.1},
    ],
    "budget": {"n_trials": 6},
}

# the reference's sweep_small.yaml, port against JAX, each cell's best
# trial: modelled latency_s (bytes-bound on host_cpu and edge_npu) measured
# 0.687-0.708x of the reference's, peak_bytes (counted on meta against
# XLA's memory analysis) 0.9990-0.9993x, the best value (latency plus 1e-9
# of the peak) 0.939-0.978x; the same best trial in every cell.  Held to
# the byte ratio of tests/test_torch_modelled.py
BYTES_RATIO = (0.5, 1.5)


def make_sweep(tmp_path, **overrides):
    raw = {
        "name": "tiny-sweep",
        "base": copy.deepcopy(BASE),
        "axes": {
            "targets": ["host_cpu", "edge_npu"],
            "samplers": [{"name": "random", "seed": 0},
                         {"name": "grid", "seed": 0}],
        },
        "report_dir": str(tmp_path / "results"),
    }
    raw.update(overrides)
    return raw


def _jax_sweep():
    pytest.importorskip("jax")
    from repro.explorer import sweep as jsweep

    return jsweep


def _comparable(report):
    """A merged report without what may differ between packages and runs:
    wall clock, paths, the toolchain (it names the framework), and in each
    cell's target the port's ``device`` and the reference's TPU-only
    ``vmem_bytes`` (the port's chips have no VMEM)."""
    d = json.loads(json.dumps(report.to_dict()))
    for key in ("wall_clock_s", "toolchain", "artifact"):
        d.pop(key)
    d["spec"].pop("report_dir")
    for cell in d["cells"]:
        for key in ("wall_clock_s", "artifact"):
            cell.pop(key)
        cell["target"].pop("device", None)
        cell["target"]["chip"].pop("vmem_bytes", None)
    return d


def test_tiny_sweep_merges_as_jax_key_for_key(tmp_path):
    """[host_cpu, edge_npu] x [random 0, grid 0], analytic flops and
    n_params: the same cells, matrix, Pareto union, rankings, cell bests,
    cache counters and spec in both packages' merged reports; and two runs
    of the port merge bit for bit alike."""
    jsweep = _jax_sweep()
    jreport = jsweep.run_sweep(jsweep.SweepSpec.from_dict(make_sweep(tmp_path / "j")),
                               save_report=False)
    treport = run_sweep(SweepSpec.from_dict(make_sweep(tmp_path / "t")),
                        save_report=False, device="cpu")
    assert treport.n_cells == 4 and treport.n_resumed == 0
    assert treport.toolchain["framework"] == "torch"
    got, want = _comparable(treport), _comparable(jreport)
    for key in ("matrix", "pareto_union", "target_rankings", "axes"):
        assert got[key] == want[key], key
    assert [c["best"] for c in got["cells"]] == [c["best"] for c in want["cells"]]
    assert got == want
    again = run_sweep(SweepSpec.from_dict(make_sweep(tmp_path / "t2")),
                      save_report=False, device="cpu")
    assert json.dumps(_comparable(again), sort_keys=True) == json.dumps(got, sort_keys=True)


def test_cell_best_matches_standalone_explorer(tmp_path):
    spec = SweepSpec.from_dict(make_sweep(tmp_path))
    report = run_sweep(spec, save_report=False, device="cpu")
    for cell, summary in zip(spec.expand(), report.cells):
        standalone = Explorer.from_spec(cell.spec, device="cpu").run(save_report=False)
        assert summary["best"] == standalone.best


def test_resume_kill_and_edit(tmp_path):
    """A re-run resumes every cell and merges to the same matrix; a killed
    cell re-runs alone; an edited base invalidates every cell; the merge
    is pure (the reference's resume and merge tests)."""
    spec = SweepSpec.from_dict(make_sweep(tmp_path))
    first = run_sweep(spec, device="cpu")
    assert first.n_resumed == 0 and os.path.exists(first.artifact)
    second = run_sweep(spec, device="cpu")
    assert second.n_resumed == 4 and second.matrix == first.matrix
    assert [c["best"] for c in second.cells] == [c["best"] for c in first.cells]
    victim = spec.expand()[2]
    os.remove(victim.report_path)
    third = run_sweep(spec, device="cpu")
    assert third.n_resumed == 3 and third.matrix == first.matrix
    assert [c["name"] for c in third.cells if not c["resumed"]] == [victim.name]
    summaries = copy.deepcopy(first.cells)
    merged = merge_reports(spec, copy.deepcopy(summaries), 4, 2.0)
    assert merged.matrix == first.matrix and merged.pareto_union == first.pareto_union
    assert merged.target_rankings == first.target_rankings and summaries == first.cells
    spec.base["budget"]["n_trials"] = 4
    assert run_sweep(spec, device="cpu").n_resumed == 0


def test_resume_matches_a_serving_spec(tmp_path):
    """A cell whose spec has a traffic mix (integer prompt lengths, which
    JSON writes as strings) resumes too: the fingerprint compares the
    spec's JSON form."""
    base = yaml.safe_load((EXPERIMENTS / "serving.yaml").read_text())
    base["search_space"] = TINY_SPACE
    base.pop("cache")
    raw = make_sweep(tmp_path, base=base, axes={"budget.n_trials": [2]})
    spec = SweepSpec.from_dict(raw)
    assert run_sweep(spec, device="cpu").n_resumed == 0
    assert run_sweep(spec, device="cpu").n_resumed == 1


@pytest.mark.parametrize("axes, overrides", [
    ({"targets": ["host_cpu", "edge_npu"],
      "samplers": [{"name": "random", "seed": 0}, {"name": "grid", "seed": 0}]}, None),
    ({"targets": ["host_cpu"], "budget.n_trials": [2, 4]}, None),
    ({"budget": [{"n_trials": 50}, {"n_trials": 60}],
      "executor": [{"backend": "serial", "n_workers": 8}]},
     {"budget.n_trials": 2, "executor.n_workers": 1}),
    ({"samplers": [{"name": "tpe", "seed": 1}, {"name": "tpe", "seed": 2}],
      "schedule.mode": ["batch", "sliding_window"]}, None),
], ids=["cross", "dotted", "overrides-beat-sections", "labels"])
def test_expansion_matches_jax(tmp_path, axes, overrides):
    """Cell names, axis labels, order and every child spec as the
    reference expands them (dotted axes touch one leaf; post-axis
    overrides win even over a whole-section axis)."""
    jsweep = _jax_sweep()
    raw = make_sweep(tmp_path, axes=axes, cache=str(tmp_path / "store"))
    got = SweepSpec.from_dict(copy.deepcopy(raw)).expand(overrides)
    want = jsweep.SweepSpec.from_dict(copy.deepcopy(raw)).expand(overrides)
    assert [(c.name, c.axes, c.axis_values) for c in got] == \
        [(c.name, c.axes, c.axis_values) for c in want]
    assert [c.spec.to_dict() for c in got] == [c.spec.to_dict() for c in want]
    assert all(c.spec.cache.dir == str(tmp_path / "store") for c in got)
    if overrides:
        assert {c.spec.budget.n_trials for c in got} == {2}


@pytest.mark.parametrize("edit, at", [
    (lambda raw: raw["axes"].update(samplerz=["random"]), "from_dict"),
    (lambda raw: raw["axes"].update(name=["a", "b"]), "from_dict"),
    (lambda raw: raw["axes"].update(target=[]), "from_dict"),
    (lambda raw: raw["axes"].update(sampler=["random"]), "from_dict"),
    (lambda raw: raw.update(bases=raw.pop("base")), "from_dict"),
    (lambda raw: raw["axes"].update(targets=["host_cpu", "warp_core"]), "expand"),
], ids=["unknown-head", "not-sweepable", "empty", "duplicate-alias", "unknown-key",
        "bad-value"])
def test_axis_errors_match_jax(tmp_path, edit, at):
    """Each error is a ``SweepError`` with the reference's message, naming
    the axis; a bad value fails at ``expand()`` naming the cell (the
    registered targets listed are the port's)."""
    jsweep = _jax_sweep()
    raw = make_sweep(tmp_path)
    edit(raw)
    errors = []
    for spec_cls, error in ((jsweep.SweepSpec, jsweep.SweepError), (SweepSpec, SweepError)):
        with pytest.raises(error) as e:
            spec = spec_cls.from_dict(copy.deepcopy(raw))
            if at == "expand":
                spec.expand()
        errors.append(str(e.value))
    jmsg, tmsg = errors
    if at == "expand":
        assert "target=warp_core" in tmsg and "h100" in tmsg and "edge_npu" in tmsg
        assert tmsg.split("registered")[0] == jmsg.split("registered")[0]
    else:
        assert tmsg == jmsg


def test_axis_labels_match_jax():
    jsweep = _jax_sweep()
    for value in ("host_cpu", {"name": "tpe", "seed": 3}, {"mode": "sliding_window"},
                  {"name": "tpe", "seed": 1, "gamma": 0.25, "n_startup": 4, "x": [1]}, 7,
                  {"n_trials": 4}, "a b/c"):
        assert _axis_label(value) == jsweep._axis_label(value), value


def _tiny_model():
    space = parse_search_space(dict(TINY_SPACE))
    builder = ModelBuilder(space.input_shape, space.output_dim)
    return builder.build(sample_architecture(space, Study(sampler=RandomSampler(seed=0)).ask()))


def test_edge_npu_counts_nothing_after_host_cpu_but_ranks_by_its_chip(tmp_path):
    """host_cpu and edge_npu share a ``mesh_scope``: after host_cpu's
    modelled latency and counted peak, edge_npu's count no forward and
    generate nothing, yet its latency is its own chip's; its measured
    latency is the same roofline bound (a roofline target runs nothing).
    A target of the same mesh on CUDA keys apart."""
    model = _tiny_model()
    cache = EvaluationCache(disk=str(tmp_path / "store"))
    counted = []
    count = test.program_cost

    def counting(*args, **kwargs):
        counted.append(1)
        return count(*args, **kwargs)

    with mock.patch.object(test, "program_cost", counting):
        host = test.CompiledLatencyEstimator("host_cpu", batch=2, cache=cache,
                                             metric="modelled").estimate(model)
        host_peak = test.CompiledMemoryEstimator("host_cpu", batch=2,
                                                 cache=cache).estimate(model)
        assert len(counted) == 2
        generated = tgen.generate_call_count()
        edge = test.CompiledLatencyEstimator("edge_npu", batch=2, cache=cache,
                                             metric="modelled").estimate(model)
        edge_peak = test.CompiledMemoryEstimator("edge_npu", batch=2,
                                                 cache=cache).estimate(model)
        assert len(counted) == 2 and tgen.generate_call_count() == generated
    assert edge != host and edge_peak == host_peak
    measured = test.CompiledLatencyEstimator("edge_npu", batch=2, cache=cache,
                                             metric="measured")
    assert measured.estimate(model) == edge
    artifact = measured._artifact(model)
    assert artifact.target.name == "edge_npu" and artifact.memory == {}
    assert tgen.generate_call_count() == generated  # nothing was placed or run
    result = tgen.HardwareManager().benchmark(artifact)
    assert result["latency_s"] == edge and result["measured"] == 0.0
    fake = TargetSpec(name="fake_card", chip=H100, mesh_shape=(1, 1),
                      mesh_axes=("data", "model"), measurement="wallclock", device="cuda")
    on_card = test.CompiledMemoryEstimator(fake, batch=2, cache=cache)
    on_host = test.CompiledMemoryEstimator("host_cpu", batch=2, cache=cache)
    assert get_target("edge_npu").mesh_scope == get_target("host_cpu").mesh_scope
    assert fake.mesh_scope.endswith("@cuda") and get_target("h100").mesh_scope == fake.mesh_scope
    assert on_card._program_key("peak_bytes", model) != on_host._program_key("peak_bytes", model)


@pytest.mark.parametrize("where", ["experiment", "sweep-axis", "workers", "run_sweep",
                                   "cli"])
def test_refusals_name_their_reason(tmp_path, where):
    """No TPU target (the port carries no TPU rates), refused with the
    reason.  The remote fan-out of cells is ported: a sweep's ``workers``
    is validated as the reference's; ``run_sweep(workers=)`` and the CLI's
    ``--cell-workers`` at an unreachable pool warn and run every cell
    locally."""
    unreachable = ["127.0.0.1:9"]
    if where == "experiment":
        with pytest.raises(ExperimentError, match="no TPU targets"):
            ExperimentSpec.from_dict(dict(BASE, target="tpu_v5e_pod"))
    elif where == "sweep-axis":
        spec = SweepSpec.from_dict(make_sweep(tmp_path, axes={"targets": ["host_cpu",
                                                                          "tpu_v5e"]}))
        with pytest.raises(SweepError, match=r"target=tpu_v5e.*no TPU targets"):
            spec.expand()
    elif where == "workers":
        jsweep = _jax_sweep()
        raw = make_sweep(tmp_path, workers=["127.0.0.1:7471", "10.0.0.5:7472"])
        spec = SweepSpec.from_dict(raw)
        assert spec.workers == raw["workers"]
        assert spec.to_dict() == jsweep.SweepSpec.from_dict(raw).to_dict()
        for bad, match in (([], "non-empty"), (["nope"], "host:port"),
                           ("127.0.0.1:7471", "non-empty"), ([7471], "non-empty")):
            with pytest.raises(SweepError, match=match):
                SweepSpec.from_dict(make_sweep(tmp_path, workers=bad))
            with pytest.raises(jsweep.SweepError, match=match):
                jsweep.SweepSpec.from_dict(make_sweep(tmp_path, workers=bad))
        assert not (tmp_path / "results").exists()
    elif where == "run_sweep":
        with pytest.warns(RuntimeWarning, match="no sweep workers reachable"):
            report = run_sweep(SweepSpec.from_dict(make_sweep(tmp_path)),
                               workers=unreachable, device="cpu")
        assert report.n_cells == 4 and report.n_resumed == 0
        assert all(c["best"] is not None for c in report.cells)
    else:
        from repro_torch.explorer.__main__ import main

        path = tmp_path / "sweep.yaml"
        path.write_text(yaml.safe_dump(make_sweep(tmp_path)))
        with pytest.warns(RuntimeWarning, match="no sweep workers reachable"):
            assert main(["sweep", str(path), "--device", "cpu",
                         "--cell-workers", ",".join(unreachable)]) == 0
        assert (tmp_path / "results" / "tiny-sweep.sweep.json").is_file()
    if where in ("experiment", "sweep-axis"):
        assert not (tmp_path / "results").exists()


def test_cuda_cell_fails_at_expand_under_cpu(tmp_path):
    """Asked for the CPU, a sweep over a target that runs on CUDA fails at
    expansion, naming the cell, before any cell runs; asked for CUDA, each
    cell would run on its own target's device."""
    spec = SweepSpec.from_dict(make_sweep(tmp_path, axes={"targets": ["host_cpu", "h100"]}))
    with pytest.raises(SweepError, match=r"cell \[target=h100\]: target 'h100' runs"):
        spec.expand(device="cpu")
    with pytest.raises(SweepError, match="target=h100"):
        run_sweep(spec, device="cpu")
    assert not (tmp_path / "results").exists()
    assert [c.device for c in spec.expand(device="cuda")] == ["cpu", "cuda"]


def test_port_sweep_small_is_the_reference_on_the_ports_targets():
    """The port's copy of sweep_small.yaml: the reference's document with
    the targets axis [host_cpu, edge_npu, h100] in place of [host_cpu,
    edge_npu, tpu_v5e], its space file copied beside it."""
    want = yaml.safe_load((EXPERIMENTS / "sweep_small.yaml").read_text())
    got = yaml.safe_load((PORT_EXPERIMENTS / "sweep_small.yaml").read_text())
    assert want["axes"].pop("targets") == ["host_cpu", "edge_npu", "tpu_v5e"]
    assert got["axes"].pop("targets") == ["host_cpu", "edge_npu", "h100"]
    assert got == want
    spaces = "spaces/conv_pool.yaml"
    assert (yaml.safe_load((PORT_EXPERIMENTS / spaces).read_text())
            == yaml.safe_load((EXPERIMENTS / spaces).read_text()))
    spec = SweepSpec.from_yaml(str(PORT_EXPERIMENTS / "sweep_small.yaml"))
    assert [c.spec.target for c in spec.expand()] == ["host_cpu"] * 2 + ["edge_npu"] * 2 \
        + ["h100"] * 2


def _trial_signatures(explorer_cls):
    """Patch ``explorer_cls.run`` to record each run's trials."""
    runs = {}
    run = explorer_cls.run

    def recording(self, *args, **kwargs):
        report = run(self, *args, **kwargs)
        runs[self.spec.name] = [(t.number, t.state.value, t.user_attrs.get("signature"))
                                for t in self.study.trials]
        return report

    return runs, mock.patch.object(explorer_cls, "run", recording)


def test_reference_sweep_small_through_both_command_lines(tmp_path, capsys, monkeypatch):
    """The reference's sweep_small.yaml with --axis targets=host_cpu,edge_npu
    through both CLIs (the JAX one in its own process: it compiles, and the
    JAX package's cascade tests read the process's compile count): the same
    cells, sampled signatures, feasibility and target rankings; the modelled
    values within the byte ratio; a second port run resumes every cell."""
    from repro_torch.explorer.__main__ import main

    args = [str(EXPERIMENTS / "sweep_small.yaml"), "--axis", "targets=host_cpu,edge_npu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    code = ("import sys, json\n"
            "from unittest import mock\n"
            "from repro.explorer.explorer import Explorer\n"
            "from repro.explorer.__main__ import main\n"
            "runs = {}\n"
            "run = Explorer.run\n"
            "def recording(self, *a, **k):\n"
            "    r = run(self, *a, **k)\n"
            "    runs[self.spec.name] = [(t.number, t.state.value, t.user_attrs.get('signature'))\n"
            "                            for t in self.study.trials]\n"
            "    return r\n"
            "with mock.patch.object(Explorer, 'run', recording):\n"
            "    assert main(sys.argv[1:]) == 0\n"
            "print('RUNS ' + json.dumps(runs))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "sweep", *args, "--report-dir", str(tmp_path / "j")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jruns = {k: [tuple(t) for t in v] for k, v in json.loads(
        proc.stdout.split("RUNS ", 1)[1]).items()}
    truns, patch = _trial_signatures(Explorer)
    monkeypatch.chdir(tmp_path)  # the document's cache: results/cache, under tmp_path
    with patch:
        assert main(["sweep", *args, "--device", "cpu", "--report-dir",
                     str(tmp_path / "t")]) == 0
    assert truns == jruns and len(truns) == 4
    want = json.loads((tmp_path / "j" / "sweep-small.sweep.json").read_text())
    got = json.loads((tmp_path / "t" / "sweep-small.sweep.json").read_text())
    assert [c["name"] for c in got["cells"]] == [c["name"] for c in want["cells"]]
    assert [c["states"] for c in got["cells"]] == [c["states"] for c in want["cells"]]
    assert ({k: [r["target"] for r in v] for k, v in got["target_rankings"].items()}
            == {k: [r["target"] for r in v] for k, v in want["target_rankings"].items()})
    for g, w in zip(got["cells"], want["cells"]):
        assert g["best"]["number"] == w["best"]["number"]
        assert g["best"]["signature"] == w["best"]["signature"]
        assert g["criteria_values"]["n_params"] == w["criteria_values"]["n_params"]
        for key in ("latency_s", "peak_bytes"):
            ratio = g["criteria_values"][key] / w["criteria_values"][key]
            assert BYTES_RATIO[0] <= ratio <= BYTES_RATIO[1], (g["name"], key, ratio)
        ratio = g["best"]["values"][0] / w["best"]["values"][0]
        assert BYTES_RATIO[0] <= ratio <= BYTES_RATIO[1], (g["name"], ratio)
    capsys.readouterr()
    assert main(["sweep", *args, "--device", "cpu", "--report-dir",
                 str(tmp_path / "t")]) == 0
    assert "4 cells (4 resumed)" in capsys.readouterr().out


def test_dict_sweep_runs_without_pyyaml(tmp_path):
    """The card's machine has no PyYAML: a dict sweep imports, expands and
    runs with ``yaml`` blocked."""
    code = (
        "import sys, json; sys.modules['yaml'] = None\n"
        "from repro_torch.explorer.sweep import SweepSpec, run_sweep\n"
        f"raw = json.loads({json.dumps(json.dumps(make_sweep(tmp_path)))})\n"
        "report = run_sweep(SweepSpec.from_dict(raw), device='cpu')\n"
        "assert 'yaml' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print(report.n_cells)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "4"
