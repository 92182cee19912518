"""The port's deploy-best mode on the CPU: ``serving.yaml`` explored at 6
trials with a disk cache leaves every candidate's program in the artifact
store, and ``repro_torch.launch.serve --from-report`` boots the winner
from it without generating, as the reference's tests
(``tests/test_serving.py``, the artifact-store cases) hold the JAX
package's.  Against the JAX package: ``rebuild_best`` on the JAX
package's own report of the same experiment gives the same signature,
and the port's boot serves the same requests in the same batches as
``python -m repro.launch.serve --from-report`` on that report (run in a
subprocess: it compiles, and the JAX package's cascade tests read the
process's compile count).  And the process backend's workers start with
the parent's fp32 flags."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from repro_torch.evaluation.serving import _ServingEstimator  # noqa: E402
from repro_torch.explorer.explorer import Explorer  # noqa: E402
from repro_torch.hwgen import generator as tgen  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXPERIMENTS = ROOT / "examples" / "experiments"
TRIALS = 6


@pytest.fixture(autouse=True)
def _fresh_generate_count(monkeypatch):
    """Each test starts from a process generate count of 0, as a fresh
    process does (the checks below count generates)."""
    monkeypatch.setattr(tgen, "_generate_count", 0)


def _raw(tmp_path):
    raw = yaml.safe_load((EXPERIMENTS / "serving.yaml").read_text())
    raw["search_space"] = {"file": str(EXPERIMENTS / raw["search_space"]["file"])}
    raw.update(cache={"dir": str(tmp_path / "cache")}, report_dir=str(tmp_path),
               budget={"n_trials": TRIALS})
    return raw


@pytest.fixture(scope="module")
def serving_report(tmp_path_factory):
    """(the port's report as saved, its path): serving.yaml at 6 trials,
    explored on the CPU with a disk cache."""
    tmp = tmp_path_factory.mktemp("port")
    report = Explorer.from_dict(_raw(tmp), device="cpu").run()
    assert report.artifacts and report.artifacts["entries"] == TRIALS
    with open(report.artifact) as f:
        return json.load(f), report.artifact


@pytest.fixture(scope="module")
def jax_boot(tmp_path_factory):
    """(the JAX package's report, its boot's summary): the same
    experiment through ``python -m repro.explorer`` and ``python -m
    repro.launch.serve --from-report`` in one subprocess."""
    tmp = tmp_path_factory.mktemp("jax")
    (tmp / "serving.yaml").write_text(yaml.safe_dump(_raw(tmp)))
    code = ("import sys\n"
            "from repro.explorer.__main__ import main as explore\n"
            "from repro.launch.serve import main as serve\n"
            "assert explore([sys.argv[1]]) == 0\n"
            "sys.exit(serve(['--from-report', sys.argv[2], '--expect-compiles', '0']))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp / "serving.yaml"),
                           str(tmp / "serving.report.json")], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads((tmp / "serving.report.json").read_text())
    return report, json.loads(proc.stdout.strip().splitlines()[-1])


def _boot_args(path, *extra):
    return serve.parse_args(["--from-report", path, *extra])


def test_warm_artifact_loads_the_program_the_cold_one_generates(serving_report):
    report, _ = serving_report
    candidate, spec = serve.rebuild_best(report)
    assert candidate.arch.signature() == report["best"]["signature"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (spec.serving.max_batch, *reversed(candidate.input_shape))).astype(np.float32))

    # cold: a fresh estimator with no cache dir generates
    cold = _ServingEstimator(target=spec.target, serving=spec.serving)
    plan = cold._schedule_plan(candidate)
    cold_artifact = cold._artifact(candidate, plan)
    assert tgen.generate_call_count() == 1 and cold_artifact.program is None
    with torch.inference_mode():
        cold_out = cold_artifact(x)

    # warm: the exploration's cache dir, a store hit, no generate, the same output
    warm = _ServingEstimator(target=spec.target, serving=spec.serving, cache=spec.cache.dir)
    warm_artifact = warm._artifact(candidate, plan)
    assert tgen.generate_call_count() == 1 and warm_artifact.program is not None
    assert warm.artifacts is not None and warm.artifacts.hits >= 1
    with torch.inference_mode():
        assert torch.equal(warm_artifact(x), cold_out)


def test_serve_cli_boots_the_report_without_generating(serving_report):
    _, path = serving_report
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--from-report", path,
         "--expect-compiles", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["compiles"] == 0 and out["artifact_store"]["hits"] == 1
    assert out["served"] == out["traffic"]["n_requests"] and out["shed"] == 0
    assert out["signature"] == serving_report[0]["best"]["signature"]
    assert out["device"] == "cpu"


def test_a_cold_boot_fails_expect_compiles_zero(serving_report, monkeypatch, capsys):
    _, path = serving_report
    monkeypatch.setenv("REPRO_ARTIFACTS", "0")
    assert serve.main(["--from-report", path, "--expect-compiles", "0"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["compiles"] == 1 and out["artifact_store"] is None


def test_rebuild_best_rejects_signature_drift(serving_report):
    report = json.loads(json.dumps(serving_report[0]))
    report["best"]["signature"] = "linear(width=9999)"
    with pytest.raises(SystemExit, match="does not\n?.*match"):
        serve.rebuild_best(report)


def test_from_report_and_arch_are_exclusive(serving_report, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--from-report", serving_report[1], "--arch", "qwen3-1.7b"])
    assert "not allowed with argument" in capsys.readouterr().err
    assert serve.parse_args(["--from-report", serving_report[1]]).arch is None
    from repro_torch.explorer.docgen import serving_markdown

    assert "python -m repro_torch.launch.serve --from-report" in serving_markdown()


def test_rebuild_best_of_the_jax_report_gives_its_signature(serving_report, jax_boot):
    report, _ = jax_boot
    candidate, spec = serve.rebuild_best(report)
    assert candidate.arch.signature() == report["best"]["signature"]
    assert spec.serving.to_dict() == serve.rebuild_best(serving_report[0])[1].serving.to_dict()


def test_boot_serves_as_the_jax_package_boot_does(serving_report, jax_boot):
    report, path = serving_report
    jreport, jout = jax_boot
    assert jout["compiles"] == 0
    assert report["best"]["signature"] == jreport["best"]["signature"]
    out = json.loads(json.dumps(serve._serve_report(_boot_args(path))))
    assert out["compiles"] == 0
    assert {k: out[k] for k in ("served", "shed", "batches", "traffic", "signature")} == \
        {k: jout[k] for k in ("served", "shed", "batches", "traffic", "signature")}


def test_spawned_workers_start_with_the_parents_fp32_flags():
    """The process backend's workers take the parent's TF32 and matmul
    precision settings, where a spawned interpreter would start from
    torch's defaults (cuDNN TF32 on): a memory or latency record a worker
    leaves must come from the numerics the parent runs."""
    from repro_torch.search.executors import ProcessExecutor, numerics_flags

    saved = numerics_flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True  # precision "high"
        torch.backends.cudnn.allow_tf32 = False
        parent = numerics_flags()
        with ProcessExecutor()._make_pool(1) as pool:
            worker = pool.submit(numerics_flags).result(timeout=120)
    finally:
        torch.set_float32_matmul_precision(saved["float32_matmul_precision"])
        torch.backends.cuda.matmul.allow_tf32 = saved["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = saved["cudnn_allow_tf32"]
    # each flag the other way from torch's defaults
    assert worker == parent == {"matmul_allow_tf32": True, "cudnn_allow_tf32": False,
                                "float32_matmul_precision": "high"}
