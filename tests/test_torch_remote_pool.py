"""The port's ``remote`` executor and the sweep's cell fan-out against the
JAX package on the CPU: a fixed-seed study with analytic criteria through
two in-process port daemons gives the JAX package's serial trial
sequence, params, values and best trial, also when a daemon dies
mid-run; every trial, the first included, runs in a daemon; pruning
happens worker side; poison trials are quarantined; an unreachable pool
degrades with a warning; the spec, the CLI's ``--remote-workers`` and
``REPRO_REMOTE_WORKERS`` select the pool; ``examples/experiments/
remote.yaml`` runs at ``host_cpu`` to the port's serial best trial; a tiny
analytic sweep fanned across two daemons merges key for key as the local
run and as the JAX package's fanned run."""
import copy
import json
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from repro_torch.explorer.explorer import Explorer  # noqa: E402
from repro_torch.explorer.sweep import SweepSpec, run_sweep  # noqa: E402
from repro_torch.search.parallel import ParallelStudy  # noqa: E402
from repro_torch.search.pruners import MedianPruner  # noqa: E402
from repro_torch.search.remote.executor import RemoteExecutor  # noqa: E402
from repro_torch.search.remote.worker import DropConnection, WorkerServer  # noqa: E402
from repro_torch.search.samplers import RandomSampler  # noqa: E402
from repro_torch.search.study import TrialPruned  # noqa: E402
from repro_torch.search.trial import TrialState  # noqa: E402
from test_torch_sweep import _comparable, make_sweep  # noqa: E402

REMOTE_YAML = Path(__file__).resolve().parents[1] / "examples" / "experiments" / "remote.yaml"


def _quadratic(trial):
    x = trial.suggest_float("x", -4.0, 4.0)
    y = trial.suggest_float("y", -4.0, 4.0)
    return (x - 1.0) ** 2 + (y + 0.5) ** 2


_PRUNE_BUDGET = 10


def _prunable(trial):
    bad = trial.number % 4 == 3
    base = 100.0 if bad else 1.0
    for step in range(_PRUNE_BUDGET):
        trial.report(step, base + 0.01 * step)
        if trial.should_prune():
            trial.set_user_attr("steps_run", step + 1)
            raise TrialPruned()
        time.sleep(0.01)
    trial.set_user_attr("steps_run", _PRUNE_BUDGET)
    return base


def _fingerprint(study):
    return [(t.number, dict(t.params), t.values) for t in study.trials]


def _jax_serial(seed, n):
    pytest.importorskip("jax")
    from repro.search import RandomSampler as JRandomSampler
    from repro.search import Study as JStudy

    ref = JStudy(sampler=JRandomSampler(seed=seed))
    ref.optimize(_quadratic, n)
    return ref


def _start_servers(n, cls=WorkerServer, **kwargs):
    servers = [cls(**kwargs) for _ in range(n)]
    return servers, ["%s:%d" % s.start() for s in servers]


@pytest.fixture
def daemons():
    servers, addrs = _start_servers(2)
    yield servers, addrs
    for s in servers:
        s.stop()


class _DieOnce:
    def __init__(self):
        self.dropped = False

    def __call__(self, task_id, task):
        if not self.dropped:
            self.dropped = True
            raise DropConnection()


class _PoisonHook:
    """Sever the connection whenever the poison trial arrives: a daemon-side
    stand-in for a trial that kills its host."""

    def __init__(self, number):
        self.number = number
        self.kills = 0

    def __call__(self, task_id, task):
        if isinstance(task, dict) and task.get("number") == self.number:
            self.kills += 1
            raise DropConnection()


def _remote_study(seed, addrs, **kwargs):
    return ParallelStudy(sampler=RandomSampler(seed=seed), n_workers=2,
                         backend=RemoteExecutor(workers=addrs, **kwargs),
                         schedule="sliding_window", tell_order="completion")


# ---------------------------------------------------------------------------
# RemoteExecutor: fixed-seed parity with the JAX package's serial study
# ---------------------------------------------------------------------------

def test_remote_parity_with_the_jax_serial_reference(daemons):
    """Every trial, the first included, runs in a daemon; the trial
    sequence, params, values and best trial are the JAX serial study's."""
    servers, addrs = daemons
    ref = _jax_serial(7, 10)
    s = _remote_study(7, addrs)
    s.optimize(_quadratic, 10)
    assert _fingerprint(s) == _fingerprint(ref)
    assert (s.best_trial.number, s.best_trial.values) == \
        (ref.best_trial.number, ref.best_trial.values)
    assert sum(srv.tasks_done for srv in servers) == 10


def test_remote_parity_survives_worker_death():
    """One of two daemons severs its connection on its first task: bounded
    resubmission finishes the run with the JAX serial study's trials."""
    hook = _DieOnce()
    flaky, flaky_addrs = _start_servers(1, task_hook=hook)
    steady, steady_addrs = _start_servers(1)
    try:
        ref = _jax_serial(11, 8)
        s = _remote_study(11, flaky_addrs + steady_addrs)
        with pytest.warns(RuntimeWarning, match="lost"):
            s.optimize(_quadratic, 8)
        assert hook.dropped
        assert all(t.state == TrialState.COMPLETE for t in s.trials)
        assert _fingerprint(s) == _fingerprint(ref)
        assert s.best_trial.number == ref.best_trial.number
    finally:
        for srv in flaky + steady:
            srv.stop()


def test_remote_prunes_worker_side(daemons):
    _, addrs = daemons
    s = ParallelStudy(sampler=RandomSampler(seed=0), n_workers=2,
                      backend=RemoteExecutor(workers=addrs),
                      schedule="sliding_window", tell_order="completion",
                      pruner=MedianPruner(n_startup_trials=2))
    s.optimize(_prunable, 12)
    pruned = [t for t in s.trials if t.state == TrialState.PRUNED]
    assert pruned, "expected doomed trials to be pruned inside the daemons"
    for t in pruned:
        assert t.user_attrs["steps_run"] < _PRUNE_BUDGET
        assert t.intermediate  # streamed report frames merged back
    complete = [t for t in s.trials if t.state == TrialState.COMPLETE]
    assert all(t.user_attrs["steps_run"] == _PRUNE_BUDGET for t in complete)


def test_remote_pool_quarantines_poison_trial():
    hook = _PoisonHook(1)
    servers, addrs = _start_servers(2, task_hook=hook)
    try:
        s = _remote_study(3, addrs, retries=5, quarantine_after=2)
        with pytest.warns(RuntimeWarning, match="quarantin"):
            s.optimize(_quadratic, 6)
    finally:
        for srv in servers:
            srv.stop()
    assert hook.kills == 2  # quarantined on the second death, not later
    poison = [t for t in s.trials if "quarantined" in t.user_attrs]
    assert [t.number for t in poison] == [1] and poison[0].state == TrialState.FAIL
    ref = _jax_serial(3, 6)
    done = [t for t in s.trials if t.state == TrialState.COMPLETE]
    assert len(done) == 5
    for t in done:
        assert t.values == ref.trials[t.number].values


def test_no_reachable_workers_degrades_to_fallback():
    ex = RemoteExecutor(workers=["127.0.0.1:9"], connect_timeout_s=0.2, fallback="serial")
    s = ParallelStudy(sampler=RandomSampler(seed=5), n_workers=2, backend=ex,
                      schedule="sliding_window")
    with pytest.warns(RuntimeWarning, match="degrading to local 'serial'"):
        s.optimize(_quadratic, 5)
    assert _fingerprint(s) == _fingerprint(_jax_serial(5, 5))


def test_executor_needs_a_pool_and_reads_it_from_the_environment(daemons, monkeypatch):
    _, addrs = daemons
    monkeypatch.delenv("REPRO_REMOTE_WORKERS", raising=False)
    with pytest.raises(ValueError, match="REPRO_REMOTE_WORKERS"):
        RemoteExecutor().start(1)
    monkeypatch.setenv("REPRO_REMOTE_WORKERS", ",".join(addrs))
    ex = RemoteExecutor()
    ex.start(2)
    try:
        assert sorted(ex._client.live_workers()) == sorted(addrs)
    finally:
        ex.shutdown()


def test_executor_spec_workers_plumbing_as_the_reference():
    pytest.importorskip("jax")
    from repro.explorer.experiment import ExecutorSpec as JExecutorSpec
    from repro.explorer.experiment import ExperimentError as JExperimentError
    from repro_torch.explorer.experiment import ExecutorSpec, ExperimentError

    for raw in ({"backend": "remote", "workers": ["h:7471", "g:7472"]},
                {"backend": "remote", "workers": ["h:1"],
                 "options": {"retries": 5, "fallback": "serial"}}):
        spec = ExecutorSpec.from_raw(raw)
        assert spec.to_dict() == JExecutorSpec.from_raw(raw).to_dict()
    assert ExecutorSpec.from_raw(
        {"backend": "remote", "workers": ["h:7471", "g:7472"]}).n_workers == 2
    for raw, match in (({"backend": "remote", "workers": ["h:1"],
                         "options": {"bogus": 1}}, "bogus"),
                       ({"backend": "serial", "workers": ["h:1"]}, "workers"),
                       ({"backend": "remote", "workers": ["nope"]}, "host:port"),
                       ({"backend": "remote", "workers": []}, "non-empty")):
        with pytest.raises(ExperimentError, match=match):
            ExecutorSpec.from_raw(raw)
        with pytest.raises(JExperimentError, match=match):
            JExecutorSpec.from_raw(raw)


# ---------------------------------------------------------------------------
# the document, the CLI and the environment
# ---------------------------------------------------------------------------

def _remote_yaml(tmp_path, **overrides):
    raw = yaml.safe_load(REMOTE_YAML.read_text())
    raw["search_space"] = {"file": str(REMOTE_YAML.parent / raw["search_space"]["file"])}
    raw.update(cache={"dir": str(tmp_path / "cache")}, report_dir=str(tmp_path))
    raw.update(overrides)
    return raw


def test_remote_yaml_runs_to_the_serial_best_trial(tmp_path, daemons):
    """``remote.yaml`` (conv_pool, modelled latency, peak counted on
    ``meta``, host_cpu) through two daemons and serially: the same trials,
    values and best trial."""
    servers, addrs = daemons
    serial = Explorer.from_dict(_remote_yaml(tmp_path / "s", executor="serial"),
                                device="cpu")
    sreport = serial.run(save_report=False)
    remote = Explorer.from_dict(_remote_yaml(
        tmp_path / "r", executor={"backend": "remote", "workers": addrs}), device="cpu")
    rreport = remote.run(save_report=False)
    assert rreport.backend == "remote" and rreport.n_trials == sreport.n_trials == 12
    assert rreport.best == sreport.best
    assert _fingerprint(remote.study) == _fingerprint(serial.study)
    assert sum(srv.tasks_done for srv in servers) == 12


@pytest.mark.parametrize("how", ["cli", "env"])
def test_remote_workers_flag_and_environment_select_the_pool(tmp_path, daemons,
                                                             monkeypatch, how):
    from repro_torch.explorer.__main__ import main

    servers, addrs = daemons
    raw = _remote_yaml(tmp_path, budget={"n_trials": 3},
                       executor={"backend": "serial"} if how == "cli" else "remote")
    path = tmp_path / "exp.yaml"
    path.write_text(yaml.safe_dump(raw))
    argv = [str(path), "--device", "cpu"]
    if how == "cli":
        monkeypatch.delenv("REPRO_REMOTE_WORKERS", raising=False)
        argv += ["--remote-workers", ",".join(addrs)]
    else:
        monkeypatch.setenv("REPRO_REMOTE_WORKERS", ",".join(addrs))
    assert main(argv) == 0
    report = json.loads((tmp_path / "hw-remote.report.json").read_text())
    assert report["backend"] == "remote" and report["n_trials"] == 3
    assert sum(srv.tasks_done for srv in servers) == 3


# ---------------------------------------------------------------------------
# the sweep's cell fan-out
# ---------------------------------------------------------------------------

def test_sweep_fanned_across_daemons_equals_local_and_jax_fanned(tmp_path, daemons):
    """The tiny analytic sweep ([host_cpu, edge_npu] x [random 0, grid 0])
    fanned across two port daemons merges key for key as the port's local
    run and as the JAX package's run fanned across two JAX daemons; the
    parent persisted each cell's report, so a re-run resumes them all."""
    pytest.importorskip("jax")
    from repro.explorer import sweep as jsweep
    from repro.search.remote.worker import WorkerServer as JWorkerServer

    servers, addrs = daemons
    fanned = run_sweep(SweepSpec.from_dict(make_sweep(tmp_path / "fanned")),
                       workers=addrs, device="cpu")
    assert sum(srv.tasks_done for srv in servers) == fanned.n_cells == 4
    local = run_sweep(SweepSpec.from_dict(make_sweep(tmp_path / "local")), device="cpu")
    assert _comparable(fanned) == _comparable(local)
    jservers, jaddrs = _start_servers(2, cls=JWorkerServer)
    try:
        jfanned = jsweep.run_sweep(jsweep.SweepSpec.from_dict(make_sweep(tmp_path / "j")),
                                   save_report=False, workers=jaddrs)
    finally:
        for srv in jservers:
            srv.stop()
    assert _comparable(fanned) == _comparable(jfanned)
    spec = SweepSpec.from_dict(make_sweep(tmp_path / "fanned"))
    for cell in spec.expand():
        assert Path(cell.report_path).is_file()
    again = run_sweep(spec, workers=addrs, device="cpu")
    assert again.n_resumed == 4 and again.matrix == fanned.matrix
    assert sum(srv.tasks_done for srv in servers) == 4


def test_sweep_cell_failing_remotely_runs_locally(tmp_path):
    """A pool whose daemon drops every task: the client gives up on each
    cell after its retries, and the sweep runs the cells locally."""
    def die(task_id, task):
        raise DropConnection()

    servers, addrs = _start_servers(1, task_hook=die)
    try:
        raw = make_sweep(tmp_path, axes={"targets": ["host_cpu"]})
        with pytest.warns(RuntimeWarning, match="re-running it locally"):
            report = run_sweep(SweepSpec.from_dict(copy.deepcopy(raw)), workers=addrs,
                               device="cpu")
    finally:
        for srv in servers:
            srv.stop()
    local = run_sweep(SweepSpec.from_dict(dict(raw, report_dir=str(tmp_path / "l"))),
                      save_report=False, device="cpu")
    assert [c["best"] for c in report.cells] == [c["best"] for c in local.cells]


def test_run_cell_runs_on_the_cells_device(tmp_path):
    """A fanned cell carries its target's device: a host_cpu cell runs on
    the CPU, and an h100 cell on a machine without a card fails with the
    device's own error (which the sweep then reruns locally)."""
    from repro_torch.device import NoCudaCardError
    from repro_torch.explorer.sweep import _run_cell

    spec = SweepSpec.from_dict(make_sweep(tmp_path, axes={"targets": ["host_cpu", "h100"]}))
    cpu_cell, cuda_cell = spec.expand()
    assert (cpu_cell.device, cuda_cell.device) == ("cpu", "cuda")
    report = _run_cell(cpu_cell.spec.to_dict(), cpu_cell.device)
    assert report["device"] == "cpu" and report["n_trials"] == 6
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaCardError):
            _run_cell(cuda_cell.spec.to_dict(), cuda_cell.device)
