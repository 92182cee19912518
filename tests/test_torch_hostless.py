"""A submitting host without a card (ROADMAP Queue 3 item 4): with
``executor: remote`` the port's ``Explorer`` takes ``device="cpu"`` for a
CUDA target and the daemons run every candidate, as the reference's
``Explorer`` checks no device.  The cases run where there is no card
(they skip where there is one), so each runs as a card-less host would: ``metric: modelled`` latency counts
on ``meta`` in the daemons and needs no card, the ``fidelity`` screen runs
in the parent on its CPU, and the remote run gives a local serial run's
trials (an ``h100`` twin whose candidates run on the CPU).  Every local
executor still refuses the combination; an unreachable pool raises rather
than measure here; a sweep's CUDA cells run only on its pool; a daemon
without a card fails a CUDA trial with the device's own error."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers

from repro_torch.device import NoCudaCardError  # noqa: E402
from repro_torch.explorer.experiment import ExperimentError  # noqa: E402
from repro_torch.explorer.explorer import Explorer  # noqa: E402
from repro_torch.explorer.registry import TARGETS  # noqa: E402
from repro_torch.explorer.sweep import SweepError, SweepSpec, run_sweep  # noqa: E402
from repro_torch.hwgen.generator import generate_call_count  # noqa: E402
from repro_torch.search.remote.worker import WorkerServer  # noqa: E402
from test_torch_sweep import TINY_SPACE, make_sweep  # noqa: E402

pytestmark = pytest.mark.skipif(torch.cuda.is_available(),
                                reason="checks a host without a card")


def _spec(tmp_path, target="h100", **overrides):
    """The tiny conv space at ``target``: modelled latency (counted on
    ``meta``, no card needed) behind a synflow screen, 8 trials."""
    raw = {
        "name": "hostless",
        "search_space": TINY_SPACE,
        "sampler": {"name": "random", "seed": 3},
        "executor": {"backend": "serial"},
        "target": target,
        "criteria": [{"estimator": "latency_s", "kind": "objective",
                      "params": {"batch": 2, "metric": "modelled"}}],
        "fidelity": {"generation": 4, "stages": [{
            "name": "zero_cost", "keep": {"top_frac": 0.5},
            "criteria": [{"estimator": "synflow", "kind": "objective",
                          "direction": "minimize"}]}]},
        "budget": {"n_trials": 8},
        "report_dir": str(tmp_path),
    }
    raw.update(overrides)
    return raw


@pytest.fixture
def daemons():
    servers = [WorkerServer() for _ in range(2)]
    addrs = ["%s:%d" % s.start() for s in servers]
    yield servers, addrs
    for s in servers:
        s.stop()


def _trials(explorer):
    return [(t.number, t.state.value, t.params, t.values) for t in explorer.study.trials]


def test_card_less_host_runs_a_cuda_target_on_its_daemons(tmp_path, daemons, monkeypatch):
    """An ``h100`` study from this card-less process under ``--device cpu``
    through two daemons: every promoted trial runs in a daemon, the screen
    runs here, the report names the daemons' device, and the trials,
    values and best trial are those of a local serial run on the CPU of an
    ``h100`` twin (the same chip, its candidates on the CPU).  The CLI
    takes the same study as a JSON file with ``--remote-workers``."""
    from repro_torch.explorer.__main__ import main

    servers, addrs = daemons
    remote = Explorer.from_dict(_spec(tmp_path / "r", executor={
        "backend": "remote", "workers": addrs}), device="cpu")
    assert remote.hostless and remote.device.type == "cpu"
    report = remote.run(save_report=False)
    twin = dataclasses.replace(TARGETS.get("h100"), name="h100_on_cpu", device="cpu")
    monkeypatch.setitem(TARGETS._entries, "h100_on_cpu", twin)
    local = Explorer.from_dict(_spec(tmp_path / "l", target="h100_on_cpu"), device="cpu")
    lreport = local.run(save_report=False)
    assert report.device == "cuda" and lreport.device == "cpu"
    assert report.fidelity["funnel"] == lreport.fidelity["funnel"]
    promoted = report.fidelity["funnel"]["promoted"]
    assert 0 < promoted < 8 and sum(s.tasks_done for s in servers) == promoted
    assert _trials(remote) == _trials(local)
    assert report.best == lreport.best and report.kernel_launches == {}
    assert remote._host_objective.host_device == "cpu"
    assert remote._host_objective.tuner is None

    path = tmp_path / "exp.json"
    path.write_text(json.dumps(_spec(tmp_path / "cli", budget={"n_trials": 4})))
    assert main([str(path), "--device", "cpu", "--remote-workers", ",".join(addrs)]) == 0
    cli = json.loads((tmp_path / "cli" / "hostless.report.json").read_text())
    assert cli["backend"] == "remote" and cli["device"] == "cuda"
    assert cli["states"] == {"complete": cli["fidelity"]["funnel"]["promoted"],
                             "screened": 4 - cli["fidelity"]["funnel"]["promoted"]}


@pytest.mark.parametrize("backend", ["serial", "thread", "process"])
def test_every_local_executor_refuses_a_cuda_target_on_the_cpu(tmp_path, backend):
    """Only the remote executor lets a host ask for the CPU at a CUDA
    target: a local executor would run the candidates here."""
    raw = _spec(tmp_path, executor={"backend": backend})
    with pytest.raises(ExperimentError, match="h100.*executor: remote"):
        Explorer.from_dict(raw, device="cpu")
    with pytest.raises(NoCudaCardError):
        Explorer.from_dict(raw)


def test_unreachable_pool_raises_instead_of_measuring_here(tmp_path):
    """No daemon answers: a card-less host at a CUDA target raises the
    device's error naming the workers, where a host that could run the
    trials degrades to its local fallback; nothing is generated."""
    before = generate_call_count()
    explorer = Explorer.from_dict(_spec(tmp_path, executor={
        "backend": "remote", "workers": ["127.0.0.1:9"],
        "options": {"connect_timeout_s": 0.2}}), device="cpu")
    with pytest.raises(NoCudaCardError, match=r"127\.0\.0\.1:9.*cannot run the trials"):
        explorer.run(save_report=False)
    assert generate_call_count() == before
    cpu = Explorer.from_dict(_spec(tmp_path, target="host_cpu", budget={"n_trials": 4},
                                   executor={"backend": "remote", "workers": ["127.0.0.1:9"],
                                             "options": {"connect_timeout_s": 0.2,
                                                         "fallback": "serial"}}),
                             device="cpu")
    with pytest.warns(RuntimeWarning, match="degrading to local 'serial'"):
        assert cpu.run(save_report=False).n_trials == 4


def test_sweep_runs_cuda_cells_only_on_its_pool(tmp_path, daemons):
    """Under ``--device cpu`` an h100 cell is refused at expansion unless
    a cell pool is given; with one, the cell runs only there.  These
    daemons have no card either: the h100 cell fails in its daemon with
    the device's error, and the sweep raises before persisting or running
    any cell here; an unreachable pool raises likewise."""
    servers, addrs = daemons
    raw = make_sweep(tmp_path, axes={"targets": ["host_cpu", "h100"]})
    with pytest.raises(SweepError, match="h100.*--cell-workers"):
        SweepSpec.from_dict(raw).expand(device="cpu")
    cells = SweepSpec.from_dict(raw).expand(device="cpu", pool=True)
    assert [c.device for c in cells] == ["cpu", "cuda"]
    for pool in (addrs, ["127.0.0.1:9"]):
        spec = SweepSpec.from_dict(raw)
        with pytest.warns(RuntimeWarning), \
                pytest.raises(SweepError, match=r"tiny--target=h100.*did not complete"):
            run_sweep(spec, workers=pool, device="cpu")
        assert not (tmp_path / "results").exists()
    assert sum(s.tasks_done for s in servers) == 2


def test_daemon_without_a_card_fails_a_cuda_trial(tmp_path, daemons):
    """A measured ``latency_s`` at h100 sent to daemons that have no card
    (as ``python -m repro_torch.worker --device cpu`` hides it): the trial
    fails in the daemon with the device's own error, which the run
    raises; nothing is placed or measured on the CPU."""
    servers, addrs = daemons
    raw = _spec(tmp_path, executor={"backend": "remote", "workers": addrs},
                criteria=[{"estimator": "latency_s", "kind": "objective"}])
    raw.pop("fidelity")
    before = generate_call_count()
    with pytest.raises(NoCudaCardError, match="no CUDA card"):
        Explorer.from_dict(raw, device="cpu").run(save_report=False)
    assert generate_call_count() == before
    assert sum(s.tasks_done for s in servers) >= 1
