"""The port's fidelity cascade on the CPU, case for case with the JAX
package's ``tests/test_cascade.py`` (keep rules, staged screening, the
``fidelity:`` spec section, fixed-seed determinism across every backend
and schedule; its proxy cases are in ``tests/test_torch_proxies.py``),
plus ``cascade.yaml`` through both facades with the port's synflow on the
reference's weights, and the fidelity reference tables."""
import copy

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
yaml = pytest.importorskip("yaml")

from test_torch_proxies import EXPERIMENTS, TINY_SPACE, _jax_weights, build_tiny_models  # noqa: E402

from repro_torch.evaluation.api import (  # noqa: E402
    CriteriaRunner, Estimator, OptimizationCriteria, constraint_violation, weighted_sum)
from repro_torch.evaluation.cascade import CascadeRunner, FidelityStage, KeepRule  # noqa: E402
from repro_torch.evaluation.estimators import FlopsEstimator, ParamCountEstimator  # noqa: E402
from repro_torch.evaluation.proxies import SynFlowEstimator  # noqa: E402
from repro_torch.explorer.experiment import ExperimentError, ExperimentSpec  # noqa: E402
from repro_torch.explorer.explorer import Explorer  # noqa: E402
from repro_torch.hwgen import generator as tgen  # noqa: E402
from repro_torch.search.study import HardConstraintViolated  # noqa: E402

CASCADE_EXPERIMENT = {
    "name": "cascade-tiny",
    "search_space": TINY_SPACE,
    "sampler": {"name": "random", "seed": 7},
    "executor": {"backend": "serial"},
    "criteria": [{"estimator": "flops", "kind": "objective"}],
    "fidelity": {
        "generation": 8,
        "stages": [
            {"name": "zero_cost",
             "criteria": [{"estimator": "synflow", "kind": "objective",
                           "direction": "minimize"}],
             "keep": {"top_frac": 0.5}},
        ],
    },
    "budget": {"n_trials": 16},
}


@pytest.fixture(autouse=True)
def _fresh_generate_count(monkeypatch):
    """Each test starts from a process generate count of 0, as a fresh
    process does.  The funnel's ``compiled`` sums the process's running
    :func:`~repro_torch.hwgen.generator.generate_call_count`, so without
    this the ``compiled == 0`` checks would read what earlier tests in the
    same worker generated."""
    monkeypatch.setattr(tgen, "_generate_count", 0)


class FixedEstimator(Estimator):
    def __init__(self, name, values):
        self.name = name
        self.values = dict(values)  # id(candidate) -> value

    def estimate(self, candidate, context=None):
        return self.values[id(candidate)]


# ---------------------------------------------------------------------------
# keep rules
# ---------------------------------------------------------------------------

def test_keep_rule_requires_exactly_one_field():
    with pytest.raises(ValueError, match="exactly one"):
        KeepRule()
    with pytest.raises(ValueError, match="exactly one"):
        KeepRule(top_k=2, top_frac=0.5)
    with pytest.raises(ValueError, match="top_k"):
        KeepRule(top_k=0)
    with pytest.raises(ValueError, match="top_frac"):
        KeepRule(top_frac=1.5)


def test_keep_rule_survivor_semantics():
    scored = [(0, 3.0), (1, 1.0), (2, 2.0), (3, 1.0)]
    # top_k ranks by (score, index): the tie at 1.0 keeps ask order
    assert KeepRule(top_k=2).survivors(scored) == [1, 3]
    # top_frac keeps ceil(frac * n), at least one
    assert KeepRule(top_frac=0.5).survivors(scored) == [1, 3]
    assert KeepRule(top_frac=0.01).survivors(scored) == [1]
    # threshold is per-candidate, cohort-independent
    assert KeepRule(threshold=2.0).survivors(scored) == [1, 2, 3]
    assert KeepRule(threshold=0.5).survivors(scored) == []


# ---------------------------------------------------------------------------
# cascade runner construction + screening
# ---------------------------------------------------------------------------

def test_cascade_validates_stage_structure():
    crit = [OptimizationCriteria(FlopsEstimator())]
    with pytest.raises(ValueError, match="at least one stage"):
        CascadeRunner([])
    with pytest.raises(ValueError, match="keep rule"):
        CascadeRunner([FidelityStage("screen", crit),
                       FidelityStage("final",
                                     [OptimizationCriteria(ParamCountEstimator())])])
    with pytest.raises(ValueError, match="must not have a keep rule"):
        CascadeRunner([FidelityStage("final", crit, keep=KeepRule(top_k=1))])
    with pytest.raises(ValueError, match="duplicate fidelity stage"):
        CascadeRunner([
            FidelityStage("s", crit, keep=KeepRule(top_k=1)),
            FidelityStage("s", [OptimizationCriteria(ParamCountEstimator())]),
        ])
    # estimator names must be distinct across the WHOLE cascade
    with pytest.raises(ValueError, match="share estimator name"):
        CascadeRunner([
            FidelityStage("screen", crit, keep=KeepRule(top_k=1)),
            FidelityStage("final", [OptimizationCriteria(FlopsEstimator())]),
        ])


def test_single_stage_cascade_is_flat_runner():
    models = build_tiny_models(3)
    criteria = [OptimizationCriteria(FlopsEstimator()),
                OptimizationCriteria(ParamCountEstimator(), weight=0.1)]
    flat = CriteriaRunner(criteria)
    cascade = CascadeRunner([FidelityStage("final", criteria)])
    for m in models:
        assert cascade.evaluate(m) == flat.evaluate(m)
        assert cascade.evaluate_multi(m) == flat.evaluate_multi(m)
    result = cascade.screen_cohort(models)
    assert result.promoted == [0, 1, 2]
    assert result.screened == {} and result.infeasible == {}


def test_screen_cohort_promotes_screens_and_rejects():
    models = build_tiny_models(4)
    proxy = FixedEstimator("proxy", {id(m): float(i) for i, m in enumerate(models)})
    gate = FixedEstimator("gate", {id(m): float(i) for i, m in enumerate(models)})
    runner = CascadeRunner([
        FidelityStage("screen", [
            OptimizationCriteria(gate, kind="hard_constraint", limit=2.5),
            OptimizationCriteria(proxy),
        ], keep=KeepRule(top_k=2)),
        FidelityStage("final", [OptimizationCriteria(FlopsEstimator())]),
    ])
    result = runner.screen_cohort(models)
    # index 3 violates the hard gate (3.0 > 2.5) before ranking
    assert result.infeasible.keys() == {3}
    stage, exc = result.infeasible[3]
    assert stage == "screen" and isinstance(exc, HardConstraintViolated)
    # of the feasible 0..2, top_k=2 by proxy score keeps 0 and 1
    assert result.promoted == [0, 1]
    assert result.screened == {2: "screen"}
    assert result.counts == {"promoted": 2, "screened": 1, "infeasible": 1}


def test_maximize_hard_constraint_violates_below_limit():
    models = build_tiny_models(1)
    acc = FixedEstimator("val_accuracy", {id(models[0]): 0.8})
    runner = CriteriaRunner([
        OptimizationCriteria(acc, kind="hard_constraint", direction="maximize", limit=0.9),
        OptimizationCriteria(FlopsEstimator()),
    ])
    with pytest.raises(HardConstraintViolated):
        runner.evaluate(models[0])
    # the same value SATISFIES a minimize constraint with the same limit
    runner_min = CriteriaRunner([
        OptimizationCriteria(FixedEstimator("v", {id(models[0]): 0.8}),
                             kind="hard_constraint", limit=0.9),
        OptimizationCriteria(FlopsEstimator()),
    ])
    runner_min.evaluate(models[0])


def test_maximize_soft_constraint_hinge_direction():
    c = OptimizationCriteria(FixedEstimator("acc", {}), kind="soft_constraint",
                             direction="maximize", limit=0.9)
    assert constraint_violation(c, 0.8) > 0.0   # below the floor: violated
    assert constraint_violation(c, 0.95) < 0.0  # above: satisfied
    # hinge enters weighted_sum only when violated
    assert weighted_sum({"acc": 0.95}, [c]) == 0.0
    assert weighted_sum({"acc": 0.8}, [c]) > 0.0


def test_staged_iteration_shared_between_paths():
    """Hard constraints run before objectives in BOTH evaluate paths —
    the expensive objective estimator must never run on a violator."""
    models = build_tiny_models(1)

    class Exploding(Estimator):
        name = "expensive"

        def estimate(self, candidate, context=None):
            raise AssertionError("objective ran despite hard violation")

    runner = CriteriaRunner([
        OptimizationCriteria(Exploding()),
        OptimizationCriteria(FixedEstimator("gate", {id(models[0]): 1.0}),
                             kind="hard_constraint", limit=0.5),
    ])
    with pytest.raises(HardConstraintViolated):
        runner.evaluate(models[0])
    with pytest.raises(HardConstraintViolated):
        runner.evaluate_multi(models[0])


# ---------------------------------------------------------------------------
# fidelity spec validation
# ---------------------------------------------------------------------------

def make_cascade_experiment(tmp_path, **overrides):
    raw = copy.deepcopy(CASCADE_EXPERIMENT)
    raw["report_dir"] = str(tmp_path / "results")
    raw.update(copy.deepcopy(overrides))
    return raw


def test_fidelity_spec_round_trips(tmp_path):
    spec = ExperimentSpec.from_dict(make_cascade_experiment(tmp_path))
    again = ExperimentSpec.from_dict(spec.to_dict())
    assert again.to_dict()["fidelity"] == spec.to_dict()["fidelity"]
    assert spec.fidelity.generation == 8
    assert spec.fidelity.stages[0].keep.top_frac == 0.5


@pytest.mark.parametrize("mutation, message", [
    ({"fidelity": {"generation": 8, "stages": []}}, "non-empty list"),
    ({"fidelity": {"stages": [{"name": "final", "criteria": [
        {"estimator": "synflow"}], "keep": {"top_k": 1}}]}}, "reserved"),
    ({"fidelity": {"stages": [{"name": "s", "criteria": [
        {"estimator": "synflow"}],
        "keep": {"top_k": 1, "top_frac": 0.5}}]}}, "exactly one"),
    ({"fidelity": {"stages": [{"name": "s", "criteria": [
        {"estimator": "synflow"}], "keep": {"bogus": 1}}]}}, "unknown"),
    ({"fidelity": {"stages": [{"name": "s", "criteria": [
        {"estimator": "flops"}], "keep": {"top_k": 1}}]}},
     "share estimator name|flops"),
])
def test_fidelity_spec_rejects_bad_configs(tmp_path, mutation, message):
    with pytest.raises((ExperimentError, ValueError), match=message):
        ExperimentSpec.from_dict(make_cascade_experiment(tmp_path, **mutation))


def test_fidelity_reference_tables_are_the_references():
    """The port renders the fidelity sections of the experiment reference
    from its own spec metadata, word for word as the JAX package does."""
    pytest.importorskip("jax")
    from repro.explorer.docgen import experiment_spec_markdown
    from repro_torch.explorer.docgen import fidelity_markdown, list_components_text

    tables = fidelity_markdown()
    assert "## `fidelity.stages[i].keep`" in tables
    assert tables in experiment_spec_markdown()
    listed = list_components_text()
    assert "synflow              SynFlowEstimator" in listed
    assert "grad_norm            GradNormEstimator" in listed


# ---------------------------------------------------------------------------
# fixed-seed determinism across backends and schedules
# ---------------------------------------------------------------------------

def _outcome(explorer, report):
    study = explorer.study
    return {
        "funnel": report.fidelity["funnel"],
        "screened": sorted(t.number for t in study.trials
                           if t.user_attrs.get("fidelity_stage") == "zero_cost"),
        "promoted": sorted(t.number for t in study.trials
                           if t.user_attrs.get("fidelity_stage") == "promoted"),
        "best_number": report.best["number"],
        "best_values": report.best["values"],
        "states": report.states,
    }


def run_cascade(tmp_path, backend, schedule, n_workers=2):
    raw = make_cascade_experiment(
        tmp_path,
        executor={"backend": backend, "n_workers": 1 if backend == "serial" else n_workers},
        schedule={"mode": schedule},
    )
    explorer = Explorer.from_dict(raw, device="cpu")
    return _outcome(explorer, explorer.run(save_report=False))


@pytest.mark.parametrize("backend", ("serial", "thread", "process"))
@pytest.mark.parametrize("schedule", ("batch", "sliding_window"))
def test_cascade_deterministic_across_backends(tmp_path, backend, schedule):
    reference = run_cascade(tmp_path / "ref", "serial", "batch")
    assert reference["funnel"]["asked"] == 16
    assert reference["funnel"]["screened"] == 8
    assert reference["funnel"]["promoted"] == 8
    assert run_cascade(tmp_path / "run", backend, schedule) == reference


def test_cascade_report_funnel_and_spearman(tmp_path):
    explorer = Explorer.from_dict(make_cascade_experiment(tmp_path), device="cpu")
    report = explorer.run(save_report=False)
    funnel = report.fidelity["funnel"]
    assert funnel["asked"] == 16
    assert funnel["screened"] + funnel["promoted"] + funnel["infeasible"] == 16
    # the final stage here is analytic — nothing may be generated at all
    assert funnel["compiled"] == 0
    rho = report.fidelity["spearman"]["zero_cost"]
    assert rho is None or -1.0 <= rho <= 1.0
    # screened trials carry the stage score attr for the correlation
    scored = [t for t in explorer.study.trials if "fidelity_score:zero_cost" in t.user_attrs]
    assert len(scored) == 16
    assert report.to_dict()["fidelity"]["funnel"] == funnel


def test_cascade_yaml_screens_and_promotes_as_the_reference(tmp_path, monkeypatch):
    """``examples/experiments/cascade.yaml`` through both facades, the final
    criterion set to ``flops`` (analytic, so both agree) and the port's
    synflow on the reference's weights: the same screened set, funnel
    (but ``compiled``), promoted trials and best trial.  The port's run is
    the CLI's acceptance: 32 asked, ceil(0.25 x 16) = 4 promoted from each
    cohort, nothing generated."""
    pytest.importorskip("jax")
    from repro.explorer.experiment import ExperimentSpec as JSpec
    from repro.explorer.explorer import Explorer as JExplorer

    raw = yaml.safe_load((EXPERIMENTS / "cascade.yaml").read_text())
    raw["criteria"] = [{"estimator": "flops", "kind": "objective"}]
    raw["report_dir"] = str(tmp_path)
    jx = JExplorer(JSpec.from_dict(raw))
    want = _outcome(jx, jx.run(save_report=False))
    monkeypatch.setattr(SynFlowEstimator, "_weights",
                        lambda self, candidate: _jax_weights(candidate))
    tx = Explorer.from_dict(raw, device="cpu")
    got = _outcome(tx, tx.run(save_report=False))
    assert got["funnel"]["compiled"] == 0
    assert {k: v for k, v in got["funnel"].items() if k != "compiled"} == \
        {k: v for k, v in want["funnel"].items() if k != "compiled"}
    assert got["funnel"]["asked"] == 32 and got["funnel"]["promoted"] == 2 * 4
    for key in ("screened", "promoted", "best_number", "states"):
        assert got[key] == want[key], key
    assert got["best_values"] == pytest.approx(want["best_values"])
