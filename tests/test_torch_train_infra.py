"""The training substrate against the JAX package on the CPU: gradient
compression (against the reference, and its error-feedback bounds), the
synthetic data and the prefetcher (array for array), the checkpoint
layout on disk (each package restores the other's), and the
``val_accuracy`` estimator on two candidates of the paper's Listing 3
(``examples/nas_conv1d.py``) with the reference's initial weights
injected: the same accuracy and the same reported intermediate values;
and its refusal of a candidate that reaches a kernel."""
import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.distributed.compression import GradientCompressor as JCompressor  # noqa: E402
from test_torch_proxies import _jax_twin, _jax_weights, _kernel_candidate, build_tiny_models  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.distributed.compression import GradientCompressor  # noqa: E402
from repro_torch.evaluation.estimators import TrainedAccuracyEstimator  # noqa: E402
from repro_torch.explorer.registry import ESTIMATORS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the quantized gradients and error states: the same int8 rounding of the
# same fp32 blocks, so equal but for a value at a rounding tie
COMPRESS_ATOL = 1e-7


def _listing3_space():
    """``SPACE_YAML`` of ``examples/nas_conv1d.py`` (the example imports
    JAX, so its constant is read from the source)."""
    tree = ast.parse((ROOT / "examples" / "nas_conv1d.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SPACE_YAML":
            return yaml.safe_load(node.value.value)
    raise AssertionError("no SPACE_YAML in examples/nas_conv1d.py")


def _listing3_data():
    """The example's data, as the reference's pipeline draws it."""
    return jdata.SyntheticClassificationData(n=480, length=1250, channels=4, classes=6).split()


# -- gradient compression ---------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((37, 29)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal(300) * 1e-3).astype(np.float32),
            "z": np.zeros(5, np.float32)}


def test_compressor_matches_jax_over_three_steps():
    """Three steps of error feedback, on leaves that pad (1073 and 300
    entries in blocks of 256) and one of zeros."""
    jc, tc = JCompressor(), GradientCompressor()
    jerr, terr = None, None
    for step in range(3):
        g = _grads(step)
        jout, jerr = jc.compress_decompress({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tout, terr = tc.compress_decompress({k: torch.from_numpy(v) for k, v in g.items()}, terr)
        for k in g:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=COMPRESS_ATOL, rtol=0)
            np.testing.assert_allclose(terr[k].numpy(), np.asarray(jerr[k]), atol=COMPRESS_ATOL, rtol=0)
            assert tout[k].dtype == torch.float32 and terr[k].dtype == torch.float32
    assert float(tout["z"].abs().max()) == 0.0


def test_compression_error_feedback_bounded():
    comp = GradientCompressor()
    grads = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))}
    out, err = comp.compress_decompress(grads, comp.init_state(grads))
    # int8 block quantization: elementwise error bounded by scale/2
    scale = float(grads["w"].abs().max()) / 127
    assert float((out["w"] - grads["w"]).abs().max()) <= scale * 1.01
    # error feedback: residual carried, not lost
    assert float(err["w"].abs().max()) > 0


def test_compression_error_feedback_unbiased_over_steps():
    """Accumulated (quantized) updates converge to accumulated true grads."""
    comp = GradientCompressor()
    g = {"w": torch.tensor([0.001, -0.003, 0.5, 1.0])}  # tiny + large entries
    err = comp.init_state(g)
    total = torch.zeros(4)
    for _ in range(50):
        out, err = comp.compress_decompress(g, err)
        total = total + out["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(), atol=2e-3)


# -- data -------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts, host_id", [(1, 0), (2, 1)])
def test_synthetic_lm_data_equals_the_reference(n_hosts, host_id):
    kw = dict(vocab=151936, seq=64, global_batch=4, seed=3, n_hosts=n_hosts, host_id=host_id)
    ours, theirs = tdata.SyntheticLMData(**kw), jdata.SyntheticLMData(**kw)
    for step in (0, 1, 17):
        got, want = ours.batch_at(step), theirs.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_classification_data_and_prefetcher_equal_the_reference():
    kw = dict(n=96, length=200, channels=3, classes=4, seed=5)
    got, want = tdata.SyntheticClassificationData(**kw).split(), jdata.SyntheticClassificationData(**kw).split()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    source = tdata.SyntheticLMData(vocab=64, seq=8, global_batch=2)
    pf = tdata.Prefetcher(source, start_step=10)
    try:
        items = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in items] == [10, 11, 12, 13]
    reference = jdata.SyntheticLMData(vocab=64, seq=8, global_batch=2)
    for step, batch in items:
        assert np.array_equal(batch["tokens"], reference.batch_at(step)["tokens"])


# -- the checkpoint layout ----------------------------------------------------------

def test_each_package_restores_the_others_checkpoint(tmp_path):
    """The layout on disk is the reference's: ``step_<10 digits>/``, a
    manifest, one ``.npy`` a leaf in sorted key order."""
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": np.zeros(3, np.float32)},
            "opt": {"step": np.int32(7), "mu": {"w": np.ones((4, 3), np.float32)}}}
    JCheckpointer(str(tmp_path / "jax")).save(3, jax.tree_util.tree_map(jnp.asarray, tree))
    Checkpointer(str(tmp_path / "port")).save(3, jax.tree_util.tree_map(torch.from_numpy, {
        **tree, "opt": {**tree["opt"], "step": np.array(7, np.int32)}}))
    for side in ("jax", "port"):
        assert sorted(p.name for p in (tmp_path / side).iterdir()) == ["step_0000000003"]
    want = (tmp_path / "jax" / "step_0000000003" / "manifest.json").read_text()
    got = (tmp_path / "port" / "step_0000000003" / "manifest.json").read_text()
    def leaves(manifest):
        return [(e["key"], e["file"], e["shape"], e["dtype"]) for e in json.loads(manifest)["leaves"]]

    assert leaves(got) == leaves(want)
    step, restored = Checkpointer(str(tmp_path / "jax")).restore(
        like=jax.tree_util.tree_map(torch.from_numpy, {**tree, "opt": {**tree["opt"],
                                                                      "step": np.array(0, np.int32)}}))
    assert step == 3 and torch.equal(restored["params"]["w"], torch.from_numpy(tree["params"]["w"]))
    assert int(restored["opt"]["step"]) == 7
    step, back = JCheckpointer(str(tmp_path / "port")).restore(like=tree)
    assert step == 3 and np.array_equal(np.asarray(back["opt"]["mu"]["w"]), tree["opt"]["mu"]["w"])


# -- val_accuracy -------------------------------------------------------------------

class RecordingTrial:
    """A trial that records what is reported and never prunes."""

    def __init__(self):
        self.reports = []

    def report(self, step, value):
        self.reports.append((step, float(value)))

    def should_prune(self):
        return False


class JaxInitAccuracy(TrainedAccuracyEstimator):
    """The port's estimator from the reference's ``init(PRNGKey(0))``."""

    def _weights(self, candidate):
        return _jax_weights(candidate)


def test_val_accuracy_is_registered_and_runs_on_the_card_unless_asked_for_the_cpu():
    from repro_torch.device import NoCudaCardError
    from repro_torch.evaluation import TrainedAccuracyEstimator as exported

    assert ESTIMATORS.get("val_accuracy") is TrainedAccuracyEstimator is exported
    if torch.cuda.is_available():
        assert TrainedAccuracyEstimator().device.type == "cuda"
    else:
        with pytest.raises(NoCudaCardError):
            TrainedAccuracyEstimator()
    with pytest.raises(ValueError, match="context"):
        TrainedAccuracyEstimator(device="cpu").estimate(build_tiny_models(1)[0], {})


@pytest.mark.parametrize("index", [0, 1])
def test_val_accuracy_equals_the_reference_on_listing3_candidates(index):
    """Two candidates of Listing 3's space (sampled at seed 2) trained 40
    steps on the example's data from the reference's initial weights: the
    same validation accuracy, and the same value reported at steps 20 and
    40, each a count of the 96 validation samples."""
    from repro.evaluation.estimators import TrainedAccuracyEstimator as JAccuracy

    model = build_tiny_models(2, seed=2, space=_listing3_space())[index]
    data = _listing3_data()
    jtrial, ttrial = RecordingTrial(), RecordingTrial()
    want = JAccuracy(steps=40).estimate(_jax_twin(model), {"data": data, "trial": jtrial})
    ours = JaxInitAccuracy(steps=40, device="cpu")
    got = ours.estimate(model, {"data": data, "trial": ttrial})
    assert got == want and ttrial.reports == jtrial.reports
    assert [s for s, _ in ttrial.reports] == [20, 40]
    params, loss = ours.fit(model, data)
    assert np.isfinite(loss) and ours.accuracy(model, params, data["x_val"], data["y_val"]) == got


def test_val_accuracy_refuses_a_kernel_candidate_before_any_step(monkeypatch):
    """A candidate on ``impl: pallas`` reaches the SSD scan, whose CUDA
    kernel is forward-only: refused, found on ``meta``, before the weights
    are drawn or a step runs, whatever the device."""
    from repro_torch.kernels import ref

    model = _kernel_candidate("meta")

    def never(*a, **k):
        raise AssertionError("ran before the refusal")

    monkeypatch.setattr(ref, "ssm_scan_ref", never)
    monkeypatch.setattr(TrainedAccuracyEstimator, "_weights", never)
    data = {"x_train": np.zeros((4, 64, 2), np.float32), "y_train": np.zeros(4, np.int32),
            "x_val": np.zeros((2, 64, 2), np.float32), "y_val": np.zeros(2, np.int32)}
    with pytest.raises(NotImplementedError, match="forward-only") as e:
        TrainedAccuracyEstimator(device="cpu").estimate(model, {"data": data})
    assert "ssm_scan" in str(e.value)


def test_chip_smoke_listing3_is_the_examples():
    """``chip_smoke.py`` runs Listing 3 through the port's
    ``examples/torch/nas_conv1d.py``, which carries the space as a dict
    (the card's machine has no PyYAML): it is the reference example's."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke._example("nas_conv1d").SPACE == _listing3_space()
