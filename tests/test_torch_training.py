"""The port's trainer without JAX: the checkpointer's behaviours (those of
``tests/test_checkpoint.py``, the restore placing leaves on the caller's
device), the straggler monitor and retries, the train CLI on the CPU
(resume after a kill, compression, a preemption's flush resuming to the
uninterrupted run's loss bit for bit, the refusals), and, marked
``cuda``, the train step and ``val_accuracy`` on the card against the
CPU at smoke size."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.distributed.fault import PreemptionHandler, StragglerMonitor, with_retries  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--seq", "32", "--global-batch", "2",
         "--device", "cpu"]
# the card against the CPU at smoke size, fp32 with TF32 off, the sums in
# another order: the loss relative to itself, each gradient and each
# parameter after one AdamW step of its tensor's max (or of 1e-3 of the
# tree's largest, where a gradient is zero analytically and noise)
CARD_REL = 1e-4


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=gen), "b": torch.zeros(4)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32), "mu": {"w": torch.ones((8, 4))}}}


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the checkpointer ---------------------------------------------------------------

def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    tree["params"]["half"] = torch.randn((3, 2)).to(torch.bfloat16)
    ck.save(10, tree)
    step, restored = ck.restore(like=tree)
    assert step == 10
    _equal_trees(tree, restored)
    assert sorted(os.listdir(tmp_path / "step_0000000010"))[-1] == "manifest.json"


def test_retention_keeps_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree())
    assert ck.all_steps() == [3, 4]


def test_async_save_then_wait(tmp_path):
    """The snapshot is taken at the call: a tensor changed in place after
    ``save_async`` (as the trainer's update does) is saved as it was."""
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    before = tree["params"]["w"].clone()
    ck.save_async(5, tree)
    tree["params"]["w"].add_(1.0)
    ck.save_async(6, tree)
    ck.wait()
    assert ck.latest_step() == 6
    assert torch.equal(ck.restore(5, like=tree)[1]["params"]["w"], before)


def test_atomicity_tmp_dirs_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(1, tree)
    # a writer dying mid-checkpoint
    os.makedirs(tmp_path / "step_0000000002.tmp")
    (tmp_path / "step_0000000002.tmp" / "junk").write_text("partial")
    assert ck.latest_step() == 1
    assert ck.restore(like=tree)[0] == 1


def test_restore_missing_leaf_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(like={"a": torch.zeros(2), "b": torch.zeros(3)})


def test_restore_places_leaves_on_the_callers_device(tmp_path):
    """Restore without a mesh: each leaf on ``device``, or on its ``like``
    leaf's, with the saved dtype; without ``like``, the arrays by path
    (the resharding restore is held in ``test_torch_distributed.py``)."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4), "i": torch.arange(3, dtype=torch.int32)}
    ck.save(7, tree)
    step, restored = ck.restore(like=tree, device="cpu")
    assert step == 7 and restored["w"].device.type == "cpu"
    _equal_trees(tree, restored)
    step, arrays = ck.restore()
    assert set(arrays) == {"i", "w"} and np.array_equal(arrays["w"], tree["w"].numpy())


def test_resume_after_simulated_crash(tmp_path):
    """kill -9 between saves: the latest complete checkpoint restores."""
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(10, _tree())
    ck.save(20, _tree(1))
    os.makedirs(tmp_path / "step_0000000030.tmp")  # a half-written newer step
    ck2 = Checkpointer(str(tmp_path), keep=5)
    assert ck2.latest_step() == 20
    _equal_trees(ck2.restore(like=_tree())[1], _tree(1))


# -- fault tolerance ------------------------------------------------------------------

def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=16, threshold=2.0)
    for _ in range(8):
        assert not mon.record(0.1)
    assert mon.record(1.0)  # 10x the median
    assert mon.flags == 1


def test_with_retries_recovers_and_exhausts():
    calls = {"n": 0}
    errors = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert with_retries(flaky, retries=3, backoff=0.0,
                        on_error=lambda e, attempt: errors.append(attempt))() == "ok"
    assert calls["n"] == 3 and errors == [0, 1]

    def dead():
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError, match="permanent"):
        with_retries(dead, retries=1, backoff=0.0)()


# -- the train CLI on the CPU -----------------------------------------------------------

def _cli(args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env=env, capture_output=True, text=True, timeout=600)


def test_train_cli_resume_after_kill(tmp_path):
    """As the reference's resume-after-kill test in ``tests/test_system.py``:
    12 steps checkpointing every 5, then a new process to 20 resumes from
    step 10."""
    base = SMOKE + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5",
                    "--log-every", "100"]
    r1 = _cli(base + ["--steps", "12"])
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _cli(base + ["--steps", "20"])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[train] resumed from step 10" in r2.stdout
    final = json.loads(r2.stdout.strip().splitlines()[-1])
    assert set(final) == {"final_loss", "straggler_flags"} and np.isfinite(final["final_loss"])
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [10, 15, 20]


class _PreemptedAt(PreemptionHandler):
    """The handler's flag set, as SIGTERM sets it, at the 10th poll (after
    step 10)."""

    polls = 0

    @property
    def preempted(self):
        _PreemptedAt.polls += 1
        if _PreemptedAt.polls == 10:
            self._handler(signal.SIGTERM, None)
        return super().preempted


@pytest.mark.parametrize("compression", [False, True])
def test_preemption_flush_resumes_to_the_uninterrupted_loss(tmp_path, monkeypatch, capsys,
                                                            compression):
    """A 20-step run preempted after step 10 flushes a checkpoint there and
    stops; a second run resumes from it.  Without compression its final
    loss is the uninterrupted 20-step run's, bit for bit (the CPU is
    deterministic).  With ``--compression`` the error-feedback residual is
    not part of the checkpoint (as in the reference), so the resumed run
    restarts it at zero and ends elsewhere, but finite and close."""
    argv = SMOKE + ["--steps", "20", "--log-every", "5"] + ["--compression"] * compression
    whole, _ = train_cli.run(train_cli.build_parser().parse_args(argv))
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "50"]
    monkeypatch.setattr(train_cli, "PreemptionHandler", _PreemptedAt)
    _PreemptedAt.polls = 0
    first, _ = train_cli.run(train_cli.build_parser().parse_args(argv + ck))
    assert len(first["losses"]) == 10 and "preemption: flushing" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path / "ck")).all_steps() == [10]
    monkeypatch.setattr(train_cli, "PreemptionHandler", PreemptionHandler)
    resumed, _ = train_cli.run(train_cli.build_parser().parse_args(argv + ck))
    assert resumed["start_step"] == 10 and len(resumed["losses"]) == 10
    assert "resumed from step 10" in capsys.readouterr().out
    assert first["losses"] == whole["losses"][:10]
    if compression:
        assert np.isfinite(resumed["final_loss"])
        assert resumed["final_loss"] == pytest.approx(whole["final_loss"], rel=1e-2)
    else:
        assert resumed["losses"] == whole["losses"][10:]
        assert resumed["final_loss"] == whole["final_loss"]


def test_train_cli_main_prints_the_references_last_line(capsys):
    assert train_cli.main(SMOKE + ["--steps", "3", "--microbatches", "2",
                                   "--log-every", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[2] for line in lines[:-1]] == ["1", "2", "3"]
    final = json.loads(lines[-1])
    assert set(final) == {"final_loss", "straggler_flags"} and np.isfinite(final["final_loss"])


def test_train_cli_refuses_without_a_card_and_the_sharded_meshes():
    """Without a card nothing trains on ``cuda``, and the production meshes
    refuse a world smaller than theirs with the reference's message (the
    process group the CLI started for it ends with it)."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match=r"need 256 devices for mesh \(16, 16\), have 1"):
        train_cli.main(SMOKE + ["--mesh", "single"])
    with pytest.raises(RuntimeError, match=r"need 512 devices for mesh \(2, 16, 16\), have 1"):
        train_cli.main(SMOKE + ["--mesh", "multi"])
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            train_cli.main(SMOKE[:-2] + ["--steps", "1"])


# -- on the card ---------------------------------------------------------------------------

def _close_trees(got, want, rel):
    floor = 1e-3 * max(float(v.abs().max()) for v in want.values())
    errs = {k: float((got[k].cpu().double() - want[k].double()).abs().max())
            / max(float(want[k].abs().max()), floor) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] < rel, (worst, errs[worst])


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu_step():
    """qwen3 smoke, one AdamW train step from the same weights and batch on
    the card and on the CPU: the loss, every gradient and every parameter
    after the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.lm import LM
    from repro_torch.train.optimizer import Optimizer, OptimizerConfig
    from repro_torch.train.step import make_loss_fn, make_train_step, param_dict, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    cpu = LM(spec).init(torch.Generator().manual_seed(0))
    card = LM(spec).init(torch.Generator().manual_seed(0)).to("cuda")
    host = SyntheticLMData(spec.vocab, 32, 4).batch_at(0)
    batches = {dev: {k: torch.from_numpy(v).long().to(dev) for k, v in host.items()}
               for dev in ("cpu", "cuda")}
    (l0, g0), (l1, g1) = (value_and_grad(make_loss_fn(m), param_dict(m), batches[dev])
                          for m, dev in ((cpu, "cpu"), (card, "cuda")))
    assert abs(float(l1) - float(l0)) < CARD_REL * float(l0)
    _close_trees(g1, g0, CARD_REL)
    opt = Optimizer(OptimizerConfig(name="adamw", learning_rate=1e-3))
    out = {}
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        p = param_dict(m)
        out[dev] = make_train_step(m, opt)(p, opt.init(p), batches[dev])
    assert int(out["cuda"][1]["step"]) == 1
    _close_trees(out["cuda"][0], out["cpu"][0], CARD_REL)


@pytest.mark.cuda
def test_val_accuracy_on_the_card_matches_the_cpu():
    """A conv candidate trained 20 steps from the same weights on the card
    and on the CPU: the accuracy within one validation sample."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.translate import ArchitectureIR, LayerIR
    from repro_torch.data.pipeline import SyntheticClassificationData
    from repro_torch.evaluation.estimators import TrainedAccuracyEstimator

    torch.backends.cudnn.allow_tf32 = False
    model = ModelBuilder((4, 256), 6).build(ArchitectureIR([
        LayerIR("conv1d", {"kernel_size": 5, "out_channels": 8}, "conv/0"),
        LayerIR("maxpool", {}, "pool/0"), LayerIR("linear", {"width": 32}, "head/0")]))
    data = SyntheticClassificationData(n=160, length=256, channels=4, classes=6).split()
    cpu = TrainedAccuracyEstimator(steps=20, device="cpu")
    weights = cpu._weights(model)

    class Same(TrainedAccuracyEstimator):
        def _weights(self, candidate):
            return {n: {k: v.to(self.device) for k, v in leaves.items()}
                    for n, leaves in weights.items()}

    want = Same(steps=20, device="cpu").estimate(model, {"data": data})
    got = Same(steps=20, device="cuda").estimate(model, {"data": data})
    assert abs(got - want) <= 1.0 / len(data["y_val"]) + 1e-7
