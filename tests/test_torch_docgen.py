"""The port's generated reference (``docs/reference/torch/*.md``) against
its registries, spec metadata and env registry, as the JAX package's
``tests/test_sweep.py`` holds its own: every registered component, every
experiment and sweep key and every ``REPRO_*`` knob rendered; the targets
the port has (``h100``, ``h100_pod``, ``h100_2pod``) listed and no TPU
target; and ``scripts/gen_docs_torch.py --check`` finding the committed
files in sync, in a fresh process (tests here register plugins)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_components_reference_covers_every_registered_component():
    from repro_torch.explorer.docgen import (components_markdown, list_components_text,
                                             walk_components)
    from repro_torch.explorer.registry import REGISTRIES

    rendered = components_markdown()
    listed = list_components_text()
    walked = walk_components()
    for kind, registry in REGISTRIES.items():
        names = registry.names()
        assert names, f"registry {kind} is empty"
        assert [e["name"] for e in walked[kind]] == names
        for name in names:
            assert f"`{name}`" in rendered
            assert name in listed
    for target in ("h100", "h100_pod", "h100_2pod", "host_cpu", "edge_npu"):
        assert f"| `{target}` |" in rendered
    assert "| `h100_pod` | h100 | 9.89e+14 | 3.35e+12 | 4.5e+11 | 85899345920 | 16x16 | " \
           "roofline | cpu |" in rendered
    assert "tpu_v5e" not in rendered and "tpu_v5e" not in listed


def test_spec_reference_covers_every_key():
    from repro_torch.explorer.docgen import experiment_spec_markdown
    from repro_torch.explorer.experiment import TOP_LEVEL_KEYS
    from repro_torch.explorer.sweep import SWEEP_KEYS

    rendered = experiment_spec_markdown()
    for key in TOP_LEVEL_KEYS:
        assert f"`{key}`" in rendered
    for key in SWEEP_KEYS:
        assert f"`{key}`" in rendered
    for section in ("sampler", "executor", "schedule", "criteria[i]", "fidelity.stages[i].keep",
                    "kernel_tuning", "cache", "budget", "pruner", "faults", "serving.traffic",
                    "Sweep document"):
        assert f"`{section}`" in rendered or section in rendered
    assert "executor: remote" in rendered and "tpu_v5e" not in rendered


def test_env_reference_covers_every_env_var():
    from repro_torch.envvars import ENV_VARS
    from repro_torch.explorer.docgen import env_markdown

    rendered = env_markdown()
    assert ENV_VARS  # the registry is populated at import
    for name, var in ENV_VARS.items():
        assert f"`{name}`" in rendered
        assert var.default in rendered
        assert var.malformed in rendered


def test_committed_reference_is_in_sync():
    """``gen_docs_torch.py --check`` passes on the committed files (in a
    fresh process: a plugin registered here would join the walk), which
    are the three files ``generated_files`` names."""
    from repro_torch.explorer.docgen import generated_files

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "scripts" / "gen_docs_torch.py"), "--check"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "docs in sync (3 files)" in r.stdout
    assert sorted(generated_files()) == sorted(
        f"docs/reference/torch/{n}.md" for n in ("components", "env", "experiment_spec"))
