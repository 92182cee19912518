"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, none of the kernel variant scripts under ``scripts/``,
``scripts/gen_docs_torch.py``, ``scripts/card_timing_drift.py`` and none of the port's examples under
``examples/torch/`` imports JAX or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("*.py"))
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("*_variants.py"))
         + [ROOT / "scripts" / "gen_docs_torch.py", ROOT / "scripts" / "card_timing_drift.py"]
         + EXAMPLES)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    names = set(_imported(ast.parse(path.read_text(), filename=str(path))))
    bad = sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py").is_file()
    assert ROOT / "examples" / "torch" / "hw_in_loop_nas_lm.py" in EXAMPLES


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "examples").glob("*.py")))
def test_every_reference_example_has_a_port_copy(name):
    """Each of the JAX package's examples has its copy under
    ``examples/torch/``, which the scan above covers."""
    assert ROOT / "examples" / "torch" / name in EXAMPLES


def test_nas_loop_imports_without_pyyaml():
    """The machine with the card has no PyYAML: the modules the chip
    smoke's NAS loop runs import, and parse a dict space, with ``yaml``
    blocked."""
    import os
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import repro_torch.core.translate, repro_torch.core.builder\n"
        "import repro_torch.evaluation.estimators, repro_torch.search.study\n"
        "from repro_torch.core.space import parse_search_space\n"
        "space = parse_search_space({'input': [2, 8], 'output': 2, 'sequence': "
        "[{'block': 'head', 'op_candidates': 'linear'}]})\n"
        "assert 'yaml' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print(len(space.blocks))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "1"


def test_xlstm_path_imports_without_pyyaml():
    """The xLSTM slice's modules (config, LM, blocks, kernels, serving)
    import, and build the full-width spec's skeleton, with ``yaml``
    blocked."""
    import os
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import repro_torch.launch.serve, repro_torch.convert, repro_torch.kernels.ops\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.models.lm import LM\n"
        "model = LM(get_arch('xlstm-1.3b').spec())\n"
        "assert 'yaml' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print(model.spec.n_layers)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "48"


def test_explorer_runs_a_dict_spec_without_pyyaml():
    """The facade's modules (spec, explorer, tuner, executors, pruners,
    disk tier) import and run a dict experiment with ``yaml`` blocked, as
    ``chip_smoke.py``'s explore phase does on the card's machine."""
    import os
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import repro_torch.explorer.__main__, repro_torch.hwgen.autotune\n"
        "from repro_torch.explorer.explorer import Explorer\n"
        "space = {'input': [2, 8], 'output': 2, 'sequence': "
        "[{'block': 'head', 'op_candidates': 'linear', 'linear': {'width': [4, 8]}}]}\n"
        "report = Explorer.from_dict({'name': 'noyaml', 'search_space': space, "
        "'criteria': ['n_params'], 'pruner': 'median', 'budget': 3, "
        "'kernel_tuning': 'cached'}, device='cpu').run(save_report=False)\n"
        "assert 'yaml' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print(report.n_trials)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "3"


def test_trainer_runs_without_pyyaml():
    """The training slice's modules (CLI, step, optimizer, checkpointer,
    data, compression, faults, ``val_accuracy``) import, and the CLI trains
    two steps at ``--smoke``, with ``yaml`` blocked, as ``chip_smoke.py``'s
    training phases run on the card's machine."""
    import os
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import repro_torch.evaluation, repro_torch.checkpoint.checkpointer\n"
        "from repro_torch.launch import train\n"
        "summary, _ = train.run(train.build_parser().parse_args(['--smoke', '--steps', '2', "
        "'--seq', '16', '--global-batch', '2', '--compression', '--device', 'cpu']))\n"
        "assert 'yaml' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print(len(summary['losses']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "2"

