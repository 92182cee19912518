"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
