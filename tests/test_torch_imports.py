"""The port stands alone: no module of ``tartangan_torch`` nor
``chip_smoke.py`` imports jax, flax, optax or ``tartangan_tpu``, nor the
orbax checkpoint stack (orbax, tensorstore, zstandard): the port reads and
writes orbax checkpoints itself (``utils/orbax.py``).

A static scan with ``ast``: the interpreter that runs the tests may already
hold jax in ``sys.modules``, so an import-time check would prove nothing.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tartangan_tpu", "orbax",
             "tensorstore", "zstandard")
FILES = sorted((ROOT / "tartangan_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_files_found():
    assert len(FILES) > 10 and all(f.exists() for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
