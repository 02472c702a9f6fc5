"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or tartangan_tpu (compared whole: tartangan_torch begins with the JAX
package's name), and a reference that loads nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN = """
import sys
sys.path.insert(0, {tests!r})
from conftest import tiny_spec
from portbench import run
s = tiny_spec("sagan-512thin-r1-b64", blocks=(16, 16, 8), attention=(1,))
run.run_cell(s, 5, 0.0, True, "cpu")
print("LOADED", run.loaded_forbidden(),
      sorted({{m.split(".")[0] for m in sys.modules}} & {{"tartangan_torch"}}))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    return [line for line in out.splitlines()
            if line.startswith(("LOADED", "REFERENCE"))]


def test_a_run_loads_no_jax():
    lines = _loaded(RUN.format(tests=str(Path(__file__).parent)))
    assert lines == ["LOADED [] ['tartangan_torch']"]


def test_the_reference_loads_nothing_of_the_program():
    # the check, the counts, the weights and every model module, whose
    # program side loads only when it is called, with its reference
    code = ("import importlib, pkgutil, sys\nsys.path.insert(0, '.')\n"
            "import portbench.reference, portbench.check, portbench.flops\n"
            "import portbench.weights, portbench.synthetic\n"
            "import portbench.models as M\n"
            "for m in pkgutil.iter_modules(M.__path__):\n"
            "    ref = importlib.import_module(f'portbench.models.{m.name}')"
            ".reference\n"
            "    print('REFERENCE', ref.__file__)\n"
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules} &"
            " {'tartangan_torch', 'jax', 'tartangan_tpu'}))")
    lines = _loaded(code)
    assert lines[-1] == "LOADED []"
    refs = {Path(line.split(" ", 1)[1]) for line in lines[:-1]}
    assert ROOT / "portbench" / "reference.py" in refs
    for path in refs:
        tree = ast.parse(path.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        # a model's reference may build on SA-GAN's, which builds on torch
        base = path.name == "reference.py"
        allowed = {"__future__", "contextlib", "torch"} | (
            set() if base else {"portbench"})
        assert names <= allowed, (path, names)
