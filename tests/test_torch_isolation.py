"""The port imports neither JAX nor the JAX package.

An AST scan of ``celerite_torch/**/*.py``, ``chip_smoke.py`` and the
port's card scripts (``tools/*.py``) finds no
import of ``jax`` or ``celerite_tpu``; a subprocess with ``jax`` blocked
imports ``celerite_torch`` and every module of it.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = (sorted((ROOT / "celerite_torch").rglob("*.py"))
         + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "celerite_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, "{0} imports {1}".format(path.name, bad)


def test_imports_with_jax_blocked():
    modules = sorted(
        "celerite_torch." + ".".join(p.relative_to(ROOT / "celerite_torch")
                                     .with_suffix("").parts)
        for p in (ROOT / "celerite_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'celerite_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import celerite_torch\n"
        "for m in {0!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    ).format(modules)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
