"""The port stands alone: every module of ``repro_torch`` imports with
``jax`` and the reference package ``repro`` made unimportable, and
``chip_smoke.py`` has no import of either."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_CHILD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert "jax" not in [m.split(".")[0] for m, v in sys.modules.items() if v]
print(len(names))
"""


def _port_modules():
    import repro_torch

    return ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def test_every_port_module_imports_without_jax_or_the_reference():
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) == len(_port_modules())


def _imported(path: Path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def _reference_imports(path: Path):
    return [n for n in _imported(path)
            if n.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    assert _reference_imports(ROOT / "chip_smoke.py") == []


def test_port_sources_import_neither_jax_nor_the_reference():
    bad = {str(p.relative_to(ROOT)): _reference_imports(p)
           for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))}
    assert {k: v for k, v in bad.items() if v} == {}
