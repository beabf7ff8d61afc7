"""The port stands alone: no module of `mmpl_tpu_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package, whether the import is
written at the top of a module or inside a function."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "mmpl_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mmpl_tpu")


def _imported(path: pathlib.Path):
    """Top-level names of every module `path` imports, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax(path):
    bad = sorted(set(_imported(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """Import every module of the package in a fresh interpreter; neither
    JAX nor the JAX package may be in `sys.modules` afterwards."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in SOURCES if p.parent != ROOT]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
