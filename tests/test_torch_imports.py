"""``cadepth_tpu_torch`` (its CLIs included), ``chip_smoke.py`` and
``torch_convergence.py`` stand alone: the package imports with JAX and
the JAX package blocked, and no code of any of them imports them."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "cadepth_tpu_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "cadepth_tpu"):
    sys.modules[name] = None
import cadepth_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cadepth_tpu_torch.__path__,
                                               "cadepth_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_package_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # every module of the package was imported
    expected = {p for p in PACKAGE.rglob("*.py") if p.name != "__init__.py"}
    assert int(proc.stdout.split()[-1]) >= len(expected)


def _imported_roots(tree: ast.AST):
    """Top-level package names a module's code imports: import
    statements, and string arguments of import_module and __import__."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_sources_import_no_jax():
    """The code imports neither JAX nor the JAX package. Docstrings and
    comments do name the JAX modules each port module stands for, so the
    scan reads the code's syntax tree, not its text."""
    forbidden = {"jax", "jaxlib", "flax", "optax", "orbax", "cadepth_tpu"}
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py",
                                                 REPO / "torch_convergence.py"]:
        for name in _imported_roots(ast.parse(path.read_text())):
            if name.split(".")[0] in forbidden:
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
    # the check itself sees such an import
    probe = ast.parse("from cadepth_tpu.ops import resize\nimport jax.numpy")
    assert {n.split(".")[0] for n in _imported_roots(probe)} == \
        {"cadepth_tpu", "jax"}
