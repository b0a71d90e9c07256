"""No run loads JAX or the JAX package; top-level names are compared
whole, since the port's name begins with the JAX package's."""

import ast
import sys
from pathlib import Path

from benchmark.core import env

BENCH = Path(__file__).resolve().parents[1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"cadepth_tpu_torch": None,
                                         "cadepth_tpu_torch.ops": None,
                                         "jaxtyping": None, "os": None})
    assert env.forbidden_loaded() == []
    monkeypatch.setattr(sys, "modules", {"cadepth_tpu.ops": None,
                                         "jaxlib.xla": None, "os": None})
    assert env.forbidden_loaded() == ["cadepth_tpu", "jaxlib"]


def test_no_benchmark_file_imports_a_forbidden_module_or_old_results():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.partition(".")[0] not in env.FORBIDDEN, \
                    f"{path} imports {name}"
        text = path.read_text()
        if path == Path(__file__).resolve():
            continue
        assert "bench.py" not in text and "BENCH_" not in text, path


def test_the_reference_takes_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert env.PROGRAM not in path.read_text(), path
