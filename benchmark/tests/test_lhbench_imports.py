"""Nothing under the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program, comparing top-level module
names whole: ``lighthand_tpu_torch`` is not ``lighthand_tpu``."""

from __future__ import annotations

import ast
import sys

import pytest

from lhbench import runner, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "lighthand_tpu"}
FILES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (spec.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert "lighthand_tpu_torch" not in top_level_imports(path)


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "lighthand_tpu_torch_fake", sys)
    assert "lighthand_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lighthand_tpu.models", sys)
    assert runner.forbidden_modules() == ["lighthand_tpu"]
