"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole)."""

import ast

import pytest
from conftest import BENCH

FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "audio_analysis_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "benchref").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "audio_analysis_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"benchref", "contextlib", "dataclasses", "functools",
                                       "json", "logging", "math", "numpy", "scipy", "torch",
                                       "typing"}
