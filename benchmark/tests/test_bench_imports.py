"""What the benchmark imports: no module under benchmark/ imports JAX or
the JAX package (whole top-level names: the port's name begins with the
JAX package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "densecap_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "densecap_tpu_torch" not in names
    assert not names & {"benchlib", "drivers"}


def test_the_run_check_compares_whole_names(monkeypatch):
    import sys

    sys.path.insert(0, str(BENCH))
    from benchlib import harness

    monkeypatch.setitem(sys.modules, "densecap_tpu_torch_x", object())
    assert "densecap_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "densecap_tpu.config", object())
    assert "densecap_tpu" in harness.forbidden_modules()
