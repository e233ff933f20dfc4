"""What the benchmark's sources import: never JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing of the program in the reference."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "softbody_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not {n for n in imported(path) if n.startswith("softbody")}
    assert not imported(path) & {"benchmarks"} - {"benchmarks"}


def test_correct_imports_only_the_reference_and_inputs():
    assert imported(HERE / "correct.py") <= {"__future__", "copy", "math", "torch", "benchmarks"}
    assert "softbody_tpu_torch" not in (HERE / "correct.py").read_text().split("\"\"\"")[-1]


def test_the_check_sees_whole_names():
    assert "softbody_tpu_torch".split(".")[0] not in FORBIDDEN
