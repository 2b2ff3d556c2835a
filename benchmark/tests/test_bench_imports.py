"""No file of the benchmark imports JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

import ast

import pytest

from conftest import ROOT

FILES = sorted((ROOT / "benchmark").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "mendeliht_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((ROOT / "benchmark" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mendeliht_tpu_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path)


def test_the_port_is_allowed():
    # the whole-name comparison: the port's name begins with the JAX
    # package's and is not forbidden
    from benchmark import run
    assert "mendeliht_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert "mendeliht_tpu.ops".split(".")[0] in run.FORBIDDEN
