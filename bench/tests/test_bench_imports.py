"""No module of the benchmark imports JAX, Flax or the JAX package, and
the reference imports nothing of the program.  Imports are compared by
their whole top-level name, so ``repro_torch`` is not ``repro``."""

import ast

import pytest

from _bench_small import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own and give none)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert names <= {"__future__", "math", "typing", "torch"}, names
    assert "repro_torch" not in names


def test_whole_names_are_compared(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.serve\nfrom repro_torch import models\nimport reprolib\n")
    assert top_level_imports(src) == {"repro_torch", "reprolib"}
    src.write_text("from repro.core import zipnn\n")
    assert top_level_imports(src) & FORBIDDEN == {"repro"}


def test_run_refuses_a_loaded_jax_package():
    """The runner's check after the window reads module names the same way."""
    from harness import runner

    assert runner.forbidden_modules(["torch", "repro_torch", "repro_torch.serve"]) == []
    assert runner.forbidden_modules(["repro_torch", "repro.core", "jaxlib.xla"]) == [
        "jaxlib", "repro"]
