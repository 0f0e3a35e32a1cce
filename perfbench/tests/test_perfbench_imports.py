"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), and the reference's modules import nothing of the
program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cluster_anywhere_tpu"}
# the reference and what it is made of: no module of the program
REFERENCE_SIDE = ("reference.py", "weights.py", "generator.py", "counts.py")


def imported_top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(imported_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_imports_nothing_of_the_program(name):
    names = set(imported_top_names(HERE / name))
    assert "cluster_anywhere_tpu_torch" not in names and not names & FORBIDDEN


def test_the_check_compares_whole_names():
    src = Path(HERE / "run.py").read_text()
    assert "split(\".\")[0] in FORBIDDEN" in src
    import perfbench.run as run

    assert set(run.FORBIDDEN) == FORBIDDEN
