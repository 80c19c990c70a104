"""Nothing under zkbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program under test.  Imports are compared
by their top-level name (the part before the first dot) as a whole word."""

import ast
from pathlib import Path

import pytest

ZKBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "eigen_zeth_tpu"}
PROGRAM = "eigen_zeth_tpu_torch"


def imports(path: Path):
    """(top-level name, relative level) of every import in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


SOURCES = sorted(ZKBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ZKBENCH)))
def test_no_jax_import(path):
    found = {name for name, level in imports(path) if level == 0} & FORBIDDEN
    assert not found, f"{path} imports {found}"


REFERENCE = sorted((ZKBENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_stands_alone(path):
    for name, level in imports(path):
        assert not (level == 0 and name == PROGRAM), f"{path} imports the program"
        assert level <= 1, f"{path} imports from outside the reference"


def test_the_guard_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom eigen_zeth_tpu.ops import ntt\n"
                   "import eigen_zeth_tpu_torch\n")
    assert {n for n, _ in imports(bad)} & FORBIDDEN == {"jax", "eigen_zeth_tpu"}
