"""The port stands alone: no module of the PyTorch package, and not
``chip_smoke.py``, imports JAX or the JAX package (checked with ``ast``,
so an import inside a function counts too)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "neuralvolumetricreconstructionformedicalimages_torch"
FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "neuralvolumetricreconstructionformedicalimages_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(names):
    return [n for n in names if n.split(".")[0] in FORBIDDEN]


def test_port_has_files():
    assert len(FILES) > 20 and "neuralvolumetricreconstructionformedicalimages_torch/data/projector.py" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = _forbidden(_imports(tree))
    assert not bad, f"{rel} imports {bad}"


def test_checker_catches_imports():
    src = ("import os\nimport jax.numpy as jnp\n"
           "def f():\n    from neuralvolumetricreconstructionformedicalimages_tpu.data import x\n"
           "from jax import lax\nimport jaxlib\n")
    assert sorted(_forbidden(_imports(ast.parse(src)))) == [
        "jax", "jax.numpy", "jaxlib", "neuralvolumetricreconstructionformedicalimages_tpu.data"]
