"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast

import pytest

from perfbench.lib.common import BENCH, FORBIDDEN, forbidden_modules

FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert forbidden_modules(imported(path)) == []


def test_the_reference_stands_alone():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not {n for n in imported(path) if n.split(".")[0] in ("dualvgr_tpu_torch", "perfbench")}


def test_names_are_compared_whole():
    assert forbidden_modules(["dualvgr_tpu_torch", "dualvgr_tpu_torch.models", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "dualvgr_tpu.ops", "optax", "flax", "jaxlib"]) == \
        ["dualvgr_tpu.ops", "flax", "jax.numpy", "jaxlib", "optax"]
    assert "dualvgr_tpu" in FORBIDDEN
