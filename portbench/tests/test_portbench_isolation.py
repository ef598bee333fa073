"""No file of the benchmark imports JAX or the JAX package (top-level
module names compared whole: ``scat_tpu_torch`` begins with
``scat_tpu``), and the reference imports nothing of the port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "scat_tpu"}


def imported(path):
    """Top-level names of every module ``path`` imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(BENCH, sub)
    for base, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert "scat_tpu_torch" not in imported(path)


def test_the_check_compares_whole_names():
    from harness import env
    assert env.forbidden_modules(["scat_tpu_torch.ops", "torch"]) == []
    assert env.forbidden_modules(["scat_tpu.models", "jax.numpy",
                                  "jaxlib"]) == ["jax", "jaxlib", "scat_tpu"]
