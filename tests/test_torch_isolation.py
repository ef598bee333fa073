"""The port stands alone: no module of scat_tpu_torch, and not
chip_smoke.py, imports jax, flax or the JAX package, and no kernel
launch sits inside a try/except that could fall back."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "scat_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "scat_tpu")
# the kernel wrappers and the calls that reach a compiled kernel
KERNEL_CALLS = {"flash_attention", "scat_attention_fwd", "_attention_fwd",
                "attention_bwd", "scat_attention_bwd", "_library", "load",
                "build_all", "favor_attention_fused", "favor_stats",
                "favor_apply", "scat_favor_stats", "scat_favor_apply",
                "fused_link", "scat_fused_link"}


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in sorted(files)
                  if f.endswith(".py")]
    return paths


def _rel(path):
    return os.path.relpath(path, REPO)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(), ids=_rel)
def test_no_jax_or_scat_tpu_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{_rel(path)} imports {bad}"


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            yield f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")


@pytest.mark.parametrize("path", _sources(), ids=_rel)
def test_no_try_around_kernel_launch(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.handlers:
            hit = KERNEL_CALLS.intersection(
                n for stmt in node.body for n in _called_names(stmt))
            assert not hit, (f"{_rel(path)}:{node.lineno} wraps {hit} "
                             "in try/except")


# the port's command-line entry points, ``python -m scat_tpu_torch.<name>``
ENTRY_POINTS = ("train", "train_coarse", "eval", "demo", "server", "test",
                "export", "convert", "validate_data")
# the modules of the ViT, MANO and temporal slice, and of the serving
# artifact and the training utilities, each under the checks above
SLICE_MODULES = ("assets.py", "models/mano.py", "models/vit.py",
                 "models/helpers.py", "models/discriminator.py",
                 "models/vibe_loss.py", "training/adversarial.py",
                 "training/video_trainer.py", "evaluation/tester.py",
                 "utils/smplx_glue.py", "test.py", "export.py",
                 "utils/profiling.py", "utils/debugging.py",
                 "viz/render.py", "models/config_test.py",
                 "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/sharding_rules.py", "parallel/pipeline.py",
                 "convert.py", "validate_data.py")


@pytest.mark.parametrize("rel", SLICE_MODULES)
def test_slice_modules_are_checked(rel):
    assert os.path.join(PKG, rel) in _sources()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_the_port(name):
    """Each entry point is a module of the port with a ``main`` and a
    ``__main__`` guard, under the AST check above."""
    path = os.path.join(PKG, f"{name}.py")
    assert path in _sources()
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {a.asname or a.name for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) for a in n.names}
    names |= {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "main" in names and "__name__" in names, name


def test_runtime_imports_stay_clean():
    """Importing every port module pulls in no JAX; importing the
    package alone does not import torch."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import scat_tpu_torch\n"
        "assert 'torch' not in sys.modules\n"
        "for m in pkgutil.walk_packages(scat_tpu_torch.__path__,\n"
        "                               'scat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'scat_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=300)
