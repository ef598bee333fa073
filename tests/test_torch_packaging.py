"""An install of the port carries what nvcc needs: every ``#include
"..."`` under ``scat_tpu_torch/csrc/`` names a file that the wheel's
package-data globs (``pyproject.toml``) and the sdist's ``MANIFEST.in``
ship, every library's build key hashes the shared headers, and a
read-only install builds into the per-user cache; and every console
script of the port resolves to a callable."""

import fnmatch
import importlib
import os
import re
import tomllib

import numpy as np
import pytest

from scat_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "scat_tpu_torch", "csrc")


def _includes():
    """(source, included file) for every quoted include under csrc/."""
    pairs = []
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name)) as f:
            for inc in re.findall(r'^\s*#include\s+"([^"]+)"', f.read(),
                                  re.M):
                pairs.append((name, inc))
    return pairs


def _wheel_globs():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)
    return data["tool"]["setuptools"]["package-data"]["scat_tpu_torch"]


def _sdist_globs():
    globs = []
    with open(os.path.join(REPO, "MANIFEST.in")) as f:
        for line in f:
            words = line.split()
            if words and words[0] == "include":
                globs += words[1:]
    return globs


@pytest.mark.parametrize("source,header", _includes(),
                         ids=lambda v: str(v))
def test_every_include_is_shipped(source, header):
    path = os.path.join(CSRC, header)
    assert os.path.exists(path), f"{source} includes missing {header}"
    rel_pkg = os.path.join("csrc", header)
    rel_repo = os.path.join("scat_tpu_torch", "csrc", header)
    assert any(fnmatch.fnmatch(rel_pkg, g) for g in _wheel_globs()), \
        f"the wheel's package-data does not ship {rel_pkg}"
    assert any(fnmatch.fnmatch(rel_repo, g) for g in _sdist_globs()), \
        f"MANIFEST.in does not ship {rel_repo}"


def test_every_source_file_is_shipped():
    for name in os.listdir(CSRC):
        assert any(fnmatch.fnmatch(os.path.join("csrc", name), g)
                   for g in _wheel_globs()), name
        assert any(fnmatch.fnmatch(os.path.join("scat_tpu_torch", "csrc",
                                                name), g)
                   for g in _sdist_globs()), name
    assert _includes(), "no quoted include found"


def test_build_key_hashes_the_headers():
    headers = build.headers()
    assert headers, "the build key would hash an empty header list"
    included = {os.path.join(CSRC, h) for _, h in _includes()}
    assert included <= set(headers)


def test_read_only_install_builds_in_the_user_cache(monkeypatch, tmp_path):
    """Where BUILD_DIR cannot be written (a wheel in site-packages), the
    libraries go to ~/.cache/scat_tpu_torch, keyed as before."""
    monkeypatch.setenv("HOME", str(tmp_path))
    here = build.library_path("attention_fwd")
    assert here.startswith(build.BUILD_DIR)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    cached = build.library_path("attention_fwd")
    assert cached.startswith(os.path.join(str(tmp_path), ".cache",
                                          "scat_tpu_torch"))
    assert os.path.basename(cached) == os.path.basename(here)


def _port_scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items()
            if v.startswith("scat_tpu_torch.")}


def test_port_scripts_are_named():
    assert set(_port_scripts()) == {
        "scat-tpu-torch-serve", "scat-tpu-torch-train",
        "scat-tpu-torch-train-coarse", "scat-tpu-torch-eval",
        "scat-tpu-torch-demo", "scat-tpu-torch-test",
        "scat-tpu-torch-export", "scat-tpu-torch-convert",
        "scat-tpu-torch-validate-data"}
    assert _port_scripts()["scat-tpu-torch-demo"] == "scat_tpu_torch.demo:main"
    assert _port_scripts()["scat-tpu-torch-train-coarse"] == \
        "scat_tpu_torch.train_coarse:main"
    assert _port_scripts()["scat-tpu-torch-test"] == \
        "scat_tpu_torch.test:main"
    assert _port_scripts()["scat-tpu-torch-export"] == \
        "scat_tpu_torch.export:main"
    assert _port_scripts()["scat-tpu-torch-convert"] == \
        "scat_tpu_torch.convert:main"
    assert _port_scripts()["scat-tpu-torch-validate-data"] == \
        "scat_tpu_torch.validate_data:main"


@pytest.mark.parametrize("script", sorted(_port_scripts()))
def test_port_script_resolves_to_a_callable(script):
    module, _, attr = _port_scripts()[script].partition(":")
    assert callable(getattr(importlib.import_module(module), attr))


@pytest.mark.parametrize("where", ["env", "cwd"])
def test_synthetic_mano_finds_hand_obj_as_find_asset(tmp_path, monkeypatch,
                                                    where):
    """The synthetic MANO reads the hand.obj that ``find_asset`` resolves:
    ``$SCAT_EXTRA_DATA`` first, then ``./extra_data`` beside the run,
    then the checkout's."""
    from scat_tpu_torch import assets
    folder = tmp_path / "extra_data"
    folder.mkdir()
    shipped = assets.load_obj_vertices()
    with open(folder / "hand.obj", "w") as f:
        for v in shipped * 2.0:
            f.write("v %f %f %f\n" % tuple(v))
        for face in assets.load_obj_faces():
            f.write("f %d %d %d\n" % tuple(face + 1))
    if where == "env":
        monkeypatch.setenv("SCAT_EXTRA_DATA", str(folder))
    else:
        monkeypatch.delenv("SCAT_EXTRA_DATA", raising=False)
        monkeypatch.chdir(tmp_path)
    assert assets.find_asset("hand.obj") == str(folder / "hand.obj")
    mano = assets.synthetic_mano(0)
    assert mano.synthetic
    np.testing.assert_allclose(mano.v_template, shipped * 2.0, atol=1e-6)
