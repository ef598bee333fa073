"""The port's video demo (``evaluation/demo.py``) against the JAX
package's ``DemoRunner``, in float32 on the CPU: the same frames, joints
and weights through both, the final MPJPE, ACC and AUC within 1e-3
relative; the pictures (feature-map tiles, frame plots, video) and their
skip where cv2 is missing; the demo loaders of STB, HO-3D and MHP; the
errors and the device rule.

One small EncoderTransformer (resnet18, 64x64 crops, 2 heads, iteration
3) is initialised in flax and carried into the port by
``state_dict_from_flax``; both DemoRunners build it in place of the
full-width model (``build_model`` patched)."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.config as jconfig
import scat_tpu.evaluation.demo as jdemo
import scat_tpu.models.hand_net as jhand_net
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.evaluation import demo
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.utils.weights import state_dict_from_flax
from dataset_trees import write_ho3d_tree, write_mhp_tree
from stb_tree import EVAL_SEQS, _smooth, write_stb_tree

IMG = 64
FRAMES = 18   # the 16-frame acceleration window fills at frame 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.array(tree)


def _jmodel(img=IMG):
    return jhand_net.EncoderTransformer(
        mean_params=jnp.asarray(assets.load_mean_params()), iteration=3,
        heads=2, token_dim=(img // 8) ** 2, backbone="resnet18",
        use_pallas=False)


def _tmodel(img=IMG):
    return EncoderTransformer(
        mean_params=torch.from_numpy(assets.load_mean_params()),
        iteration=3, heads=2, token_dim=(img // 8) ** 2, backbone="resnet18",
        use_kernel=True)


def _patch_models(mp):
    mp.setattr(demo, "build_model", lambda opt, image_size=224: (
        _tmodel(image_size), assets.load_mean_params()))
    mp.setattr(jdemo, "build_model", lambda opt, image_size=224, **kw: (
        _jmodel(image_size), assets.load_mean_params()))


@pytest.fixture(scope="module")
def weights():
    """(flax variables, state_dict) of the small model."""
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    v = jax.jit(lambda x: _jmodel().init(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, x,
        train=False))(x)
    flax = {"params": _unfreeze(v["params"]),
            "batch_stats": _unfreeze(v["batch_stats"])}
    return flax, state_dict_from_flax(flax["params"], flax["batch_stats"])


def _sequence():
    """FRAMES 96x128 frames with a hand drifting across them: 2D joints
    in frame pixels, root-centred 3D joints near the mean template."""
    rng = np.random.RandomState(0)
    base = np.stack([rng.uniform(40, 90, 21), rng.uniform(30, 66, 21)], -1)
    offsets = assets.load_mean_params()[3:66].reshape(21, 3)
    images, j2d, j3d = [], [], []
    for t in range(FRAMES):
        images.append(_smooth(96, 128, t))
        j2d.append(base + t * np.array([0.8, -0.5]) + rng.randn(21, 2))
        pose = offsets + rng.randn(21, 3) * 0.01
        j3d.append(pose - pose[1])
    return demo.SequenceLoader(np.stack(images), np.stack(j2d).astype(
        np.float32), np.stack(j3d).astype(np.float32))


def _opts(result_dir, **kw):
    common = dict(net="reg_transformer", vit_heads=2, iteration=3,
                  compute_dtype="float32", result_dir=str(result_dir), **kw)
    return Options(checkpoint_path_eval="", **common), \
        jconfig.Options(**common)


@pytest.fixture(scope="module")
def jax_result(weights, tmp_path_factory):
    """The JAX package's demo over the sequence."""
    with pytest.MonkeyPatch.context() as mp:
        _patch_models(mp)
        _, jopt = _opts(tmp_path_factory.mktemp("jax_demo"))
        return jdemo.DemoRunner(jopt, variables=weights[0],
                                loader=_sequence(), image_size=IMG).demo()


def _close(got, want):
    """MPJPE, ACC and AUC within 1e-3 relative."""
    for k in ("mpjpe_mm", "acc", "auc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("pictures", [True, False])
def test_demo_matches_jax(tmp_path, weights, jax_result, monkeypatch,
                          capsys, pictures):
    """The sequence through both DemoRunners with the same weights: the
    final metrics (ACC over three full windows) within 1e-3 relative, the
    reference's prints; with cv2 the tiles, frame plots, crops, video and
    PCK.png, without it a message and the same metrics."""
    _patch_models(monkeypatch)
    if not pictures:
        monkeypatch.setitem(sys.modules, "cv2", None)
    opt, _ = _opts(tmp_path / "out")
    got = demo.DemoRunner(opt, state_dict=weights[1], loader=_sequence(),
                          image_size=IMG, device="cpu").demo()
    out = capsys.readouterr().out
    assert got["frames"] == FRAMES and got["acc"] > 0
    _close(got, jax_result)
    assert out.count("FPS: ") == FRAMES and out.count("acceleration: ") == 3
    for line in ("*** Final Results ***", "MPJPE: ", "ACC:", "AUC: "):
        assert line in out, line
    files = [os.path.join(opt.result_dir, f) for f in (
        "fm/001.png", f"3d/gt_pred_{FRAMES:03d}.png", "img/001.png",
        "result.avi")]
    assert all(map(os.path.exists, files)) == pictures
    assert not any(map(os.path.exists, files)) != pictures
    assert ("skipping the feature-map tiles" in out) != pictures


def test_demo_on_mhp_tree_matches_jax(tmp_path, weights, monkeypatch):
    """``demo("MHP")`` reads data_15_cam_1 from the MHP tree beside
    --data_dir through mhp_eval, as the JAX package's: the metrics within
    1e-3 relative."""
    _patch_models(monkeypatch)
    write_mhp_tree(tmp_path, frames=4)
    kw = dict(data_dir=str(tmp_path / "STB"))
    opt, _ = _opts(tmp_path / "port", **kw)
    _, jopt = _opts(tmp_path / "jax", **kw)
    want = jdemo.DemoRunner(jopt, variables=weights[0],
                            image_size=IMG).demo("MHP")
    got = demo.DemoRunner(opt, state_dict=weights[1], image_size=IMG,
                          device="cpu").demo("MHP")
    assert got["frames"] == 4
    _close(got, want)


@pytest.mark.parametrize("eval_set", ["STB", "ho3d"])
def test_demo_loaders_match_jax(tmp_path, eval_set):
    """stb_vibe_demo (B1Counting of the STB tree) and ho3d_vibe_demo
    (GPMF11 of the HO-3D tree beside it): the same frames, 2D joints
    within 1e-5 relative and 3D joints within 1e-6."""
    write_stb_tree(tmp_path / "STB", EVAL_SEQS, n=3)
    write_ho3d_tree(tmp_path, seqs=("ABF10", "GPMF11"), frames=3)
    opt, jopt = _opts(tmp_path / "out", data_dir=str(tmp_path / "STB"))
    got = demo.demo_loader(eval_set, opt)
    want = (jdemo.stb_vibe_demo("B1Counting", jopt) if eval_set == "STB"
            else jdemo.ho3d_vibe_demo("GPMF11", jopt))
    assert got.seq_len() == want.seq_len() == 3
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_allclose(got.joints_2d, want.joints_2d, rtol=1e-5)
    np.testing.assert_allclose(got.joints_3d, want.joints_3d, atol=1e-6)


def test_demo_refuses_unknown_sets_and_a_name_beside_a_loader(
        tmp_path, weights, monkeypatch):
    _patch_models(monkeypatch)
    opt, _ = _opts(tmp_path, eval_dataset="frei")
    runner = demo.DemoRunner(opt, state_dict=weights[1], image_size=IMG,
                             device="cpu")
    with pytest.raises(ValueError, match="no demo sequence"):
        runner.demo()
    runner.loader = _sequence()
    with pytest.raises(ValueError, match="injected loader"):
        runner.demo("STB")


def test_demo_needs_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.DemoRunner(_opts(tmp_path)[0])


def test_cli_needs_cuda(tmp_path):
    """``python -m scat_tpu_torch.demo`` runs on the CUDA device: without
    one it stops with the device rule's message."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "scat_tpu_torch.demo", "--net",
         "reg_transformer", "--eval_dataset", "STB", "--result_dir",
         str(tmp_path / "demo"), "--checkpoint_path_eval", ""],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode != 0
    assert "runs on a CUDA device" in proc.stderr
