"""The port's Evaluator against the JAX package's, in float32 on the
CPU, and its surface: prints, eval_metrics.csv, the returned metrics, a
ViP checkpoint's frozen projection, STB, FreiHAND and HO-3D through
``make_dataset``, the flags it refuses, and the CLI's device rule.

One small EncoderTransformer (resnet18, 32x32 crops, 2 heads, iteration
3) is initialised once in flax and carried into the port by
``state_dict_from_flax``; both Evaluators build it in place of the
full-width model (``build_model`` patched).  The injected batches are the
port's synthetic crops, with 3D labels placed 30 mm (a joint, Gaussian)
from the model's own predictions, so the PCK at 20..50 mm and the AUC
are not all zero."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.evaluation.evaluator as jevaluator
import scat_tpu.models.hand_net as jhand_net
import scat_tpu.config as jconfig
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.data.synthetic import SyntheticDataset
from scat_tpu_torch.evaluation import evaluator
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.models.performer import ViP
from scat_tpu_torch.utils.weights import state_dict_from_flax
from dataset_trees import write_frei_tree, write_ho3d_tree
from stb_tree import EVAL_SEQS, write_stb_tree

IMG, BS, N_BATCHES = 32, 8, 2
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


@pytest.fixture(scope="module")
def flax_vars():
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    v = jax.jit(lambda x: _jmodel().init(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, x,
        train=False))(x)
    return {"params": _unfreeze(v["params"]),
            "batch_stats": _unfreeze(v["batch_stats"])}


@pytest.fixture(scope="module")
def state_dict(flax_vars):
    return state_dict_from_flax(flax_vars["params"],
                                flax_vars["batch_stats"])


@pytest.fixture(scope="module")
def batches(state_dict):
    """Synthetic crops, 3D labels near the model's predictions."""
    tm = _tmodel()
    tm.load_state_dict(state_dict, strict=True)
    tm.eval()
    rng = np.random.RandomState(0)
    out = []
    for b in SyntheticDataset(BS, num_batches=N_BATCHES, seed=0,
                              image_size=IMG):
        with torch.no_grad():
            pred = tm(b["image"].permute(0, 3, 1, 2))[0][:, 3:66]
        label = b["label"].clone()
        label[:, :63] = pred + torch.from_numpy(
            rng.randn(BS, 63).astype(np.float32) * 0.03 / np.sqrt(3))
        out.append({"image": b["image"], "label": label,
                    "valid": b["valid"]})
    return out


def _opt(tmp_path, **kw):
    return dataclasses.replace(
        Options(net="reg_transformer", vit_heads=2, iteration=3,
                batch_size=BS, compute_dtype="float32",
                checkpoint_path_eval="", result_dir=str(tmp_path / "eval")),
        **kw)


@pytest.fixture
def small_models(monkeypatch):
    monkeypatch.setattr(
        evaluator, "build_model",
        lambda opt, image_size=224, for_keypoints=False: (
            _tmodel(image_size), assets.load_mean_params()))
    monkeypatch.setattr(
        jevaluator, "build_model",
        lambda opt, image_size=224, for_keypoints=False: (
            _jmodel(image_size), assets.load_mean_params()))


def test_evaluator_matches_jax(tmp_path, flax_vars, state_dict, batches,
                               small_models, capsys):
    """The same weights and batches through both Evaluators: MPJPE and AUC
    within 1e-3 relative, the PCK curve within one joint a batch
    (100 / (BS * 21) points); the reference's prints, eval_metrics.csv
    (a row a batch and the final row) and PCK.png or its skip message."""
    jopt = jconfig.Options(net="reg_transformer", vit_heads=2, iteration=3,
                           batch_size=BS, compute_dtype="float32",
                           result_dir=str(tmp_path / "jax"))
    want = jevaluator.Evaluator(
        jopt, image_size=IMG, variables=flax_vars,
        dataset=[{k: np.asarray(v) for k, v in b.items()} for b in batches]
    ).eval()
    capsys.readouterr()
    opt = _opt(tmp_path)
    got = evaluator.Evaluator(opt, image_size=IMG, dataset=batches,
                              state_dict=state_dict, device="cpu").eval()
    out = capsys.readouterr().out
    assert 0 < got["pck"][0, -1] < got["pck"][-1, -1] < 100
    assert 0 < got["auc"] < 100
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-3)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-3)
    np.testing.assert_allclose(got["pck"], want["pck"],
                               atol=100 / (BS * 21) + 1e-6)
    for line in ("FPS: ", "AUC: ", "@50: ", "*** Final Results ***",
                 "MPJPE: "):
        assert line in out, line
    assert out.count("FPS: ") == N_BATCHES
    with open(os.path.join(opt.result_dir, "eval_metrics.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].split(",") == ["step", "time", "fps", "auc", "pck_at_50",
                                  "mpjpe_mm"]
    assert len(rows) == 1 + N_BATCHES + 1
    assert (os.path.exists(os.path.join(opt.result_dir, "PCK.png"))
            or "skipping PCK.png" in out)


def test_vip_checkpoint_keeps_its_projection(tmp_path):
    """A ViP .pth carries its frozen FAVOR+ projections mains.{i}.w: the
    Evaluator loads the file's, not a fresh draw of its own seed, and
    evaluates with them."""
    opt = Options(net="ViP", iteration=3, batch_size=2,
                  compute_dtype="float32", use_pallas_favor=True, seed=7,
                  result_dir=str(tmp_path / "eval"))
    trained = ViP(mean_params=torch.from_numpy(assets.load_mean_params()),
                  image_pix=IMG, iteration=3, use_kernel=True)
    trained.init_weights(torch.Generator().manual_seed(123))
    path = str(tmp_path / "hand_net_final.pth")
    torch.save({"state_dict": trained.state_dict()}, path)
    ev = evaluator.Evaluator(
        dataclasses.replace(opt, checkpoint_path_eval=path), image_size=IMG,
        dataset=list(SyntheticDataset(2, num_batches=1, image_size=IMG)),
        device="cpu")
    fresh = evaluator.Evaluator(
        dataclasses.replace(opt, checkpoint_path_eval=""), image_size=IMG,
        device="cpu")
    for mine, saved, other in zip(ev.model.mains, trained.mains,
                                  fresh.model.mains):
        assert torch.equal(mine.w, saved.w)
        assert not torch.equal(mine.w, other.w)
    result = ev.eval()
    assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])


def test_evaluator_on_stb_tree(tmp_path, small_models):
    """``--eval_dataset STB`` through make_dataset and the prefetcher on a
    written tree: one batch of the two eval sequences' frames."""
    data_dir = write_stb_tree(tmp_path / "stb", EVAL_SEQS, n=1)
    opt = _opt(tmp_path, data_dir=data_dir, synthetic_data=False,
               batch_size=2)
    result = evaluator.Evaluator(opt, image_size=224, device="cpu").eval(
        eval_dataset="STB")
    assert np.isfinite(result["mpjpe_mm"]) and result["pck"].shape == (7, 22)


def test_injected_dataset_refuses_a_name(tmp_path, state_dict, batches,
                                         small_models):
    ev = evaluator.Evaluator(_opt(tmp_path), image_size=IMG, dataset=batches,
                             state_dict=state_dict, device="cpu")
    with pytest.raises(ValueError, match="injected dataset"):
        ev.eval(eval_dataset="STB")


@pytest.mark.parametrize("flags,item", [
    pytest.param(dict(mesh_shape="data:-1"), 17, id="flags1-17")])
def test_unported_flags_name_their_item(tmp_path, flags, item, state_dict,
                                        batches, small_models):
    """The mesh that ROADMAP.md queue 1 item 17 ported evaluates, in a
    gloo group of one process, to the numbers of the Evaluator without
    one."""
    import torch_parallel_worker
    want = evaluator.Evaluator(_opt(tmp_path), image_size=IMG,
                               dataset=batches, state_dict=state_dict,
                               device="cpu").eval()
    with torch_parallel_worker.world_1():
        ev = evaluator.Evaluator(_opt(tmp_path / "mesh", **flags),
                                 image_size=IMG, dataset=batches,
                                 state_dict=state_dict, device="cpu")
        assert ev.mesh is not None
        got = ev.eval()
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-6)
    np.testing.assert_allclose(got["pck"], want["pck"], atol=1e-9)


@pytest.fixture(scope="module")
def weights_224():
    """(flax variables, state_dict) of the small model at 224x224 crops,
    the size the FreiHAND and HO-3D loaders produce."""
    x = np.zeros((1, 224, 224, 3), np.float32)
    v = jax.jit(lambda x: _jmodel(224).init(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, x,
        train=False))(x)
    flax = {"params": _unfreeze(v["params"]),
            "batch_stats": _unfreeze(v["batch_stats"])}
    return flax, state_dict_from_flax(flax["params"], flax["batch_stats"])


@pytest.mark.parametrize("dataset", ["frei", "ho3d"])
def test_evaluator_on_frei_and_ho3d_matches_jax(tmp_path, dataset,
                                                weights_224, small_models):
    """``--eval_dataset frei|ho3d`` through make_dataset (the training
    split, unshuffled and unjittered, as the reference evaluates it) and
    the prefetcher on written trees beside --data_dir, against the JAX
    package's Evaluator with the same weights: MPJPE and AUC within 1e-3
    relative, two batches."""
    write_frei_tree(tmp_path, n=4)
    write_ho3d_tree(tmp_path, frames=4)
    data_dir = str(tmp_path / "STB")
    jopt = jconfig.Options(net="reg_transformer", vit_heads=2, iteration=3,
                           batch_size=2, compute_dtype="float32",
                           data_dir=data_dir, eval_dataset=dataset,
                           result_dir=str(tmp_path / "jax"))
    flax, sd = weights_224
    want = jevaluator.Evaluator(jopt, image_size=224, variables=flax).eval()
    opt = _opt(tmp_path, data_dir=data_dir, synthetic_data=False,
               batch_size=2, eval_dataset=dataset)
    got = evaluator.Evaluator(opt, image_size=224, state_dict=sd,
                              device="cpu").eval()
    assert np.isfinite(got["mpjpe_mm"]) and got["mpjpe_mm"] > 0
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-3)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-3,
                               atol=1e-6)
    with open(os.path.join(opt.result_dir, "eval_metrics.csv")) as f:
        assert len(f.read().splitlines()) == 1 + 2 + 1


def test_save_pck_curve_skips_without_matplotlib(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    evaluator.save_pck_curve(evaluator.RNGE, np.linspace(10, 90, 7),
                             str(tmp_path / "PCK.png"))
    assert "skipping PCK.png" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "PCK.png")


def test_cli_needs_cuda(tmp_path):
    """``python -m scat_tpu_torch.eval`` runs on the CUDA device: without
    one it stops with the device rule's message."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "scat_tpu_torch.eval", "--net",
         "reg_transformer", "--result_dir", str(tmp_path / "eval"),
         "--checkpoint_path_eval", ""], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=300)
    assert proc.returncode != 0
    assert "runs on a CUDA device" in proc.stderr
