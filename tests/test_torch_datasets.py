"""The port's FreiHAND, HO-3D, MHP and RHD loaders, the stage mixes, the
folder-of-images test set, the heatmap decoding, GrabCut and the
acceleration metrics against the JAX package's, on the CPU; and the
Trainer on a stage-2 mix.

Trees are written by ``dataset_trees`` (smooth frames, hands that project
inside them), as the JAX package's tests write their own; both packages
read the same files with the same seed.  Tolerances: images within 1e-4
(FreiHAND's host path equal), labels within 1e-5; each is stated where
it is used."""

import csv
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scat_tpu.config import Options as JOptions
from scat_tpu.data import freihand as jfrei
from scat_tpu.data import ho3d as jho3d
from scat_tpu.data import mhp as jmhp
from scat_tpu.data import multi as jmulti
from scat_tpu.data import native_loader as jnative
from scat_tpu.data import rhd as jrhd
from scat_tpu.data import segmentation as jseg
from scat_tpu.data import testset as jtestset
from scat_tpu.ops import heatmap_coord as jhc
from scat_tpu.ops import metrics as jmetrics
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.data import (freihand, ho3d, mhp, native_loader, rhd,
                                 segmentation, testset)
from scat_tpu_torch.data.multi import concat_dataset
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.ops import heatmap_coord, metrics
from scat_tpu_torch.training import trainer as trainer_lib
from scat_tpu_torch.utils import checkpoint
from dataset_trees import (_ramp, write_frei_tree, write_ho3d_tree,
                           write_mhp_tree, write_rhd_tree)
from stb_tree import TRAIN_SEQS, _smooth, write_stb_tree

BS = 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _first_batches(ds, k=2):
    it = iter(ds)
    return [next(it) for _ in range(k)]


def _batches_close(got, want, width, image_atol=1e-4):
    """Images within ``image_atol``; labels: 3D joints (meters) within
    1e-5, 2D joints (pixels) within 1e-5 relative; valid equal."""
    for g, w in zip(got, want):
        assert g["image"].shape == (BS, 224, 224, 3)
        assert g["label"].shape == (BS, width) and g["valid"].shape == (BS,)
        np.testing.assert_allclose(_np(g["image"]), np.asarray(w["image"]),
                                   atol=image_atol)
        gl, wl = _np(g["label"]), np.asarray(w["label"])
        j2d = slice(124, 166) if width == 166 else slice(63, 105)
        np.testing.assert_allclose(np.delete(gl, np.r_[j2d], 1),
                                   np.delete(wl, np.r_[j2d], 1), atol=1e-5)
        np.testing.assert_allclose(gl[:, j2d], wl[:, j2d], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(g["valid"]), np.asarray(w["valid"]))
    img = _np(got[0]["image"])
    assert -1 <= img.min() and img.max() <= 1 and img.std() > 0.05


def _opts(data_dir, **kw):
    """The port's and the JAX package's Options with the same fields."""
    return Options(data_dir=data_dir, **kw), JOptions(data_dir=data_dir, **kw)


# ---------------------------------------------------------------------------
# FreiHAND

@pytest.mark.parametrize("size,jitter,native", [
    (64, True, False), (224, False, False), (224, True, True)],
    ids=["pil-resize-jitter", "pil-224", "native-224-jitter"])
def test_freihand_matches_jax(tmp_path, size, jitter, native):
    """FreiHANDDataset against the JAX package's on the same tree and
    seed, shuffled, over two batches: the PIL path (with the bilinear
    resize and its 2D label scaling at 64x64) and the native path at
    224: images equal, labels within 1e-5."""
    if native and not (native_loader.available() and jnative.available()):
        pytest.skip("native library not built (needs g++, libjpeg, libpng)")
    root = write_frei_tree(tmp_path, n=4 * BS, size=size)
    kw = dict(batch_size=BS, shuffle=True, seed=3, color_jitter=jitter,
              use_native=native)
    want = _first_batches(jfrei.FreiHANDDataset(root, "training", **kw))
    ds = freihand.FreiHANDDataset(root, "training", device="cpu", **kw)
    assert len(ds) == 4 and ds.use_native == native
    got = _first_batches(ds)
    _batches_close(got, want, 166, image_atol=0)
    lab = _np(got[0]["label"])
    np.testing.assert_allclose(lab[:, 61:124].reshape(BS, 21, 3)[:, 1], 0,
                               atol=1e-6)
    # two epochs draw two permutations and two jitter streams
    again = _first_batches(ds, 1)[0]
    assert not np.array_equal(_np(again["image"]), _np(got[0]["image"]))


FREI_HELPERS = ("project_3D_points", "rescale_3d_joints", "rotate_pose",
                "rotate_pose_param", "pack_label_166", "db_size")


@pytest.mark.parametrize("name", FREI_HELPERS)
def test_freihand_label_helpers_match_jax(rng, name):
    """The label math on the same inputs: equal to 1e-6."""
    xyz = (rng.rand(21, 3) * 0.1 + [0, 0, 0.5]).astype(np.float32)
    K = np.array([[480., 0, 112], [0, 480., 112], [0, 0, 1]], np.float32)
    pose = (rng.randn(48) * 0.5).astype(np.float32)
    cases = {
        "project_3D_points": [(K, xyz), (K, xyz, False)],
        "rescale_3d_joints": [(xyz,)],
        "rotate_pose": [(pose,)],
        "rotate_pose_param": [(pose, 17.5), (pose, 270.0)],
        "pack_label_166": [(pose, pose[:10], xyz, xyz[:, :2]),
                           (pose, pose[:10], xyz, xyz[:, :2], pose[:3])],
        "db_size": [("train",), ("evaluation",)],
    }
    for args in cases[name]:
        np.testing.assert_allclose(getattr(freihand, name)(*args),
                                   getattr(jfrei, name)(*args), atol=1e-6)


def test_freihand_factories(tmp_path):
    """get_loader_frei finds FreiHAND beside --data_dir; the training
    stage shuffles and jitters, the evaluation set (make_dataset, the
    training split as the reference evaluates it) does neither, as the
    JAX package's."""
    write_frei_tree(tmp_path)
    opt, jopt = _opts(str(tmp_path / "STB"), batch_size=BS,
                      eval_dataset="frei", synthetic_data=False)
    from scat_tpu.training.trainer import make_dataset as jmake_dataset
    for got, want in (
            (freihand.get_loader_frei("training", BS, opt, device="cpu"),
             jfrei.get_loader_frei("training", BS, jopt)),
            (freihand.get_loader_frei_eval(opt, device="cpu"),
             jfrei.get_loader_frei_eval(jopt)),
            (trainer_lib.make_dataset(opt, 224, training=False,
                                      device="cpu"),
             jmake_dataset(jopt, 224, training=False))):
        assert isinstance(got, freihand.FreiHANDDataset)
        assert (got.data_dir, got.split, got.shuffle, got.color_jitter) == (
            want.data_dir, want.split, want.shuffle, want.color_jitter)
    assert got.data_dir == str(tmp_path / "FreiHAND") and not got.shuffle


# ---------------------------------------------------------------------------
# HO-3D

def test_ho3d_matches_jax(tmp_path):
    """HO3DDataset against the JAX package's, shuffled, two batches of two
    sequences: images within 1e-4, labels within 1e-5 (the 2D labels in
    crop pixels)."""
    root = write_ho3d_tree(tmp_path, seqs=("ABF10", "GPMF11"), frames=2)
    want = _first_batches(jho3d.HO3DDataset(root, "train", BS, seed=1))
    ds = ho3d.HO3DDataset(root, "train", BS, seed=1, device="cpu")
    assert len(ds.samples) == 4 and len(ds) == 2
    got = _first_batches(ds)
    _batches_close(got, want, 166)
    j2d = _np(got[0]["label"])[:, 124:]
    assert (j2d > 0).all() and (j2d < 224).all()


@pytest.mark.parametrize("labeled", [True, False])
def test_ho3d_evaluation_split_probe(tmp_path, capsys, labeled):
    """A labelled evaluation split is taken off the training stage; an
    unlabelled one (handJoints3D None) falls back to train with the JAX
    package's message."""
    write_ho3d_tree(tmp_path, frames=2)
    write_ho3d_tree(tmp_path, seqs=("SM1",), frames=2, split="evaluation",
                    labeled=labeled)
    opt, jopt = _opts(str(tmp_path / "STB"), batch_size=BS)
    want = jho3d.get_loader_ho3d("val", BS, jopt)
    capsys.readouterr()
    got = ho3d.get_loader_ho3d_eval(opt, device="cpu")
    assert got.split == want.split == ("evaluation" if labeled else "train")
    assert ("unlabeled" in capsys.readouterr().out) != labeled
    train = ho3d.get_loader_ho3d("training", BS, opt, device="cpu")
    assert train.split == "train" and train.shuffle


# ---------------------------------------------------------------------------
# MHP

@pytest.mark.parametrize("intrinsics", [True, False])
def test_mhp_matches_jax(tmp_path, intrinsics):
    """MHPDataset over two webcams against the JAX package's, shuffled,
    two batches, with the tree's intrinsics (128x96 frames) or DEFAULT_K
    (the rig's 640x480 frames): images within 1e-4, labels within
    1e-5."""
    size = {} if intrinsics else dict(width=640, height=480, frame=_ramp)
    root = write_mhp_tree(tmp_path, cams=(1, 2), frames=2,
                          intrinsics=intrinsics, **size)
    want = _first_batches(jmhp.MHPDataset(root, BS, seed=2))
    ds = mhp.MHPDataset(root, BS, seed=2, device="cpu")
    assert len(ds.index) == 4 and len(ds) == 2
    _batches_close(_first_batches(ds), want, 105)


def test_mhp_sequence_and_helpers_match_jax(tmp_path):
    """mhp_eval's demo protocol and the label helpers on the same frames:
    images equal, joints within 1e-5."""
    root = write_mhp_tree(tmp_path, frames=3)
    got = mhp.mhp_eval("data_15_cam_1", data_dir=root)
    want = jmhp.mhp_eval("data_15_cam_1", data_dir=root)
    assert got.seq_len() == want.seq_len() == 3
    for i in range(3):
        g, w = got.get_sample(i), want.get_sample(i)
        np.testing.assert_array_equal(g[0], w[0])
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    path = got.frames[0][1]
    xyz = mhp.read_joints_txt(path)
    np.testing.assert_array_equal(xyz, jmhp.read_joints_txt(path))
    rvec = np.array([0.1, -0.2, 0.3], np.float32)
    tvec = np.array([5.0, 1.0, 40.0], np.float32)
    cam = mhp.world_to_camera(xyz, rvec, tvec)
    np.testing.assert_allclose(cam, jmhp.world_to_camera(xyz, rvec, tvec),
                               rtol=1e-6)
    np.testing.assert_allclose(mhp.project_points(mhp.DEFAULT_K, cam),
                               jmhp.project_points(jmhp.DEFAULT_K, cam),
                               rtol=1e-6)
    np.testing.assert_allclose(mhp.normalize_3d_joints(cam / 1000),
                               jmhp.normalize_3d_joints(cam / 1000),
                               atol=1e-7)
    with pytest.raises(ValueError, match="data_N_cam_M"):
        mhp.mhp_eval("data_15", data_dir=root)


# ---------------------------------------------------------------------------
# RHD

def test_rhd_matches_jax(tmp_path):
    """RHDDataset against the JAX package's, in order, with left hands
    mirrored: three batches (both hands of even frames, the right of odd
    ones), images within 1e-4, labels within 1e-5."""
    root = write_rhd_tree(tmp_path, n=4)
    want = jrhd.RHDDataset(root, "training", BS, shuffle=False)
    ds = rhd.RHDDataset(root, "training", BS, shuffle=False, device="cpu")
    assert ds.samples == want.samples and len(ds.samples) == 6
    _batches_close(_first_batches(ds, 3), _first_batches(want, 3), 105)
    img_l, kp_l, _ = ds.get_sample(ds.samples.index((0, 0)))
    img_r, kp_r, _ = ds.get_sample(ds.samples.index((0, 1)))
    np.testing.assert_array_equal(img_l, img_r[:, ::-1])
    assert sorted(rhd.RHD_TO_SNAP) == list(range(21))


def test_rhd_missing_tree_is_empty(tmp_path):
    opt = Options(data_dir=str(tmp_path / "STB"))
    ds = rhd.get_loader_RHD("training", BS, opt, device="cpu")
    assert len(ds) == 0 and ds.split == "training"
    assert rhd.get_loader_RHD("val", BS, opt, device="cpu").split \
        == "evaluation"


# ---------------------------------------------------------------------------
# the stage mixes

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """An STB tree at root/STB (two training sequences of 4 frames) and
    FreiHAND (8), HO-3D (4), MHP (4) and RHD (4 frames, 6 hands) beside
    it."""
    root = tmp_path_factory.mktemp("trees")
    write_stb_tree(root / "STB", TRAIN_SEQS, n=4)
    write_frei_tree(root, n=8)
    write_ho3d_tree(root, frames=4)
    write_mhp_tree(root, frames=4)
    write_rhd_tree(root, n=4)
    return root


STAGE_MEMBERS = {
    1: ["FreiHANDDataset", "HO3DDataset"],
    2: ["FreiHANDDataset", "HO3DDataset", "STBDataset", "MHPDataset",
        "RHDDataset"],
    3: ["STBDataset"],
    4: ["FreiHANDDataset"],
    5: ["HO3DDataset"],
    6: ["MHPDataset"],
}


@pytest.mark.parametrize("stage", sorted(STAGE_MEMBERS))
def test_concat_dataset_stages_match_jax(trees, stage, capsys):
    """Every stage's members, their order and the zip's length, as the
    JAX package's concat_dataset builds them from the same trees."""
    opt, jopt = _opts(str(trees / "STB"), stage=stage, batch_size=BS)
    want = jmulti.concat_dataset(BS, jopt)
    capsys.readouterr()
    got = concat_dataset(BS, opt, device="cpu")
    assert f"[STAGE][{stage}]" in capsys.readouterr().out
    names = [type(d).__name__ for d in got.datasets]
    assert names == STAGE_MEMBERS[stage]
    assert names == [type(d).__name__ for d in want.datasets]
    assert len(got) == len(want) == min(len(d) for d in got.datasets)
    assert all(d.device == torch.device("cpu") for d in got.datasets)


def test_stage2_leaves_out_missing_and_unreadable_trees(tmp_path, capsys):
    """Stage 2 without an RHD tree and with an MHP tree whose calibration
    lacks rvec.pkl: FreiHAND, HO-3D and STB alone, the MHP tree skipped
    with the JAX package's message."""
    write_stb_tree(tmp_path / "STB", TRAIN_SEQS, n=4)
    write_frei_tree(tmp_path, n=8)
    write_ho3d_tree(tmp_path, frames=4)
    root = write_mhp_tree(tmp_path, frames=4)
    os.remove(os.path.join(root, "calibrations", "data_15", "webcam_1",
                           "rvec.pkl"))
    opt, jopt = _opts(str(tmp_path / "STB"), stage=2, batch_size=BS)
    got = concat_dataset(BS, opt, device="cpu")
    assert "MHP tree present but unreadable" in capsys.readouterr().out
    want = jmulti.concat_dataset(BS, jopt)
    assert [type(d).__name__ for d in got.datasets] == [
        type(d).__name__ for d in want.datasets] == STAGE_MEMBERS[2][:3]


def test_stage6_empty_tree_raises(tmp_path):
    opt = Options(data_dir=str(tmp_path / "STB"), stage=6, batch_size=BS)
    with pytest.raises(FileNotFoundError, match="no MHP data"):
        concat_dataset(BS, opt, device="cpu")


def test_trainer_stage2_steps_every_member(trees, tmp_path, monkeypatch):
    """``--stage 2 --synthetic_data False`` on the CPU (a resnet18 model
    at 224): one train step per member of each tuple, label widths 166
    (FreiHAND, HO-3D) and 105 (STB, MHP, RHD) in the members' order, a
    finite loss each, and each metrics.csv row the mean of its tuple's
    five losses."""
    def small(opt, image_size=224):
        mean = assets.load_mean_params()
        return EncoderTransformer(
            mean_params=torch.from_numpy(mean), iteration=3, heads=2,
            token_dim=(image_size // 8) ** 2, backbone="resnet18",
            mask_rate=opt.mask_rate, use_kernel=True), mean

    monkeypatch.setattr(trainer_lib, "build_model", small)
    opt = Options(net="reg_transformer", batch_size=BS, vit_heads=2,
                  iteration=3, lr=5e-4, l_weight_3d=1e5, l_weight_2d=10.0,
                  mask_rate=0.2, synthetic_data=False, stage=2,
                  data_dir=str(trees / "STB"), debug=False, epoch=1,
                  log_every=1, compute_dtype="float32",
                  checkpoint_folder=str(tmp_path / "ckpt"))
    trainer = trainer_lib.Trainer(opt, device="cpu")
    seen = []
    step = trainer.train_step

    def recording_step(state, batch):
        stats = step(state, batch)
        seen.append((batch["label"].shape[1], float(stats["loss"])))
        return stats

    trainer.train_step = recording_step
    trainer.train()
    widths = [w for w, _ in seen]
    assert widths == [166, 166, 105, 105, 105] * 2
    losses = np.asarray([l for _, l in seen])
    assert np.isfinite(losses).all() and trainer.state.step == 10
    with open(os.path.join(opt.checkpoint_folder, "metrics.csv")) as f:
        rows = [float(r["loss"]) for r in csv.DictReader(f)]
    np.testing.assert_allclose(rows, losses.reshape(2, 5).mean(1),
                               rtol=1e-5)
    assert os.path.exists(os.path.join(opt.checkpoint_folder,
                                       checkpoint.FINAL_NAME))


# ---------------------------------------------------------------------------
# the test set, heatmap decoding, GrabCut, acceleration

def test_testset_matches_jax(tmp_path):
    """TestDataset on a folder of frames of two sizes (resized to 224,
    normalised) and the windowing helpers: images within 1e-6, sizes and
    names equal."""
    from PIL import Image
    for i, (h, w) in enumerate(((48, 64), (100, 80))):
        Image.fromarray(_smooth(h, w, i)).save(tmp_path / f"f{i}.png")
    got = list(testset.get_loader_test(str(tmp_path), device="cpu"))
    want = list(jtestset.get_loader_test(str(tmp_path)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g[0]), np.asarray(w[0]), atol=1e-6)
        assert g[1:] == w[1:]
    arr = np.arange(24).reshape(6, 4)
    np.testing.assert_array_equal(testset.view_as_windows(arr, (3,), 2),
                                  jtestset.view_as_windows(arr, (3,), 2))
    names = np.array(["a"] * 5 + ["b"] * 2 + ["c"] * 7)
    assert testset.split_into_chunks(names, 3, 2) \
        == jtestset.split_into_chunks(names, 3, 2)


@pytest.mark.parametrize("n_points,thresh", [(1, 0), (64, 0.2), (0, 0),
                                             (5, 10.0)])
def test_heatmap_coord_matches_jax(rng, n_points, thresh):
    """The top-n weighted average, the whole-map average (n < 1) and the
    (-1, -1) sentinel (a high threshold): equal."""
    maps = rng.rand(2, 12, 10, 3).astype(np.float32)
    np.testing.assert_array_equal(
        heatmap_coord.transfer_target(maps, thresh, n_points),
        jhc.transfer_target(maps, thresh, n_points))
    assert heatmap_coord.transfer_xy_coord(maps[0], n_points, thresh) \
        == jhc.transfer_xy_coord(maps[0], n_points, thresh)


@pytest.mark.parametrize("name", ["grabcut", "grabcut_reference"])
def test_grabcut_matches_jax(name):
    """Both seedings on a frame with a bright hand-shaped blob: the
    inpainted frames and masks equal to the JAX package's (skipped where
    cv2 is not installed)."""
    cv2 = pytest.importorskip("cv2")
    img = _smooth(96, 128, 3)
    j = np.stack([np.linspace(40, 90, 21), np.linspace(30, 70, 21)], -1)
    for x, y in j.astype(int):
        img[y - 3:y + 4, x - 3:x + 4] = 250
    # GrabCut's k-means initialisation draws from cv2's global RNG
    cv2.setRNGSeed(0)
    got = getattr(segmentation, name)(img, j, iterations=2)
    cv2.setRNGSeed(0)
    want = getattr(jseg, name)(img, j, iterations=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _vis(case):
    return None if case == "all" else np.array(
        [1, 1, 0, 1, 1, 1, 1, 0, 1, 1], np.float32)


@pytest.mark.parametrize("fn,vis", [
    ("compute_accel", "all"), ("compute_error_accel", "all"),
    ("compute_error_accel", "some"), ("accel_error_mean", "all"),
    ("accel_error_mean", "some")])
def test_accel_metrics_match_jax(rng, fn, vis):
    """The acceleration metrics on 10 frames, with and without frames
    masked out: within 1e-6 (meters)."""
    gt = (rng.randn(10, 21, 3) * 0.05).astype(np.float32)
    pred = gt + (rng.randn(10, 21, 3) * 0.01).astype(np.float32)
    args = (pred,) if fn == "compute_accel" else (gt, pred)
    v = _vis(vis)
    kw = {} if v is None else {"vis": v}
    got = getattr(metrics, fn)(*map(torch.from_numpy, args),
                               **{k: torch.from_numpy(x)
                                  for k, x in kw.items()})
    want = getattr(jmetrics, fn)(*map(jnp.asarray, args),
                                 **{k: jnp.asarray(x) for k, x in kw.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    if v is not None and fn == "compute_error_accel":
        assert (_np(got)[[0, 1, 2, 5, 6, 7]] == 0).all()


@pytest.mark.parametrize("factory", [
    lambda root: freihand.FreiHANDDataset(write_frei_tree(root)),
    lambda root: ho3d.HO3DDataset(write_ho3d_tree(root)),
    lambda root: mhp.MHPDataset(write_mhp_tree(root)),
    lambda root: rhd.RHDDataset(write_rhd_tree(root)),
    lambda root: testset.TestDataset(str(root))],
    ids=["frei", "ho3d", "mhp", "rhd", "testset"])
def test_loaders_need_cuda_by_default(tmp_path, monkeypatch, factory):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        factory(tmp_path)
