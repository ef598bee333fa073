"""The port's data side against the JAX package's, on the CPU: the loader
geometry, every preprocess function, the heatmaps, the motion blur, the
epoch plumbing, STBDataset (PIL path with rotation and motion blur, and
the native path), the native glue's size guard, ConcatDataset, the
prefetcher, and the Trainer on an STB tree.

Inputs come from seeded numpy RandomStates and go through both
packages; each tolerance is stated where it is used.  STB trees are
written by ``write_stb_tree`` (smooth frames, hands that project inside
them), as tests/test_stb.py writes its own."""

import os
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from scat_tpu.data import common as jcommon
from scat_tpu.data import native_loader as jnative
from scat_tpu.data import preprocess as jpre
from scat_tpu.data import stb as jstb
from scat_tpu.ops import geometry as jgeo
from scat_tpu.ops import heatmap as jheat
from scat_tpu_torch.config import Options
from scat_tpu_torch.data import common, native_loader, preprocess, stb
from scat_tpu_torch.data.multi import ConcatDataset
from scat_tpu_torch.data.prefetch import PrefetchIterator, prefetch_to_device
from scat_tpu_torch.ops import geometry, heatmap
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint
from stb_tree import TRAIN_SEQS, write_stb_tree

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# geometry (ops/geometry.py:120-191 of the JAX package)

def _geometry_case(name, rng):
    """(args, kwargs) of one loader geometry function on batched
    inputs."""
    B = 3
    if name == "project_points_pinhole":
        j = rng.rand(B, 21, 3) * 100 + np.array([0, 0, 500.0])
        return (j, stb.COLOR_K)
    if name == "rotation_matrix_2d":
        return (rng.uniform(1, 360, B).astype(np.float32),
                (rng.rand(B, 2) * 300).astype(np.float32))
    M = np.stack([np.asarray(jgeo.rotation_matrix_2d(
        jnp.float32(a), jnp.asarray([30.0, 40.0]))) for a in (17, 200, 333)])
    if name == "rotate_joints_2d":
        return ((rng.rand(B, 21, 2) * 200).astype(np.float32), M)
    if name == "rotate_joints_3d":
        return (rng.randn(B, 21, 3).astype(np.float32), M)
    return (rng.rand(B, 21, 3) * 0.1,)


GEOMETRY = ("project_points_pinhole", "rotation_matrix_2d",
            "rotate_joints_2d", "rotate_joints_3d", "rescale_3d_joints_flip")


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_matches_jax(rng, name):
    """Each loader geometry function on the numpy path (float64 where the
    loader passes float64) and the torch path (float32) against JAX's:
    1e-9 relative in float64, 1e-5 in float32."""
    args = _geometry_case(name, rng)
    if name == "rotate_joints_2d":
        # the JAX function has no numpy path: the reference formula
        # (rotation.py:33-34) in float64
        j, M = args
        want = np.concatenate([j, np.ones_like(j[..., :1])], -1) \
            @ np.swapaxes(M, -1, -2)
    else:
        want = getattr(jgeo, name)(*args, xp=np)
    got = getattr(geometry, name)(*args, xp=np)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    f32 = [np.asarray(a, np.float32) for a in args]
    want32 = np.asarray(getattr(jgeo, name)(*map(jnp.asarray, f32)))
    got32 = _np(getattr(geometry, name)(*map(torch.from_numpy, f32)))
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# preprocess (data/preprocess.py of the JAX package)

def _affines(rng, B=4):
    A = np.concatenate([np.eye(2)[None] + 0.3 * rng.randn(B, 2, 2),
                        rng.randn(B, 2, 1) * 10], -1).astype(np.float32)
    return A


AFFINE_CASES = ("affine_compose", "affine_invert", "flip_affine",
                "crop_hand_affine", "rotate_affine_expand",
                "identity_affine")


@pytest.mark.parametrize("name", AFFINE_CASES)
def test_affine_helpers_match_jax(rng, name):
    """The affine helpers on the torch path (float32) and the numpy path
    against JAX's, within 1e-4 of the values' scale (hundreds of
    pixels)."""
    B = 4
    joints = (rng.rand(B, 21, 2) * 400 + 50).astype(np.float32)
    angle = rng.uniform(1, 360, B).astype(np.float32)
    cases = {
        "affine_compose": ((_affines(rng), _affines(rng)), {}),
        "affine_invert": ((_affines(rng),), {}),
        "flip_affine": ((np.full((B,), 640.0, np.float32),), {}),
        "crop_hand_affine": ((joints, 640.0, 480.0, 224), {}),
        "rotate_affine_expand": ((angle, 640, 480), {}),
    }
    if name == "identity_affine":
        np.testing.assert_array_equal(
            _np(preprocess.identity_affine((B,))),
            np.asarray(jpre.identity_affine((B,))))
        return
    args, kw = cases[name]
    want = getattr(jpre, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args], **kw)
    got = getattr(preprocess, name)(*[torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in args], **kw)
    got_np = getattr(preprocess, name)(*args, xp=np, **kw)
    want_np = getattr(jpre, name)(*args, xp=np, **kw)
    if not isinstance(want, tuple):
        want, got, got_np, want_np = (want,), (got,), (got_np,), (want_np,)
    for w, g, gn, wn in zip(want, got, got_np, want_np):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(gn, wn, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("fill", [0.0, -1.0])
def test_affine_sample_matches_jax(rng, fill):
    """A batched warp whose affines (a zoom, a rotation, a shift) read
    corners outside the image, which take ``fill``: within 1e-5."""
    images = rng.rand(3, 20, 24, 3).astype(np.float32) * 2 - 1
    M = np.stack([
        [[2.5, 0.0, -10.0], [0.0, 2.5, -6.0]],
        np.asarray(jgeo.rotation_matrix_2d(jnp.float32(35.0),
                                           jnp.asarray([12.0, 10.0]))),
        [[1.0, 0.0, 7.5], [0.0, 1.0, -4.25]]]).astype(np.float32)
    want = jpre.affine_sample(jnp.asarray(images), jnp.asarray(M), 16, 18,
                              fill=fill)
    got = preprocess.affine_sample(torch.from_numpy(images),
                                   torch.from_numpy(M), 16, 18, fill=fill)
    assert (np.asarray(want) == fill).any()   # corners outside were read
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("flip,rotate", [(True, False), (False, False),
                                         (True, True)])
def test_fused_crop_pipeline_matches_jax(rng, flip, rotate):
    """flip -> (rotate) -> crop -> resize -> normalise on uint8 frames:
    crops within 1e-4 and joints within 1e-4 (pixels) of JAX's."""
    B, H, W = 3, 60, 80
    frames = (rng.rand(B, H, W, 3) * 255).astype(np.uint8)
    joints = np.stack([rng.uniform(15, 65, (B, 21)),
                       rng.uniform(10, 50, (B, 21))], -1).astype(np.float32)
    angle = rng.randint(1, 361, B).astype(np.float32) if rotate else None
    want = jpre.fused_crop_pipeline(
        jnp.asarray(frames), jnp.asarray(joints), flip=flip,
        angle_deg=None if angle is None else jnp.asarray(angle), out_size=32)
    got = preprocess.fused_crop_pipeline(
        torch.from_numpy(frames), torch.from_numpy(joints), flip=flip,
        angle_deg=None if angle is None else torch.from_numpy(angle),
        out_size=32)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=1e-4)


def test_normalize_to_unit_matches_jax(rng):
    x = (rng.rand(2, 5, 5, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(
        _np(preprocess.normalize_to_unit(torch.from_numpy(x))),
        np.asarray(jpre.normalize_to_unit(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0)])
def test_jitter_apply_matches_jax(rng, order):
    """``_jitter_apply`` with the op order and the factors injected, on
    the torch path against JAX's jnp path: within 1e-5."""
    images = rng.rand(2, 6, 7, 3).astype(np.float32) * 2 - 1
    fac = {k: rng.uniform(0.5, 1.5, (2, 1, 1, 1)).astype(np.float32)
           for k in ("brightness", "contrast", "saturation")}
    th = rng.uniform(-0.1, 0.1, (2, 1, 1)).astype(np.float32) * 2 * np.pi
    want = jpre._jitter_apply(jnp, jnp.asarray(images), order,
                              lambda n, a: jnp.asarray(fac[n]),
                              lambda a: jnp.asarray(th), 0.5, 0.5, 0.5, 0.1)
    got = preprocess._jitter_apply(torch, torch.from_numpy(images), order,
                                   lambda n, a: torch.from_numpy(fac[n]),
                                   lambda a: torch.from_numpy(th),
                                   0.5, 0.5, 0.5, 0.1)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_color_jitter_draws():
    """``color_jitter_np`` draws what the JAX package's does from one
    RandomState (within 1e-6); ``color_jitter`` on a torch.Generator is
    reproducible, stays in [-1, 1] and changes the images."""
    images = np.random.RandomState(3).rand(2, 6, 7, 3).astype(
        np.float32) * 2 - 1
    want = jpre.color_jitter_np(np.random.RandomState(5), images)
    got = preprocess.color_jitter_np(np.random.RandomState(5), images)
    np.testing.assert_allclose(got, want, atol=1e-6)
    x = torch.from_numpy(images)
    a = preprocess.color_jitter(torch.Generator().manual_seed(1), x)
    b = preprocess.color_jitter(torch.Generator().manual_seed(1), x)
    assert torch.equal(a, b) and a.shape == x.shape
    assert a.min() >= -1 and a.max() <= 1 and not torch.equal(a, x)


# ---------------------------------------------------------------------------
# heatmaps (ops/heatmap.py of the JAX package)

def test_draw_gaussian_heatmaps_matches_jax(rng):
    """Centres inside, outside and in (-1, 0), where the reference's int()
    truncates toward zero: exact to 1e-6."""
    centers = rng.uniform(-3, 20, (2, 21, 2)).astype(np.float32)
    centers[0, 0] = (-0.5, 3.2)
    centers[0, 1] = (7.9, -0.99)
    want = jheat.draw_gaussian_heatmaps(jnp.asarray(centers), 16, 18,
                                        radius=4)
    got = heatmap.draw_gaussian_heatmaps(torch.from_numpy(centers), 16, 18,
                                         radius=4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    assert _np(got)[0, 0, :, 0].max() > 0   # trunc(-0.5) = 0 is in view


def test_heatmap_to_coords_matches_jax(rng):
    """The weighted-average decode, with a zero map (the (-1, -1)
    sentinel) and an all-negative one: within 1e-5."""
    maps = rng.rand(2, 3, 9, 11).astype(np.float32)
    maps[0, 1] = 0.0
    maps[1, 2] = -rng.rand(9, 11)
    want = jheat.heatmap_to_coords(jnp.asarray(maps))
    got = heatmap.heatmap_to_coords(torch.from_numpy(maps))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(_np(got)[0, 1], [-1.0, -1.0])


# ---------------------------------------------------------------------------
# motion blur, epochs

def _blur_seed(B):
    """A seed whose draws blur samples of both an even and an odd size."""
    for seed in range(100):
        r = np.random.RandomState(seed)
        use = r.randint(0, 6, size=B) == 1
        ks = r.randint(1, 11, size=B)[use]
        if (ks % 2 == 0).any() and (ks % 2 == 1).any() and (ks > 1).all():
            return seed
    raise AssertionError("no seed found")


def test_maybe_motion_blur_matches_jax(rng):
    """One RandomState seed, both packages: the same samples blurred with
    the same even and odd sizes and axes, within 1e-4 (0..255 pixels)."""
    B = 12
    images = (rng.rand(B, 14, 16, 3) * 255).astype(np.uint8)
    seed = _blur_seed(B)
    want = jstb.maybe_motion_blur(jnp.asarray(images),
                                  np.random.RandomState(seed))
    got = stb.maybe_motion_blur(torch.from_numpy(images),
                                np.random.RandomState(seed))
    assert not np.array_equal(np.asarray(want), images.astype(np.float32))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    # no sample blurred: the images come back as they are
    none = next(s for s in range(100) if not (np.random.RandomState(s)
                                              .randint(0, 6, size=2) == 1)
                .any())
    x = torch.from_numpy(images[:2])
    assert stb.maybe_motion_blur(x, np.random.RandomState(none)) is x


class _Epochs:
    def __init__(self, shuffle, seed):
        self.shuffle, self.seed = shuffle, seed


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_order_and_num_batches_match_jax(shuffle):
    mine, theirs = _Epochs(shuffle, 7), _Epochs(shuffle, 7)
    for epoch in range(3):
        got, e1 = common.epoch_order(mine, 50)
        want, e2 = jcommon.epoch_order(theirs, 50)
        np.testing.assert_array_equal(got, want)
        assert e1 == e2 == epoch
    for n, bs in ((50, 8), (7, 8), (96, 96), (384, 96)):
        assert common.num_batches(n, bs) == jcommon.num_batches(n, bs)
    assert common.local_batch_size(96) == 96 and common.EPOCH_STRIDE == 9973


# ---------------------------------------------------------------------------
# STBDataset

def _labels_close(got, want):
    """STB labels: the 3D joints (meters) within 1e-5, the 2D joints
    (crop pixels, up to a few hundred, where a float32 ulp is 1.5e-5)
    within 1e-5 relative."""
    got, want = _np(got), np.asarray(want)
    np.testing.assert_allclose(got[:, :63], want[:, :63], atol=1e-5)
    np.testing.assert_allclose(got[:, 63:], want[:, 63:], rtol=1e-5,
                               atol=1e-5)


def _first_batches(ds, k=2):
    it = iter(ds)
    return [next(it) for _ in range(k)]


@pytest.mark.parametrize("name,augment", [("STB_eval", False),
                                          ("STB_train", True)])
def test_stb_dataset_pil_matches_jax(tmp_path, name, augment):
    """The PIL path, small frames, with rotation and motion blur on for
    the training set, on the same tree and seed as the JAX package's
    ``STBDataset(use_native=False)``: images within 1e-4, labels within
    1e-5 (``_labels_close``), over two batches."""
    data_dir = write_stb_tree(tmp_path)
    seed = 0
    if augment:
        # a seed whose first batch blurs a sample (draws: angle, then
        # use / size / axis)
        seed = next(s for s in range(100) if (
            lambda r: (r.randint(1, 361, 4), r.randint(0, 6, 4) == 1)[1]
        )(np.random.RandomState(s + 1)).any())
    kw = dict(rotation=augment, motion_blur=augment, shuffle=augment,
              seed=seed)
    want = _first_batches(jstb.STBDataset(name, data_dir, 4, use_native=False,
                                          **kw))
    ds = stb.STBDataset(name, data_dir, 4, use_native=False, device="cpu",
                        **kw)
    assert len(ds) == 2
    got = _first_batches(ds)
    for g, w in zip(got, want):
        assert g["image"].shape == (4, 224, 224, 3)
        assert g["label"].shape == (4, 105) and g["valid"].shape == (4,)
        np.testing.assert_allclose(_np(g["image"]), np.asarray(w["image"]),
                                   atol=1e-4)
        _labels_close(g["label"], w["label"])
        np.testing.assert_array_equal(_np(g["valid"]), np.asarray(w["valid"]))
    img = _np(got[0]["image"])
    assert -1 <= img.min() and img.max() <= 1 and img.std() > 0.1


def test_stb_native_path_matches_jax_native(tmp_path):
    """The native path (640x480 frames, the size it decodes) with
    rotation and motion blur against the JAX package's native path: the
    same C++ warp of the same affines, images within 1e-5, labels within
    1e-5."""
    if not (native_loader.available() and jnative.available()):
        pytest.skip("native library not built (needs g++, libjpeg, libpng)")
    data_dir = write_stb_tree(tmp_path, TRAIN_SEQS, n=2, height=480,
                              width=640)
    kw = dict(rotation=True, motion_blur=True, shuffle=False, seed=3)
    want = next(iter(jstb.STBDataset("STB_train", data_dir, 4,
                                     use_native=True, **kw)))
    got = next(iter(stb.STBDataset("STB_train", data_dir, 4, use_native=True,
                                   device="cpu", **kw)))
    np.testing.assert_allclose(_np(got["image"]), np.asarray(want["image"]),
                               atol=1e-5)
    _labels_close(got["label"], want["label"])
    np.testing.assert_array_equal(_np(got["valid"]), [1, 1, 1, 1])


@pytest.mark.parametrize("oh,ow", [(1, 224), (224, 1)])
def test_load_batch_refuses_outputs_below_two(oh, ow):
    """The C++ blur reads out of bounds on 1-pixel-wide images
    (native/scat_native.cpp:218): refused before the library is
    touched."""
    M = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="at least 2x2"):
        native_loader.load_batch(["x.png"], 480, 640, M, oh, ow)


def test_stb_dataset_needs_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stb.STBDataset("STB_eval", str(tmp_path), 2, use_native=False)


# ---------------------------------------------------------------------------
# ConcatDataset, stages, prefetch

def test_concat_dataset_zips_and_refuses_empty():
    cd = ConcatDataset([1, 2, 3], ["x", "y"])
    assert len(cd) == 2 and list(cd) == [(1, "x"), (2, "y")]
    with pytest.raises(ValueError, match="empty"):
        ConcatDataset([1, 2], [])


def test_prefetch_early_exit_stops_the_worker():
    """A consumer that leaves after 3 batches: the worker stops (it polls
    the stop flag in its puts) having produced at most depth + 2."""
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield {"x": torch.full((2,), float(i))}

    before = threading.active_count()
    it = iter(PrefetchIterator(source(), depth=2))
    got = [float(next(it)["x"][0]) for _ in range(3)]
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert got == [0.0, 1.0, 2.0]
    assert threading.active_count() == before
    assert len(produced) <= 3 + 2 + 2


def test_prefetch_raises_the_workers_error():
    def source():
        yield {"x": torch.zeros(1)}
        raise KeyError("bad frame")

    it = iter(PrefetchIterator(source(), depth=2))
    next(it)
    with pytest.raises(KeyError, match="bad frame"):
        next(it)


def test_prefetch_to_device_stages_numpy_and_tuples():
    batches = [({"a": np.ones(3, np.float32)}, {"a": torch.zeros(2)})]
    out = list(prefetch_to_device(batches, "cpu"))
    assert len(out) == 1 and isinstance(out[0], tuple)
    assert isinstance(out[0][0]["a"], torch.Tensor)
    assert out[0][0]["a"].tolist() == [1.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# the Trainer on STB

def test_trainer_on_stb_tree(tmp_path, capsys):
    """``--synthetic_data False --stage 3`` on a written tree, on the CPU:
    two steps through ConcatDataset and the prefetcher, the reference's
    loss lines, metrics.csv and hand_net_final.pth."""
    data_dir = write_stb_tree(tmp_path / "stb", TRAIN_SEQS, n=2)
    opt = Options(net="reg_transformer", batch_size=2, vit_heads=2,
                  iteration=3, lr=5e-4, l_weight_3d=1e5, l_weight_2d=10.0,
                  mask_rate=0.2, synthetic_data=False, stage=3,
                  data_dir=data_dir, rotation=True, motion_blur=True,
                  debug=False, epoch=1, log_every=1, compute_dtype="float32",
                  checkpoint_folder=str(tmp_path / "ckpt"))
    trainer = Trainer(opt, device="cpu")
    trainer.train()
    out = capsys.readouterr().out
    assert "[STAGE][3]" in out and "decoded by" in out
    assert "[1,     1] loss:" in out and "[1,     2] loss:" in out
    assert trainer.state.step == 2
    with open(os.path.join(opt.checkpoint_folder, "metrics.csv")) as f:
        rows = f.readlines()[1:]
    assert len(rows) == 2
    assert os.path.exists(os.path.join(opt.checkpoint_folder,
                                       checkpoint.FINAL_NAME))
