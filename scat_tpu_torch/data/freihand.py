"""FreiHAND (port of ``scat_tpu/data/freihand.py``; the reference's
``dataset/load_frei_3d.py`` is missing from its public snapshot, so the
JAX package re-derived it).

Sources of the re-derivation, as there: the 166-float label layout the
reference train loop reads (train.py:193-196), ``[cam3 | pose48 |
shape10 | 3D63 | 2D42]``; the FreiHAND helpers reference
load_test_dataset.py ships (the OpenGL projection :33-53, the split sizes
:55-62, the bone-normalised rescale with the 180 degree x rotation
:91-103, the pose rotation :159-167); and the public disk layout
(``training/rgb/%08d.jpg``, ``training_{K,xyz,mano}.json``).

Pixels stay on the host: PIL decodes each frame and resizes it to 224
bilinearly when it is another size (the 2D labels scaled with it), or,
where the native library builds and the frames are 224x224, its C++ pool
decodes the batch and PIL re-decodes what it rejects.  The training
split's ColorJitter runs in numpy on the host (``color_jitter_np``) on a
``np.random.RandomState`` seeded as the JAX package seeds it, so batches
equal the JAX package's.  Batches are dicts of tensors on the dataset's
device: ``image`` NHWC float32 in [-1, 1], ``label`` [B,166], ``valid``
[B].
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScipyRotation

from scat_tpu_torch.config import Options
from scat_tpu_torch.data import native_loader
from scat_tpu_torch.data.common import (EPOCH_STRIDE, epoch_order, num_batches,
                                        sibling_root)
from scat_tpu_torch.data.prefetch import to_device
from scat_tpu_torch.data.preprocess import color_jitter_np
from scat_tpu_torch.devices import resolve_device

COORD_CHANGE_MAT = np.array([[1., 0., 0.], [0., -1., 0.], [0., 0., -1.]],
                            dtype=np.float32)
FRAME = 224   # the released frames' size, the crop size


def db_size(set_name: str) -> int:
    """Reference load_test_dataset.py:55-62."""
    if set_name == "train":
        return 65920
    if set_name == "evaluation":
        return 11524
    raise ValueError(f"invalid FreiHAND set {set_name!r}")


def project_3D_points(cam_mat: np.ndarray, pts3D: np.ndarray,
                      is_OpenGL_coords: bool = True) -> np.ndarray:
    """Reference load_test_dataset.py:33-53."""
    if pts3D.ndim != 2 or pts3D.shape[-1] != 3:
        raise ValueError(f"expected [N,3] points, got {pts3D.shape}")
    if is_OpenGL_coords:
        pts3D = pts3D.dot(COORD_CHANGE_MAT.T)
    proj = pts3D.dot(cam_mat.T)
    return np.stack([proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]],
                    axis=1)


def rescale_3d_joints(joints_3d: np.ndarray,
                      ref_len: float = 0.03058954) -> np.ndarray:
    """Reference load_test_dataset.py:91-103: bone 4-5 pinned to
    ``ref_len``, root-centred on joint 1, rotated 180 degrees about x (y
    and z negated)."""
    length = np.linalg.norm(joints_3d[4] - joints_3d[5])
    out = joints_3d * (ref_len / length)
    out = out - out[1]
    return out * np.array([1, -1, -1])


def rotate_pose(pose: np.ndarray) -> np.ndarray:
    """A 180 degree x rotation composed into the global orient
    (reference load_test_dataset.py:159-167)."""
    out = pose.copy()
    r = ScipyRotation.from_rotvec(pose[:3])
    rx = ScipyRotation.from_rotvec([np.pi, 0, 0])
    out[:3] = (rx * r).as_rotvec()
    return out


def rotate_pose_param(pose: np.ndarray, angle_deg: float) -> np.ndarray:
    """The global-orient rotvec rotated about z by (360 - angle) degrees
    (reference dataset/rotation.py:83-91); the reference's
    rotvec -> quaternion -> rotvec round trip is the same map as
    composing the two scipy Rotations."""
    out = pose.copy()
    rz = ScipyRotation.from_rotvec([0.0, 0.0, np.deg2rad(360.0 - angle_deg)])
    out[:3] = (rz * ScipyRotation.from_rotvec(pose[:3])).as_rotvec()
    return out


def pack_label_166(pose48: np.ndarray, shape10: np.ndarray,
                   joints_3d: np.ndarray, joints_2d: np.ndarray,
                   cam3: Optional[np.ndarray] = None) -> np.ndarray:
    """[cam3 | pose48 | shape10 | 3D63 | 2D42] = 166 floats (the layout
    of reference train.py:193-196)."""
    out = np.zeros((166,), np.float32)
    if cam3 is not None:
        out[:3] = cam3
    out[3:51] = pose48
    out[51:61] = shape10
    out[61:124] = joints_3d.reshape(-1)
    out[124:] = joints_2d.reshape(-1)
    return out


class FreiHANDDataset:
    """Batches of (224x224x3 [-1,1] image, 166-float label) on ``device``
    (default ``cuda``; the CPU only when asked for)."""

    def __init__(self, data_dir: str, split: str = "training",
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 color_jitter: bool = True,
                 use_native: Optional[bool] = None, device=None):
        self.device = resolve_device(device, "FreiHANDDataset")
        if importlib.util.find_spec("PIL") is None:
            raise RuntimeError("FreiHANDDataset needs PIL to decode frames")
        self.data_dir = data_dir
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        # ColorJitter(0.5, 0.5, 0.5, 0.1) on the training split
        # (reference load_test_dataset.py:72-79)
        self.color_jitter = color_jitter and split == "training"
        with open(os.path.join(data_dir, f"{split}_K.json")) as f:
            self.K = np.asarray(json.load(f), np.float32)
        with open(os.path.join(data_dir, f"{split}_xyz.json")) as f:
            self.xyz = np.asarray(json.load(f), np.float32)
        mano_path = os.path.join(data_dir, f"{split}_mano.json")
        self.mano = None
        if os.path.exists(mano_path):
            with open(mano_path) as f:
                self.mano = np.asarray(json.load(f), np.float32)
        self.rgb_dir = os.path.join(data_dir, split, "rgb")
        self.n_images = len([f for f in os.listdir(self.rgb_dir)
                             if f.endswith((".jpg", ".png"))])
        # versioned copies of the frames reuse the unique label set
        self.n_unique = self.xyz.shape[0]
        if use_native is None:
            use_native = native_loader.available()
        # the native warp is an exact identity only at the frames' own
        # 224x224; other sizes keep PIL's bilinear resize, which clamps
        # at the borders where the warp would fill
        self.use_native = use_native and self._frames_are_224()
        self._warned_native_fallback = False
        decoder = "the native library" if self.use_native else "PIL"
        print(f"[FreiHAND] {split}: {self.n_images} frames in {data_dir}, "
              f"decoded by {decoder}, color jitter "
              f"{'on' if self.color_jitter else 'off'}")

    def _frames_are_224(self) -> bool:
        if self.n_images == 0:
            return False
        from PIL import Image
        try:
            with Image.open(self._image_path(0)) as im:
                return im.size == (FRAME, FRAME)
        except OSError:
            return False

    def _image_path(self, index: int) -> str:
        path = os.path.join(self.rgb_dir, f"{index:08d}.jpg")
        if not os.path.exists(path):
            path = os.path.join(self.rgb_dir, f"{index:08d}.png")
        return path

    def __len__(self) -> int:
        return num_batches(self.n_images, self.batch_size)

    def sample_labels(self, index: int) -> np.ndarray:
        uid = index % self.n_unique
        xyz = self.xyz[uid]
        joints_2d = project_3D_points(self.K[uid], xyz,
                                      is_OpenGL_coords=False)
        joints_3d = rescale_3d_joints(xyz.copy())
        if self.mano is not None:
            mano = self.mano[uid].reshape(-1)
            pose = rotate_pose(mano[:48].copy())
            shape = mano[48:58] if mano.shape[0] >= 58 else np.zeros(10)
        else:
            pose = np.zeros(48, np.float32)
            shape = np.zeros(10, np.float32)
        return pack_label_166(pose, shape, joints_3d, joints_2d)

    def _load_image_scaled(self, index: int):
        """(224x224 image, sx, sy): the resize factors apply to the 2D
        labels too."""
        from PIL import Image
        with Image.open(self._image_path(index)) as im:
            img = im.convert("RGB")
        sx = sy = 1.0
        if img.size != (FRAME, FRAME):
            # torchvision's Resize is bilinear; PIL's default is bicubic
            sx, sy = FRAME / img.size[0], FRAME / img.size[1]
            img = img.resize((FRAME, FRAME), Image.BILINEAR)
        return np.asarray(img), sx, sy

    def _load_image(self, index: int) -> np.ndarray:
        return self._load_image_scaled(index)[0]

    @staticmethod
    def _rescale_2d_labels(labels: np.ndarray, n: int, sx: float,
                           sy: float) -> None:
        """Row ``n``'s 2D pixel labels ([124:166]) scaled in place."""
        if sx != 1.0 or sy != 1.0:
            j2 = labels[n, 124:166].reshape(21, 2)
            labels[n, 124:166] = (j2 * (sx, sy)).reshape(42)

    def _native_images(self, idxs, labels: np.ndarray):
        """The native pool's identity warp at 224; a frame it rejects (a
        size or format it cannot read) is decoded by PIL, and only a
        frame PIL cannot read either stays invalid."""
        identity = np.tile(np.asarray([1, 0, 0, 0, 1, 0], np.float32),
                           (len(idxs), 1))
        images, valid = native_loader.load_batch(
            [self._image_path(i) for i in idxs], FRAME, FRAME, identity)
        for n in np.flatnonzero(valid == 0):
            try:
                im, sx, sy = self._load_image_scaled(idxs[n])
            except OSError:
                continue
            self._rescale_2d_labels(labels, n, sx, sy)
            images[n] = im.astype(np.float32) / 127.5 - 1.0
            valid[n] = 1.0
            if not self._warned_native_fallback:
                self._warned_native_fallback = True
                print(f"[FreiHAND] native decode rejected "
                      f"{self._image_path(idxs[n])} (size or format); PIL "
                      "decodes such frames this run")
        return images, valid

    def _pil_images(self, idxs, labels: np.ndarray):
        loaded = [self._load_image_scaled(i) for i in idxs]
        for n, (_, sx, sy) in enumerate(loaded):
            self._rescale_2d_labels(labels, n, sx, sy)
        images = np.stack([im for im, _, _ in loaded]).astype(
            np.float32) / 127.5 - 1.0
        return images, np.ones((len(idxs),), np.float32)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order, epoch = epoch_order(self, self.n_images)
        # +1 keeps the jitter stream apart from epoch_order's shuffle
        # stream, as the STB augmentation's
        jitter_rng = np.random.RandomState(
            (self.seed + 1 + EPOCH_STRIDE * epoch) % (2 ** 31))
        B = self.batch_size
        dev = self.device
        for b in range(len(self)):
            idxs = order[b * B:(b + 1) * B]
            labels = np.stack([self.sample_labels(i) for i in idxs])
            images, valid = (self._native_images if self.use_native
                             else self._pil_images)(idxs, labels)
            if self.color_jitter:
                images = color_jitter_np(jitter_rng, images)
            yield {"image": to_device(images, dev),
                   "label": to_device(labels, dev),
                   "valid": to_device(valid, dev)}


def get_loader_frei(stage: str = "training", bs: int = 32,
                    opt: Optional[Options] = None, *,
                    shuffle: Optional[bool] = None,
                    color_jitter: Optional[bool] = None,
                    device=None) -> FreiHANDDataset:
    """The missing module's factory (reference eval.py:37).  The
    reference evaluates FreiHAND with ``stage='training'`` (eval.py:793),
    the training split, since the public evaluation split has no xyz
    labels; other stages take the ``evaluation`` split where its labels
    exist.  ``shuffle`` and ``color_jitter`` default from ``stage``; the
    evaluation of the training split passes both False (eval.py:796,
    load_test_dataset.py:81-89)."""
    opt = opt or Options()
    data_dir = sibling_root(opt.data_dir, "FreiHAND")
    split = "training"
    if stage != "training" and os.path.exists(
            os.path.join(data_dir, "evaluation_xyz.json")):
        split = "evaluation"
    if shuffle is None:
        shuffle = stage == "training"
    if color_jitter is None:
        color_jitter = stage == "training"
    return FreiHANDDataset(data_dir, split, bs, shuffle=shuffle,
                           seed=opt.seed, color_jitter=color_jitter,
                           device=device)


def get_loader_frei_eval(opt: Optional[Options] = None,
                         device=None) -> FreiHANDDataset:
    opt = opt or Options()
    return get_loader_frei("val", opt.batch_size, opt, device=device)
