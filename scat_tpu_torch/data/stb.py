"""STB, the Stereo Hand Tracking Benchmark (port of
``scat_tpu/data/stb.py``; reference dataset/load_STB.py).

The loader reads the reference's layout from a local directory:

    {data_dir}/B2Counting/SK_color_0.png ...
    {data_dir}/labels/B2Counting_SK.pkl   (a dict with "handPara" [3,21,N])

Label math (numpy on the host, the reference's formulas): depth->color
transform (load_STB.py:299-305), STB->Snap joint reorder (:149), mm->m
(:234), palm->wrist root (:307-312), Simple->SMPLX reorder (:35,255),
pinhole projection (:257-258), bone-normalised 3D rescale and flip
(:98-110), left->right flip (:69-74), 1.3x square crop -> 224 (:76-96).
Labels are 63 + 42 = 105 floats (:286-289).

Pixels: PIL decodes the frames on the host and the flip, rotation, crop,
resize and normalisation run as one gather on the dataset's device
(``preprocess.fused_crop_pipeline``), after the motion blur; or, where
the native library builds, its C++ pool decodes, blurs and warps on the
host (``native_loader``).  Both paths draw the augmentation from one
``np.random.RandomState`` stream in one order (angle, then blur use,
size and axis), so a seed gives the same batches on either path and in
the JAX package.  Batches are dicts of tensors on the device: ``image``
NHWC float32 in [-1, 1], ``label`` [B,105], ``valid`` [B].
"""

from __future__ import annotations

import importlib.util
import math
import os
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from scat_tpu_torch.config import Options
from scat_tpu_torch.data import native_loader, preprocess
from scat_tpu_torch.data.common import (EPOCH_STRIDE, epoch_order,
                                        load_rgb, local_batch_size,
                                        num_batches)
from scat_tpu_torch.data.prefetch import to_device
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.ops.geometry import (project_points_pinhole,
                                         rescale_3d_joints_flip,
                                         rotate_joints_3d, rotation_matrix_2d)
from scat_tpu_torch.ops.heatmap import draw_gaussian_heatmaps

# Simple (Snap) -> SMPLX joint order (reference load_STB.py:35)
jointsMapSimpleToSMPLX = [0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15,
                          1, 2, 3, 8, 12, 20, 16, 4]
# SMPLX -> MANO (reference load_STB.py:36)
jointsMapSMPLXToMano = [0, 1, 2, 3, 16, 4, 5, 6, 17, 7, 8, 9, 18, 10, 11,
                        12, 19, 13, 14, 15, 20]

# SK colour-camera intrinsics (reference load_STB.py:43-46)
SK_FX_COLOR, SK_FY_COLOR = 607.92271, 607.88192
SK_TX_COLOR, SK_TY_COLOR = 314.78337, 236.42484
COLOR_K = np.array([[SK_FX_COLOR, 0, SK_TX_COLOR],
                    [0, SK_FY_COLOR, SK_TY_COLOR],
                    [0, 0, 1]], dtype=np.float64)

SK_ROT_VEC = [0.00531, -0.01196, 0.00301]
SK_TRANS_VEC = [-24.0381, -0.4563, -1.2326]  # mm (load_STB.py:129-130)

STB_JOINTS = ["loc_bn_palm_L"] + [
    f"loc_bn_{f}_L_0{i}" for f in
    ("pinky", "ring", "mid", "index", "thumb") for i in range(1, 5)]
SNAP_JOINTS = ["loc_bn_palm_L"] + [
    f"loc_bn_{f}_L_0{i}" for f in
    ("thumb", "index", "mid", "ring", "pinky") for i in range(1, 5)]
_snap_id = {n: i for i, n in enumerate(SNAP_JOINTS)}
STB_TO_SNAP_ID = [_snap_id[n] for n in STB_JOINTS]

DATASETS = {
    "STB_train": {
        "image_list": ["B2Counting", "B2Random", "B3Counting", "B3Random",
                       "B4Counting", "B4Random", "B5Counting", "B5Random",
                       "B6Counting", "B6Random"],
        "image_prefix": "SK_color",
    },
    "STB_eval": {
        "image_list": ["B1Counting", "B1Random"],
        "image_prefix": "SK_color",
    },
}
FRAME_W, FRAME_H = 640, 480  # SK_color frames (load_STB.py:150)


def sk_rot_mx(rot_vec) -> np.ndarray:
    """Rodrigues with the reference's quaternion convention
    (load_STB.py:112-126: the vector part negated, so the transpose of
    the usual rotation)."""
    theta = np.linalg.norm(rot_vec)
    vector = np.asarray(rot_vec) * math.sin(theta / 2.0) / theta
    a = math.cos(theta / 2.0)
    b, c, d = -vector
    return np.array([
        [a*a + b*b - c*c - d*d, 2*(b*c + a*d), 2*(b*d - a*c)],
        [2*(b*c - a*d), a*a + c*c - b*b - d*d, 2*(c*d + a*b)],
        [2*(b*d + a*c), 2*(c*d - a*b), a*a + d*d - b*b - c*c]])


SK_ROT = sk_rot_mx(SK_ROT_VEC)


def sk_xyz_depth2color(depth_xyz: np.ndarray, trans_vec=SK_TRANS_VEC,
                       rot_mx=SK_ROT) -> np.ndarray:
    """(depth-camera xyz - t) @ R (reference load_STB.py:299-305)."""
    return (depth_xyz - np.asarray(trans_vec)) @ rot_mx


def palm2wrist(pose_xyz: np.ndarray) -> np.ndarray:
    """The root moved from the palm centre to the wrist: root = ring1 +
    2 (root - ring1) (reference load_STB.py:307-312)."""
    root_id = _snap_id["loc_bn_palm_L"]
    ring_id = _snap_id["loc_bn_ring_L_01"]
    out = pose_xyz.copy()
    out[:, root_id] = (pose_xyz[:, ring_id]
                       + 2.0 * (pose_xyz[:, root_id] - pose_xyz[:, ring_id]))
    return out


def load_stb_labels(ann_file: str) -> np.ndarray:
    """One sequence's annotation pickle -> [N,21,3] meters in Snap order
    (the SMPLX reorder is per sample, as reference load_STB.py:255)."""
    with open(ann_file, "rb") as f:
        mat_gt = pickle.load(f, encoding="latin1")
    curr = np.asarray(mat_gt["handPara"]).transpose(2, 1, 0)  # N x 21 x 3
    curr = sk_xyz_depth2color(curr)
    curr = curr[:, STB_TO_SNAP_ID, :] / 1000.0
    return palm2wrist(curr)


def project_color(joints_3d: np.ndarray) -> np.ndarray:
    """Pinhole projection with the STB colour camera's K."""
    return project_points_pinhole(joints_3d, COLOR_K, xp=np)


def rescale_3d_joints_flip_np(joints_3d: np.ndarray,
                              ref_len: float = 0.03058954) -> np.ndarray:
    """reference load_STB.py:98-110 in numpy on the host."""
    return rescale_3d_joints_flip(joints_3d, ref_len, xp=np)


def maybe_motion_blur(images: torch.Tensor, rng: np.random.RandomState
                      ) -> torch.Tensor:
    """Per-sample 1-in-6 motion blur with a random-length box along one
    axis (reference load_STB.py:154-187, the per-sample draws at
    :266-268: use, kernel size 1..10, vertical or horizontal), on the
    images' device.

    As in the JAX package, the selected samples go to a fixed number of
    slots (B // 3 + 2, index padding), each slot's box is embedded in an
    11-tap window (offsets -5..5, anchored at ksize // 2 like
    cv2.filter2D), both axes blur as shifted adds over reflect padding
    (numpy's ``reflect``, cv2's REFLECT_101, which is
    ``F.pad(mode="reflect")``), and the results are scattered back.  The
    reference's kernel holds the box at column int((k-1)/2) while
    filter2D anchors at k//2, so an EVEN size also shifts the image one
    pixel along the other axis (right for the vertical blur, down for
    the horizontal one)."""
    B = images.shape[0]
    use = rng.randint(0, 6, size=B) == 1
    ksize = rng.randint(1, 11, size=B)
    axis = rng.randint(0, 2, size=B)  # 0 vertical, 1 horizontal
    if not use.any():
        return images
    device = images.device
    n_slots = min(B, B // 3 + 2)
    sel = np.nonzero(use)[0][:n_slots]
    slots = np.full((n_slots,), sel[0], np.int64)
    slots[:len(sel)] = sel
    offs = np.arange(-5, 6)
    anchor = ksize[slots] // 2
    inside = ((offs[None] >= -anchor[:, None])
              & (offs[None] <= (ksize[slots] - 1 - anchor)[:, None]))
    w = torch.as_tensor(inside.astype(np.float32)
                        / ksize[slots][:, None].astype(np.float32),
                        device=device)
    x = images.to(torch.float32)
    idx = torch.as_tensor(slots, device=device)
    sub = x[idx].permute(0, 3, 1, 2)                      # [S,C,H,W]
    h, wd = sub.shape[2], sub.shape[3]
    pad_v = F.pad(sub, (0, 0, 5, 5), mode="reflect")
    pad_h = F.pad(sub, (5, 5, 0, 0), mode="reflect")
    vblur = sum(w[:, i, None, None, None] * pad_v[:, :, i:i + h]
                for i in range(11))
    hblur = sum(w[:, i, None, None, None] * pad_h[:, :, :, i:i + wd]
                for i in range(11))
    even = torch.as_tensor((ksize[slots] % 2 == 0)[:, None, None, None],
                           device=device)
    vshift = F.pad(vblur, (1, 0, 0, 0), mode="reflect")[..., :wd]
    hshift = F.pad(hblur, (0, 0, 1, 0), mode="reflect")[:, :, :h]
    vblur = torch.where(even, vshift, vblur)
    hblur = torch.where(even, hshift, hblur)
    vertical = torch.as_tensor((axis[slots] == 0)[:, None, None, None],
                               device=device)
    blurred = torch.where(vertical, vblur, hblur).permute(0, 2, 3, 1)
    # padding slots repeat sel[0] with its parameters: identical values,
    # so the scatter is deterministic
    return x.index_put((idx,), blurred)


def _stb_labels(j3d: torch.Tensor, j2d: torch.Tensor) -> torch.Tensor:
    B = j3d.shape[0]
    return torch.cat([j3d.reshape(B, 63), j2d.reshape(B, 42)], dim=1)


class STBDataset:
    """Local-filesystem STB loader with the reference's sample contract:
    batches of (224x224x3 [-1,1] image, 105-float label), on ``device``
    (default ``cuda``; the CPU only when asked for)."""

    def __init__(self, name: str = "STB_train", data_dir: str = "./STB/",
                 batch_size: int = 32, rotation: bool = False,
                 motion_blur: bool = False, use_heatmap: bool = False,
                 shuffle: bool = True, seed: int = 0,
                 opt: Optional[Options] = None,
                 use_native: Optional[bool] = None, device=None):
        self.device = resolve_device(device, "STBDataset")
        if use_native is None:
            use_native = native_loader.available()
        if not use_native and importlib.util.find_spec("PIL") is None:
            raise RuntimeError(
                "STBDataset has no image decoder: the native library "
                "(native/scat_native.cpp, needs g++, libjpeg and libpng) "
                "could not be built and PIL is not installed")
        self.use_native = use_native
        self.data_dir = data_dir
        self.batch_size = batch_size
        self.rotation = rotation
        self.motion_blur = motion_blur
        self.use_heatmap = use_heatmap
        self.shuffle = shuffle
        self.seed = seed
        attrs = DATASETS[name]
        ann_dir = os.path.join(data_dir, "labels")
        self.image_paths: List[str] = []
        pose_gts = []
        for image_dir in attrs["image_list"]:
            ann_file = os.path.join(
                ann_dir, image_dir + "_" + attrs["image_prefix"][:2] + ".pkl")
            if not os.path.exists(ann_file):
                continue
            curr = load_stb_labels(ann_file)
            pose_gts.append(curr)
            for i in range(curr.shape[0]):
                self.image_paths.append(os.path.join(
                    data_dir, image_dir, f"{attrs['image_prefix']}_{i}.png"))
        self.pose_gts = (np.concatenate(pose_gts, 0).astype(np.float32)
                         if pose_gts else np.zeros((0, 21, 3), np.float32))
        print(f"[stb] {name}: {len(self.image_paths)} frames in "
              f"{data_dir}, decoded by "
              f"{'the native library' if use_native else 'PIL'}, warped on "
              f"{'the host' if use_native else self.device}")

    def __len__(self) -> int:
        return num_batches(len(self.image_paths), self.batch_size)

    def _load_image(self, path: str) -> np.ndarray:
        return load_rgb(path)

    def sample_labels(self, index: int):
        """One sample's labels before the pixel work: 3D joints (SMPLX
        order, rescaled, flipped, root-centred) and 2D frame pixels."""
        joints_3d = self.pose_gts[index][jointsMapSimpleToSMPLX]
        joints_2d = project_color(joints_3d.astype(np.float64))
        joints_3d = rescale_3d_joints_flip_np(joints_3d.astype(np.float64))
        return joints_3d.astype(np.float32), joints_2d.astype(np.float32)

    def _labels(self, idxs):
        B = len(idxs)
        j3d = np.zeros((B, 21, 3), np.float32)
        j2d = np.zeros((B, 21, 2), np.float32)
        for n, i in enumerate(idxs):
            j3d[n], j2d[n] = self.sample_labels(i)
        return j3d, j2d

    def _finish(self, j3d: torch.Tensor, j2d_out: torch.Tensor, images,
                valid) -> Dict[str, torch.Tensor]:
        batch = {"image": images, "label": _stb_labels(j3d, j2d_out),
                 "valid": valid}
        if self.use_heatmap:
            batch["heatmap"] = draw_gaussian_heatmaps(j2d_out / 4.0, 56, 56,
                                                      radius=8)
        return batch

    def _native_batch(self, idxs, rng: np.random.RandomState
                      ) -> Dict[str, torch.Tensor]:
        """The C++ path: the flip(+rotation)+crop affine from the labels
        in numpy, then the native pool decodes, (blurs,) warps and
        normalises; the same draws in the same order as the PIL path."""
        B = len(idxs)
        W, H = FRAME_W, FRAME_H
        j3d, j2d = self._labels(idxs)
        angle = (rng.randint(1, 361, size=(B,)).astype(np.float32)
                 if self.rotation else None)
        blur_ksize = blur_axis = None
        if self.motion_blur:
            # maybe_motion_blur's draws: 1 in 6, size 1..10, axis
            use = rng.randint(0, 6, size=B) == 1
            ksize = rng.randint(1, 11, size=B)
            blur_axis = rng.randint(0, 2, size=B)
            blur_ksize = np.where(use, ksize, 0).astype(np.int32)
        M = preprocess.flip_affine(np.full((B,), float(W)), xp=np)
        crop_w, crop_h = W, H
        if angle is not None:
            R, crop_w, crop_h = preprocess.rotate_affine_expand(angle, W, H,
                                                                xp=np)
            M = preprocess.affine_compose(R, M, xp=np)
        ones = np.ones((B, 21, 1), np.float32)
        joints = np.einsum("bij,bnj->bni", M, np.concatenate([j2d, ones], -1))
        Mc, j2d_out = preprocess.crop_hand_affine(joints, crop_w, crop_h, 224,
                                                  xp=np)
        M = preprocess.affine_compose(Mc, M, xp=np)
        Minv = np.ascontiguousarray(
            preprocess.affine_invert(M, xp=np).astype(np.float32))
        if angle is not None:
            Mrot = rotation_matrix_2d(angle, np.zeros((B, 2), np.float32),
                                      xp=np)
            j3d = rotate_joints_3d(j3d, Mrot, xp=np).astype(np.float32)
        imgs, valid = native_loader.load_batch(
            [self.image_paths[i] for i in idxs], H, W, Minv,
            blur_ksize=blur_ksize, blur_axis=blur_axis)
        dev = self.device
        return self._finish(to_device(j3d, dev),
                            to_device(j2d_out.astype(np.float32), dev),
                            to_device(imgs, dev), to_device(valid, dev))

    def _pil_batch(self, idxs, rng: np.random.RandomState
                   ) -> Dict[str, torch.Tensor]:
        """The PIL path: host decode, then the blur, warp and
        normalisation on the device."""
        B = len(idxs)
        dev = self.device
        frames = np.stack([self._load_image(self.image_paths[i])
                           for i in idxs])
        j3d, j2d = self._labels(idxs)
        angle = (torch.as_tensor(rng.randint(1, 361, size=(B,)),
                                 dtype=torch.float32, device=dev)
                 if self.rotation else None)
        images = to_device(frames, dev)
        if self.motion_blur:
            images = maybe_motion_blur(images, rng)
        crops, j2d_out = preprocess.fused_crop_pipeline(
            images, to_device(j2d, dev), flip=True, angle_deg=angle)
        j3d = to_device(j3d, dev)
        if angle is not None:
            M = rotation_matrix_2d(angle, torch.zeros(B, 2, device=dev),
                                   xp=torch)
            j3d = rotate_joints_3d(j3d, M, xp=torch)
        return self._finish(j3d, j2d_out, crops, torch.ones(B, device=dev))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        # a fresh permutation and fresh augmentation draws every pass
        # (torch DataLoader(shuffle=True) semantics)
        order, epoch = epoch_order(self, len(self.image_paths))
        rng = np.random.RandomState(self.seed + 1 + EPOCH_STRIDE * epoch)
        B = self.batch_size
        make = self._native_batch if self.use_native else self._pil_batch
        for b in range(len(self)):
            yield make(order[b * B:(b + 1) * B], rng)


def get_loader_STB(stage: str = "training", bs: int = 128,
                   opt: Optional[Options] = None, device=None) -> STBDataset:
    """reference load_STB.py:344-353."""
    if stage not in ("training", "val", "test"):
        raise ValueError(f"stage must be training, val or test, got "
                         f"{stage!r}")
    opt = opt or Options()
    return STBDataset("STB_train", data_dir=opt.data_dir, batch_size=bs,
                      rotation=opt.rotation, motion_blur=opt.motion_blur,
                      use_heatmap=opt.use_heatmap, shuffle=True,
                      seed=opt.seed, opt=opt, device=device)


def get_loader_STB_eval(opt: Optional[Options] = None,
                        device=None) -> STBDataset:
    """reference load_STB.py:355-363."""
    opt = opt or Options()
    return STBDataset("STB_eval", data_dir=opt.data_dir,
                      batch_size=local_batch_size(opt.batch_size),
                      rotation=False, motion_blur=False, use_heatmap=False,
                      shuffle=False, seed=opt.seed, opt=opt, device=device)
