"""MHP, the Multiview Hand Pose dataset (port of
``scat_tpu/data/mhp.py``; the reference imports ``MHP_eval`` and
``get_loader_MHP`` but ships neither, so the JAX package re-derived them
from their call sites).

Call-site contracts, as there: the demo's ``MHP_eval('data_15_cam_1')``
with ``seq_len()`` and ``get_sample(i) -> (image, kp_2d [21,2], kp_3d
[21,3])`` (reference eval.py:601-634), and ``get_loader_MHP('training',
bs, opt)`` in the stage-2 and stage-6 mixes (MultiDataset.py:35,71) with
105-float labels (63 3D + 42 2D).  Disk layout of the public release:
``annotated_frames/data_N/{frame}_webcam_M.jpg`` and
``{frame}_joints.txt`` (21 rows of world millimetres, optionally led by
the joint index), extrinsics ``calibrations/data_N/webcam_M/{rvec,tvec}
.pkl``, and the intrinsics ``intrinsics.pkl`` beside them where present,
else ``DEFAULT_K``.

Labels follow the STB recipe (reference load_STB.py:257-289) without the
left-hand flip (MHP's hands are right hands seen directly): projection
with K, a joint-centred 1.3x square crop to 224 on the dataset's device
(``preprocess.crop_frames``), millimetres to metres, the bone rescale and
root-centring.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from scat_tpu_torch.config import Options
from scat_tpu_torch.data.common import (epoch_order, load_rgb, num_batches,
                                        sibling_root)
from scat_tpu_torch.data.prefetch import to_device
from scat_tpu_torch.data.preprocess import crop_frames
from scat_tpu_torch.devices import resolve_device

# the Logitech C270 intrinsics of the MHP rig (its toolkit's values)
DEFAULT_K = np.array([[614.878, 0.0, 313.219],
                      [0.0, 615.479, 231.288],
                      [0.0, 0.0, 1.0]], np.float32)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def read_joints_txt(path: str) -> np.ndarray:
    """21x3 world-frame joints (mm); rows ``i x y z`` or ``x y z``."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.replace(",", " ").split()
            if parts:
                rows.append([float(p) for p in parts][-3:])
    joints = np.asarray(rows, np.float32)
    if joints.shape != (21, 3):
        raise ValueError(f"{path}: expected 21x3 joints, got {joints.shape}")
    return joints


def world_to_camera(xyz: np.ndarray, rvec: np.ndarray,
                    tvec: np.ndarray) -> np.ndarray:
    """X_cam = R(rvec) X_world + tvec, the cv2.solvePnP convention of
    the calibration pickles (Rodrigues in float32)."""
    theta = float(np.linalg.norm(rvec))
    r = np.zeros(3, np.float32) if theta < 1e-12 else rvec / theta
    K = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]],
                  [-r[1], r[0], 0]], np.float32)
    R = (np.eye(3, dtype=np.float32) + np.sin(theta) * K
         + (1.0 - np.cos(theta)) * (K @ K))
    return xyz @ R.T + tvec.reshape(1, 3)


def project_points(K: np.ndarray, xyz_cam: np.ndarray) -> np.ndarray:
    uv = xyz_cam @ K.T
    return uv[:, :2] / np.maximum(uv[:, 2:3], 1e-8)


def normalize_3d_joints(xyz_cam_m: np.ndarray,
                        ref_len: float = 0.03058954) -> np.ndarray:
    """Bone 4-5 pinned to ``ref_len`` and root-centred on joint 1 (the
    STB recipe, reference load_STB.py:98-110) without the x mirror: the
    camera's +x and +y already run with the image's u and v."""
    length = np.linalg.norm(xyz_cam_m[4] - xyz_cam_m[5])
    out = xyz_cam_m * (ref_len / max(length, 1e-8))
    return out - out[1]


class MHPSequence:
    """One ``data_N`` sequence seen by one webcam, in the demo-loader
    protocol (the ``MHP_eval`` stand-in, reference eval.py:601-634)."""

    def __init__(self, data_dir: str, seq: str, cam: int):
        self.frames_dir = os.path.join(data_dir, "annotated_frames", seq)
        calib = os.path.join(data_dir, "calibrations", seq, f"webcam_{cam}")
        self.rvec = np.asarray(_load_pickle(os.path.join(calib, "rvec.pkl")),
                               np.float32).reshape(3)
        self.tvec = np.asarray(_load_pickle(os.path.join(calib, "tvec.pkl")),
                               np.float32).reshape(3)
        kpath = os.path.join(calib, "intrinsics.pkl")
        self.K = (np.asarray(_load_pickle(kpath), np.float32)
                  if os.path.exists(kpath) else DEFAULT_K)
        pat = re.compile(rf"^(\d+)_webcam_{cam}\.jpg$")
        self.frames: List[Tuple[str, str]] = []
        for f in sorted(os.listdir(self.frames_dir),
                        key=lambda s: (len(s), s)):
            m = pat.match(f)
            if not m:
                continue
            jt = os.path.join(self.frames_dir, f"{m.group(1)}_joints.txt")
            if os.path.exists(jt):
                self.frames.append((os.path.join(self.frames_dir, f), jt))

    def seq_len(self) -> int:
        return len(self.frames)

    def get_sample(self, i: int):
        img_path, joints_path = self.frames[i]
        xyz_cam = world_to_camera(read_joints_txt(joints_path), self.rvec,
                                  self.tvec)
        kp_2d = project_points(self.K, xyz_cam)
        kp_3d = normalize_3d_joints(xyz_cam / 1000.0)
        return (load_rgb(img_path), kp_2d.astype(np.float32),
                kp_3d.astype(np.float32))


def mhp_eval(seq_name: str, opt: Optional[Options] = None,
             data_dir: Optional[str] = None) -> MHPSequence:
    """The ``MHP_eval('data_15_cam_1')`` stand-in (reference
    eval.py:605)."""
    m = re.fullmatch(r"(data_\d+)_cam_(\d+)", seq_name)
    if not m:
        raise ValueError(f"MHP sequence name {seq_name!r} is not "
                         "'data_N_cam_M'")
    if data_dir is None:
        data_dir = sibling_root((opt or Options()).data_dir, "MHP")
    return MHPSequence(data_dir, m.group(1), int(m.group(2)))


class MHPDataset:
    """Batches of (224x224 crop, 105-float label) over every annotated
    (sequence, webcam) pair on ``device`` (default ``cuda``; the CPU only
    when asked for): the ``get_loader_MHP`` stand-in of the stage-2 and
    stage-6 mixes (reference MultiDataset.py:35,71)."""

    def __init__(self, data_dir: str, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0,
                 cameras: Tuple[int, ...] = (1, 2, 3, 4), device=None):
        self.device = resolve_device(device, "MHPDataset")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.sequences: List[MHPSequence] = []
        self.index: List[Tuple[int, int]] = []   # (sequence, frame)
        frames_root = os.path.join(data_dir, "annotated_frames")
        seqs = (sorted(os.listdir(frames_root))
                if os.path.isdir(frames_root) else [])
        for seq in seqs:
            if not os.path.isdir(os.path.join(frames_root, seq)):
                continue
            for cam in cameras:
                if not os.path.isdir(os.path.join(
                        data_dir, "calibrations", seq, f"webcam_{cam}")):
                    continue
                s = MHPSequence(data_dir, seq, cam)
                if s.seq_len():
                    si = len(self.sequences)
                    self.sequences.append(s)
                    self.index += [(si, i) for i in range(s.seq_len())]

    def __len__(self) -> int:
        return num_batches(len(self.index), self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order, _ = epoch_order(self, len(self.index))
        B = self.batch_size
        dev = self.device
        for b in range(len(self)):
            imgs, j3ds, j2ds = [], [], []
            for oi in order[b * B:(b + 1) * B]:
                si, fi = self.index[oi]
                image, kp_2d, kp_3d = self.sequences[si].get_sample(fi)
                imgs.append(image)
                j2ds.append(kp_2d)
                j3ds.append(kp_3d)
            crops, j2d_out = crop_frames(imgs, np.stack(j2ds), dev)
            label = torch.cat([to_device(np.stack(j3ds).reshape(B, 63), dev),
                               j2d_out.reshape(B, 42)], dim=1)
            yield {"image": crops, "label": label,
                   "valid": torch.ones(B, device=dev)}


def get_loader_MHP(stage: str = "training", bs: int = 32,
                   opt: Optional[Options] = None, device=None) -> MHPDataset:
    """The factory of the reference's commented call
    (MultiDataset.py:35,71)."""
    opt = opt or Options()
    return MHPDataset(sibling_root(opt.data_dir, "MHP"), bs,
                      shuffle=(stage == "training"), seed=opt.seed,
                      device=device)
