"""HO-3D (port of ``scat_tpu/data/ho3d.py``; the reference's
``dataset/load_ho3d_ding.py`` is missing from its public snapshot, so the
JAX package re-derived it).

Sources, as there: the 166-float label layout (reference
train.py:193-196, FreiHAND's), the OpenGL projection of reference
load_test_dataset.py:33-53 (HO-3D's annotations are in OpenGL
coordinates), the MANO -> Simple joint order (:23-28), and the public
HO-3D v2 layout (``train/{seq}/rgb/{frame}.png`` and
``meta/{frame}.pkl`` with handJoints3D, handPose, handBeta, camMat).

PIL decodes the frames on the host; the crop about the hand (no flip:
HO-3D's hands are right hands) runs as one gather on the dataset's
device (``preprocess.crop_frames``).  Batches are dicts of tensors on
the device: ``image`` NHWC float32 in [-1, 1], ``label`` [B,166],
``valid`` [B].
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from scat_tpu_torch.config import Options
from scat_tpu_torch.data.common import (epoch_order, load_rgb, num_batches,
                                        sibling_root)
from scat_tpu_torch.data.freihand import (pack_label_166, project_3D_points,
                                          rescale_3d_joints)
from scat_tpu_torch.data.prefetch import to_device
from scat_tpu_torch.data.preprocess import crop_frames
from scat_tpu_torch.devices import resolve_device

# MANO joint order -> the Simple (Snap) order of the training labels
# (reference load_test_dataset.py:23-28)
jointsMapManoToSimple = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
                         10, 11, 12, 19, 7, 8, 9, 20]


class HO3DDataset:
    """Batches of (224x224x3 crop, 166-float label) on ``device``
    (default ``cuda``; the CPU only when asked for)."""

    def __init__(self, data_dir: str, split: str = "train",
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 device=None):
        self.device = resolve_device(device, "HO3DDataset")
        self.data_dir = data_dir
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        split_dir = os.path.join(data_dir, split)
        self.samples: List[Tuple[str, str]] = []
        for seq in sorted(os.listdir(split_dir)):
            rgb = os.path.join(split_dir, seq, "rgb")
            meta = os.path.join(split_dir, seq, "meta")
            if not (os.path.isdir(rgb) and os.path.isdir(meta)):
                continue
            for f in sorted(os.listdir(rgb)):
                m = os.path.join(meta, os.path.splitext(f)[0] + ".pkl")
                if os.path.exists(m):
                    self.samples.append((os.path.join(rgb, f), m))

    def __len__(self) -> int:
        return num_batches(len(self.samples), self.batch_size)

    def sample_labels(self, meta_path: str):
        """(166-float label, 2D joints in frame pixels [21,2])."""
        with open(meta_path, "rb") as f:
            meta = pickle.load(f, encoding="latin1")
        xyz = np.asarray(meta["handJoints3D"],
                         np.float32)[jointsMapManoToSimple]
        K = np.asarray(meta["camMat"], np.float32)
        joints_2d = project_3D_points(K, xyz, is_OpenGL_coords=True)
        joints_3d = rescale_3d_joints(xyz.copy())
        pose = np.asarray(meta.get("handPose", np.zeros(48)),
                          np.float32).reshape(-1)[:48]
        shape = np.asarray(meta.get("handBeta", np.zeros(10)),
                           np.float32).reshape(-1)[:10]
        return pack_label_166(pose, shape, joints_3d, joints_2d), joints_2d

    def _load_image(self, path: str) -> np.ndarray:
        return load_rgb(path)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order, _ = epoch_order(self, len(self.samples))
        B = self.batch_size
        dev = self.device
        for b in range(len(self)):
            imgs, labels, j2ds = [], [], []
            for i in order[b * B:(b + 1) * B]:
                rgb_path, meta_path = self.samples[i]
                label, j2d = self.sample_labels(meta_path)
                imgs.append(self._load_image(rgb_path))
                labels.append(label)
                j2ds.append(j2d)
            crops, j2d_out = crop_frames(imgs, np.stack(j2ds), dev)
            label = to_device(np.stack(labels), dev)
            label[:, 124:] = j2d_out.reshape(B, 42)
            yield {"image": crops, "label": label,
                   "valid": torch.ones(B, device=dev)}


def get_loader_ho3d(stage: str = "training", bs: int = 32,
                    opt: Optional[Options] = None, *,
                    shuffle: Optional[bool] = None,
                    device=None) -> HO3DDataset:
    """The missing module's factory (reference eval.py:38).  The
    reference evaluates HO-3D with ``stage='training'`` (eval.py:795): the
    public evaluation split has no hand labels.  Other stages take the
    ``evaluation`` split only where a probe of its first meta reads a full
    annotation.  ``shuffle`` defaults from ``stage``; the evaluation of
    the train split passes False (eval.py:796)."""
    opt = opt or Options()
    data_dir = sibling_root(opt.data_dir, "HO3D")
    split = "train"
    if stage != "training" and os.path.isdir(
            os.path.join(data_dir, "evaluation")):
        probe = HO3DDataset(data_dir, "evaluation", bs, shuffle=False,
                            seed=opt.seed, device=device)
        try:
            if probe.samples:
                probe.sample_labels(probe.samples[0][1])
                split = "evaluation"
        except (KeyError, TypeError, ValueError, IndexError, OSError,
                EOFError, pickle.UnpicklingError) as e:
            # an unlabeled split (missing keys, handJoints3D None, a
            # wrist-only array) or an unreadable meta: the train split,
            # as the reference evaluates
            print("[ho3d] evaluation split present but unlabeled or "
                  f"unreadable ({type(e).__name__}: {e}); evaluating on the "
                  "train split like the reference (eval.py:795)")
    if shuffle is None:
        shuffle = stage == "training"
    return HO3DDataset(data_dir, split, bs, shuffle=shuffle, seed=opt.seed,
                       device=device)


def get_loader_ho3d_eval(opt: Optional[Options] = None,
                         device=None) -> HO3DDataset:
    opt = opt or Options()
    return get_loader_ho3d("val", opt.batch_size, opt, device=device)
