"""RHD, the Rendered Handpose Dataset (port of ``scat_tpu/data/rhd.py``;
the reference names RHD in its stage-2 mix, MultiDataset.py:28, but ships
no ``dataset/load_RHD.py``, so the JAX package re-derived it).

Sources, as there: the 105-float label layout (63 3D + 42 2D, reference
train.py:187-192); the public RHD v2 layout, ``{split}/color/{05d}.png``
and ``{split}/anno_{split}.pickle`` mapping an index to {'xyz': [42,3] m,
'uv_vis': [42,3] (u, v, visible), 'K': [3,3]}, rows 0-20 the left hand
and 21-41 the right, each wrist then every finger tip to palm; and the
STB recipe for turning a left hand into a right one (the image and u
mirrored, 3D x mirrored; reference load_STB.py:69-74,98-110).

Per sample: the hand with enough visible keypoints, each finger
reordered to the labels' wrist -> palm -> tip order, a left hand
mirrored; the crop about it runs on the dataset's device
(``preprocess.crop_frames``).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from scat_tpu_torch.config import Options
from scat_tpu_torch.data.common import (epoch_order, load_rgb, num_batches,
                                        sibling_root)
from scat_tpu_torch.data.mhp import normalize_3d_joints
from scat_tpu_torch.data.prefetch import to_device
from scat_tpu_torch.data.preprocess import crop_frames
from scat_tpu_torch.devices import resolve_device

# RHD orders each finger tip -> palm (wrist, thumb, index, middle, ring,
# pinky); the labels order it palm -> tip
RHD_TO_SNAP = [0] + [4 * f + k for f in range(5) for k in (4, 3, 2, 1)]


class RHDDataset:
    """Batches of (224x224 crop, 105-float label) over one RHD split on
    ``device`` (default ``cuda``; the CPU only when asked for).  A missing
    tree is an empty dataset, so that the stage-2 mix can leave it out."""

    def __init__(self, data_dir: str, split: str = "training",
                 batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 min_visible: int = 11, device=None):
        self.device = resolve_device(device, "RHDDataset")
        self.data_dir = data_dir
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        anno_path = os.path.join(data_dir, split, f"anno_{split}.pickle")
        self.color_dir = os.path.join(data_dir, split, "color")
        self.anno = {}
        if os.path.exists(anno_path):
            with open(anno_path, "rb") as f:
                self.anno = pickle.load(f, encoding="latin1")
        # (index, hand) pairs with enough visible keypoints to place the
        # crop; hand 0 is the left (rows 0-20), 1 the right (21-41)
        self.samples: List[tuple] = []
        for idx in sorted(self.anno.keys()):
            vis = np.asarray(self.anno[idx]["uv_vis"])[:, 2]
            for hand in (0, 1):
                if vis[21 * hand:21 * (hand + 1)].sum() >= min_visible:
                    self.samples.append((idx, hand))

    def __len__(self) -> int:
        return num_batches(len(self.samples), self.batch_size)

    def _load_image(self, idx: int) -> np.ndarray:
        return load_rgb(os.path.join(self.color_dir, f"{idx:05d}.png"))

    def get_sample(self, i: int):
        """(image, kp_2d [21,2] px, kp_3d [21,3] normalised); a left hand
        mirrored into a right one (u flipped, 3D x mirrored)."""
        idx, hand = self.samples[i]
        a = self.anno[idx]
        sl = slice(21 * hand, 21 * (hand + 1))
        kp_2d = np.asarray(a["uv_vis"], np.float32)[sl, :2][RHD_TO_SNAP]
        xyz = np.asarray(a["xyz"], np.float32)[sl][RHD_TO_SNAP]
        image = self._load_image(idx)
        if hand == 0:   # left -> right (reference load_STB.py:69-74)
            image = image[:, ::-1]
            kp_2d[:, 0] = image.shape[1] - 1 - kp_2d[:, 0]
            xyz = xyz * np.array([-1.0, 1.0, 1.0], np.float32)
        return image, kp_2d, normalize_3d_joints(xyz).astype(np.float32)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        order, _ = epoch_order(self, len(self.samples))
        B = self.batch_size
        dev = self.device
        for b in range(len(self)):
            imgs, j3ds, j2ds = [], [], []
            for oi in order[b * B:(b + 1) * B]:
                image, kp_2d, kp_3d = self.get_sample(int(oi))
                imgs.append(image)
                j2ds.append(kp_2d)
                j3ds.append(kp_3d)
            crops, j2d_out = crop_frames(imgs, np.stack(j2ds), dev)
            label = torch.cat([to_device(np.stack(j3ds).reshape(B, 63), dev),
                               j2d_out.reshape(B, 42)], dim=1)
            yield {"image": crops, "label": label,
                   "valid": torch.ones(B, device=dev)}


def get_loader_RHD(stage: str = "training", bs: int = 32,
                   opt: Optional[Options] = None, device=None) -> RHDDataset:
    """The factory of the missing ``dataset/load_RHD.py``, on the other
    loaders' surface."""
    opt = opt or Options()
    split = "training" if stage == "training" else "evaluation"
    return RHDDataset(sibling_root(opt.data_dir, "RHD_published_v2", "RHD"),
                      split, bs,
                      shuffle=(stage == "training"), seed=opt.seed,
                      device=device)
