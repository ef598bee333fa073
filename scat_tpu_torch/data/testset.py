"""A folder of images for inference, and the temporal windowing helpers
(port of ``scat_tpu/data/testset.py``).

Reference dataset/load_test_dataset.py:169-202 (``TestDataset`` yields
``(image, w, h, filename)``) and dataset/utils.py:6-178
(``view_as_windows``, the strided rolling window, and
``split_into_chunks``, a video's frames as (start, end) windows, used by
the temporal stage and the 16-frame acceleration window, reference
eval.py:679-686).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from scat_tpu_torch.config import Options
from scat_tpu_torch.data.prefetch import to_device
from scat_tpu_torch.data.preprocess import normalize_to_unit
from scat_tpu_torch.devices import resolve_device


class TestDataset:
    """Reference load_test_dataset.py:169-197: each image resized to 224
    (bilinear, as torchvision's Resize) and normalised to [-1, 1] on
    ``device`` (default ``cuda``; the CPU only when asked for), yielded
    as (image [224,224,3], w, h, filename)."""

    def __init__(self, test_dir: str = "experiments/0218",
                 opt: Optional[Options] = None, device=None):
        self.device = resolve_device(device, "TestDataset")
        self.base_path = test_dir
        self.test_list = sorted(os.listdir(test_dir))

    def __len__(self) -> int:
        return len(self.test_list)

    def __getitem__(self, index: int):
        from PIL import Image
        name = self.test_list[index]
        with Image.open(os.path.join(self.base_path, name)) as im:
            img = im.convert("RGB")
        w, h = img.size
        arr = np.array(img.resize((224, 224), Image.BILINEAR))
        return (normalize_to_unit(to_device(arr, self.device)), w, h, name)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def get_loader_test(test_dir: str, opt: Optional[Options] = None,
                    device=None) -> TestDataset:
    """Reference load_test_dataset.py:199-202."""
    return TestDataset(test_dir, opt, device=device)


def view_as_windows(arr: np.ndarray, window_shape, step=1) -> np.ndarray:
    """Strided rolling window (the skimage routine the reference vendors,
    dataset/utils.py:6-156)."""
    if isinstance(window_shape, int):
        window_shape = (window_shape,)
    if isinstance(step, int):
        step = (step,) * arr.ndim
    window_shape = tuple(window_shape) + (1,) * (arr.ndim - len(window_shape))
    win_indices_shape = tuple((np.array(arr.shape) - np.array(window_shape))
                              // np.array(step) + 1)
    new_shape = win_indices_shape + tuple(window_shape)
    strides = tuple(np.array(arr.strides) * np.array(step)) + arr.strides
    return np.lib.stride_tricks.as_strided(arr, shape=new_shape,
                                           strides=strides)


def split_into_chunks(vid_names: np.ndarray, seqlen: int, stride: int
                      ) -> List[List[int]]:
    """A video's frames as (start, end) window indices (reference
    dataset/utils.py:158-178); videos shorter than ``seqlen`` give
    none."""
    video_start_end_indices: List[List[int]] = []
    video_names, group = np.unique(vid_names, return_index=True)
    perm = np.argsort(group)
    video_names, group = video_names[perm], group[perm]
    indices = np.split(np.arange(0, vid_names.shape[0]), group[1:])
    for idx in range(len(video_names)):
        indexes = indices[idx]
        if indexes.shape[0] < seqlen:
            continue
        chunks = view_as_windows(indexes, (seqlen,), step=stride)
        video_start_end_indices += chunks[:, (0, -1)].tolist()
    return video_start_end_indices
