"""Heatmap -> coordinate decoding on the reference's numpy surface (port
of ``scat_tpu/ops/heatmap_coord.py``; reference
data_utils/heatmap_coord.py).

The weighted average of the top ``n_points`` pixels, with the (-1, -1)
sentinel of a missing landmark when ``hsum / n_points <= thresh``
(heatmap_coord.py:10-45); ``transfer_xy_coord`` takes HxWxJ,
``transfer_target`` NxHxWxJ and returns [N, J*2].  The batched decoder
of the device pipeline is ``ops/heatmap.heatmap_to_coords``.
"""

from __future__ import annotations

from typing import List

import numpy as np


def get_ave_xy(hmi: np.ndarray, n_points: int = 1, thresh: float = 0
               ) -> List[float]:
    """[x, y] of ONE heatmap [H,W]: the weighted average of its top
    ``n_points`` pixels (the whole map when ``n_points`` < 1), or (-1, -1)
    when their mean mass is at most ``thresh`` (reference
    heatmap_coord.py:10-45)."""
    hmi = np.asarray(hmi)
    height, width = hmi.shape
    if n_points < 1:
        hsum, n_points = np.sum(hmi), hmi.size
        ind_w = np.tile(np.arange(width), (height, 1))
        i1 = np.sum(ind_w * hmi) / hsum
        ind_h = np.tile(np.arange(height), (width, 1)).T
        i0 = np.sum(ind_h * hmi) / hsum
    else:
        ind = np.argsort(hmi, axis=None)[-n_points:]
        top0, top1 = np.unravel_index(ind, hmi.shape)
        h = hmi[top0, top1]
        hsum = h.sum()
        i0 = float(np.sum(top0 * h) / hsum)
        i1 = float(np.sum(top1 * h) / hsum)
    if hsum / n_points <= thresh:
        i0, i1 = -1, -1
    return [i1, i0]


def transfer_xy_coord(hm: np.ndarray, n_points: int = 64,
                      thresh: float = 0.2) -> List[float]:
    """[H, W, J] -> a flat [J*2] (x, y) list (reference
    heatmap_coord.py:48-62)."""
    hm = np.asarray(hm)
    if hm.ndim != 3:
        raise ValueError(f"expected an [H,W,J] heatmap, got {hm.shape}")
    est_xy: List[float] = []
    for i in range(hm.shape[-1]):
        est_xy.extend(get_ave_xy(hm[:, :, i], n_points, thresh))
    return est_xy


def transfer_target(y_pred: np.ndarray, thresh: float = 0,
                    n_points: int = 1) -> np.ndarray:
    """[N, H, W, J] -> [N, J*2] (reference heatmap_coord.py:65-74)."""
    y_pred = np.asarray(y_pred)
    return np.array([transfer_xy_coord(y_pred[i], n_points, thresh)
                     for i in range(y_pred.shape[0])])
