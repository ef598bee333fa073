"""Skeleton plots, feature-map tiles and the video export of the demo
(the part of ``scat_tpu/viz/draw.py:19-160,236-250`` that
``evaluation/demo.py`` calls).

Reference data_utils/draw_3d_joints.py (``plot_2d_hand``, the
per-finger bone colours of eval.py:62-67), the feature-map tiles of
eval.py:519-536 and ``generate_video`` (eval.py:72-86).  matplotlib and
cv2 are imported where they are used, so the module imports without
them; the demo skips its pictures where they are missing.
"""

from __future__ import annotations

import glob
import os

import numpy as np

# per-finger joint colours (reference eval.py:62-67)
color_hand_joints = [[1.0, 0.0, 0.0],
                     [0.0, 0.4, 0.0], [0.0, 0.6, 0.0], [0.0, 0.8, 0.0],
                     [0.0, 1.0, 0.0],   # thumb
                     [0.0, 0.0, 0.6], [0.0, 0.0, 1.0], [0.2, 0.2, 1.0],
                     [0.4, 0.4, 1.0],   # index
                     [0.0, 0.4, 0.4], [0.0, 0.6, 0.6], [0.0, 0.8, 0.8],
                     [0.0, 1.0, 1.0],   # middle
                     [0.4, 0.4, 0.0], [0.6, 0.6, 0.0], [0.8, 0.8, 0.0],
                     [1.0, 1.0, 0.0],   # ring
                     [0.4, 0.0, 0.4], [0.6, 0.0, 0.6], [0.8, 0.0, 0.8],
                     [1.0, 0.0, 1.0]]   # little

# SMPLX -> Simple skeleton order (reference draw_3d_joints.py:8-13,
# eval.py:50-61)
jointsMapSMPLXToSimple = [0, 13, 14, 15, 20, 1, 2, 3, 16, 4, 5, 6, 17,
                          10, 11, 12, 19, 7, 8, 9, 18]

BONES = [(0, 1), (1, 2), (2, 3), (3, 4),
         (0, 5), (5, 6), (6, 7), (7, 8),
         (0, 9), (9, 10), (10, 11), (11, 12),
         (0, 13), (13, 14), (14, 15), (15, 16),
         (0, 17), (17, 18), (18, 19), (19, 20)]


def plot_2d_hand(axis, coords_hw, vis=None, color_fixed=None,
                 linewidth="1", order="hw", draw_kp=True, draw_idx=False):
    """Reference eval.py:163-216 on a matplotlib axis; ``draw_idx``
    writes each joint's index (a line the reference ships commented out,
    draw_3d_joints.py:96)."""
    if order == "uv":
        coords_hw = coords_hw[:, ::-1]
    colors = np.array(color_hand_joints)
    if vis is None:
        vis = np.ones_like(coords_hw[:, 0]) == 1.0
    for a, b in BONES:
        if not (vis[a] and vis[b]):
            continue
        coords = np.stack([coords_hw[a], coords_hw[b]])
        color = colors[b] if color_fixed is None else color_fixed
        axis.plot(coords[:, 1], coords[:, 0], color=color,
                  linewidth=linewidth)
    if not draw_kp:
        return
    for i in range(21):
        if vis[i] > 0.5:
            axis.plot(coords_hw[i, 1], coords_hw[i, 0], "o",
                      color=colors[i])
            if draw_idx:
                axis.text(coords_hw[i, 1], coords_hw[i, 0], f"{i}",
                          fontsize=5, color="white")


def plot_3d_hand(ax, pose_cam_xyz):
    """Reference eval.py:218-252 on a matplotlib 3D axis."""
    if pose_cam_xyz.shape[0] != 21:
        raise ValueError(f"expected 21 joints, got {pose_cam_xyz.shape}")
    for j in range(21):
        ax.plot(pose_cam_xyz[j:j + 1, 0], pose_cam_xyz[j:j + 1, 1],
                pose_cam_xyz[j:j + 1, 2], ".", c=color_hand_joints[j],
                markersize=15)
        if j == 0:
            continue
        parent = 0 if j % 4 == 1 else j - 1
        ax.plot(pose_cam_xyz[[parent, j], 0], pose_cam_xyz[[parent, j], 1],
                pose_cam_xyz[[parent, j], 2], color=color_hand_joints[j],
                linewidth=2)
    ax.axis("auto")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")


def unnormalize_image(img_float: np.ndarray) -> np.ndarray:
    """[-1, 1] -> uint8 (reference train.py:215)."""
    return np.clip(img_float * 127.5 + 127.5, 0, 255).astype(np.uint8)


def feature_map_tiles(feat_visual_nhwc: np.ndarray, out_size: int = 224
                      ) -> np.ndarray:
    """A 21-channel map [H,W,21] as grey tiles side by side, uint8 [out,
    out*21], each channel min-max scaled (reference eval.py:519-536,
    651-665)."""
    import cv2
    tiles = []
    for i in range(feat_visual_nhwc.shape[-1]):
        m = feat_visual_nhwc[:, :, i]
        span = m.max() - m.min()
        m = (m - m.min()) / (span if span > 0 else 1.0)
        tiles.append(cv2.resize((m * 255).astype(np.uint8),
                                (out_size, out_size)))
    return np.hstack(tiles)


def generate_video(pth: str, out_pth: str, fps: int = 30):
    """The PNGs of ``pth`` as ``{out_pth}/result.avi`` (DIVX; reference
    eval.py:72-86); None when there is none."""
    import cv2
    files = sorted(glob.glob(os.path.join(pth, "*.png")))
    if not files:
        return None
    h, w = cv2.imread(files[0]).shape[:2]
    path = os.path.join(out_pth, "result.avi")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"DIVX"), fps, (w, h))
    for f in files:
        out.write(cv2.imread(f))
    out.release()
    return path
