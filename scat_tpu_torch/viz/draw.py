"""Skeleton plots, the trainer's debug grid, heatmap overlays,
feature-map tiles, the coarse head's attention maps and the video export
(the port's own copy of ``scat_tpu/viz/draw.py``).

Reference data_utils/draw_3d_joints.py (``plot_2d_hand``, the
per-finger bone colours of eval.py:62-67, the debug grid
``debug_pred_gt`` :215-236, the heatmap overlay ``vis_heatmap``
:242-286, ``fig2data``, ``draw_3d_skeleton`` :163-198,
``debug_dataset`` :201-213), the feature-map tiles of eval.py:519-536,
the attention lines of eval.py:864-944 and ``generate_video``
(eval.py:72-86).  matplotlib and cv2 are imported where they are used,
so the module imports without them: the figures of matplotlib
(``debug_pred_gt``, ``draw_3d_skeleton``, ``debug_dataset``) are
skipped with a message and return None where it is missing, and the
demo and the Evaluator skip their pictures where cv2 is.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from scat_tpu_torch.ops.heatmap import heatmap_to_coords

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



def _plt(what: str):
    """matplotlib's pyplot on the Agg backend, or None (with a message
    that ``what`` is skipped) where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"matplotlib unavailable, skipping {what}: {e}")
        return None
    return plt


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


def debug_pred_gt(image, gt_joints_2d, gt_joints_3d, pred_joints_2d,
                  pred_joints_3d, name, out_dir="debug_img"
                  ) -> Optional[str]:
    """The 2x2 GT/pred grid that the trainer saves every 100 steps as
    ``{out_dir}/debug_gt_pred_{name}.png`` (reference
    draw_3d_joints.py:215-236); None where matplotlib is missing."""
    plt = _plt("the debug grid")
    if plt is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    fig = plt.figure()
    ax1 = fig.add_subplot(221)
    ax2 = fig.add_subplot(222)
    ax3 = fig.add_subplot(223, projection="3d")
    ax4 = fig.add_subplot(224, projection="3d")
    if image is not None:
        ax1.imshow(image)
        ax2.imshow(image)
    remap = jointsMapSMPLXToSimple
    plot_2d_hand(ax1, gt_joints_2d[remap], order="uv")
    ax1.set_xlabel("ground truth 2d joints", fontsize=10)
    plot_2d_hand(ax2, pred_joints_2d[remap], order="uv")
    ax2.set_xlabel("predict 2d joints", fontsize=10)
    plot_3d_hand(ax3, gt_joints_3d[remap])
    ax3.set_xlabel("ground truth 3d joints", fontsize=10)
    plot_3d_hand(ax4, pred_joints_3d[remap])
    ax4.set_xlabel("predict 3d joints", fontsize=10)
    path = os.path.join(out_dir, f"debug_gt_pred_{name}.png")
    print(f"saving debug image: debug_gt_pred_{name}.png ...")
    fig.savefig(path)
    plt.close("all")
    return path


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


# the query joint of each finger's attention map, and its line colour
# (BGR; reference eval.py:864-944)
FINGER_QUERIES = {"index": 1, "thumb": 20, "middle": 5, "ring": 10,
                  "little": 18}
FINGER_COLORS = {"index": (0, 255, 0), "thumb": (189, 183, 107),
                 "middle": (218, 112, 214), "ring": (0, 0, 205),
                 "little": (135, 206, 235)}


def draw_attention_map(attn_row: np.ndarray, gt_lmk: np.ndarray,
                       query_idx: int, color, scale: int = 6
                       ) -> np.ndarray:
    """One attention row as lines from the query joint to the others,
    each as thick as its weight above the row's 6th-smallest, on a
    (224*scale)^2 uint8 image (reference eval.py:864-944)."""
    import cv2
    img = np.zeros((224 * scale, 224 * scale, 3), np.uint8)
    ranked = np.sort(attn_row)
    start = gt_lmk[query_idx]
    for idx, item in enumerate(gt_lmk):
        pt = (int(item[0] * scale), int(item[1] * scale))
        if idx != query_idx:
            cv2.circle(img, pt, 5, [255, 255, 255], -1)
        else:
            cv2.circle(img, pt, 20, [220, 20, 60], -1)
        if idx != query_idx and attn_row[idx] - ranked[5] > 0:
            wgt = int(max(attn_row[idx] - ranked[5], 0)
                      / (ranked[-1] - ranked[5]) * 10)
            if wgt > 0:
                cv2.line(img, (int(start[0] * scale), int(start[1] * scale)),
                         pt, color, wgt, lineType=4)
    return img


def save_attention_maps(attn: np.ndarray, gt_lmk: np.ndarray,
                        result_folder: str, frame_idx: int) -> None:
    """Each finger's map of head 0 of ``attn`` [H,N,N] about the
    landmarks ``gt_lmk`` [21,2] (pixels), as
    ``{result_folder}/attn/{finger}/{frame_idx:03d}.png``."""
    import cv2
    for finger, q in FINGER_QUERIES.items():
        folder = os.path.join(result_folder, "attn", finger)
        os.makedirs(folder, exist_ok=True)
        img = draw_attention_map(attn[0, q], gt_lmk, q, FINGER_COLORS[finger])
        cv2.imwrite(os.path.join(folder, f"{frame_idx:03d}.png"), img)


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


def vis_heatmap(img_float: np.ndarray, heatmap: np.ndarray,
                pred_ht: np.ndarray, out_path: str) -> np.ndarray:
    """GT and predicted heatmaps [J,56,56] over a [-1, 1] 224x224 crop,
    one row per joint, each with its coordinate (``heatmap_to_coords``)
    as a dot, written to ``out_path`` (reference
    draw_3d_joints.py:242-286)."""
    import cv2
    img = cv2.cvtColor(unnormalize_image(img_float), cv2.COLOR_RGB2BGR)
    rows = []
    for i in range(heatmap.shape[0]):
        pair = []
        for hm in (heatmap[i], pred_ht[i]):
            coord = heatmap_to_coords(torch.as_tensor(hm)[None])[0].numpy()
            h = np.maximum(hm, 0)
            h = h / (h.max() if h.max() > 0 else 1.0)
            h = cv2.applyColorMap(np.uint8(255 * h), cv2.COLORMAP_JET)
            over = cv2.resize(h, (224, 224)) * 0.2 + img
            cv2.circle(over, (int(coord[0]) * 4, int(coord[1]) * 4), 2,
                       (0, 0, 0), thickness=-1)
            pair.append(over)
        rows.append(np.hstack(pair))
    out = np.vstack(rows)
    cv2.imwrite(out_path, out)
    return out


def fig2data(fig) -> np.ndarray:
    """A matplotlib figure's pixels, HxWx4 RGBA uint8 (reference
    draw_3d_joints.py ``fig2data``)."""
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    return buf.reshape(h, w, 4).copy()


def draw_3d_skeleton(pose_cam_xyz: np.ndarray, image_size=(224, 224)
                     ) -> Optional[np.ndarray]:
    """A 3D skeleton figure of ``image_size`` pixels, as RGBA (reference
    draw_3d_joints.py:163-198); None where matplotlib is missing."""
    plt = _plt("the 3D skeleton")
    if plt is None:
        return None
    fig = plt.figure()
    fig.set_size_inches(image_size[0] / fig.dpi, image_size[1] / fig.dpi,
                        forward=True)
    ax = fig.add_subplot(111, projection="3d")
    plot_3d_hand(ax, pose_cam_xyz)
    ax.view_init(elev=-85, azim=-75)
    ret = fig2data(fig)
    plt.close(fig)
    return ret


def debug_dataset(image, joints_2d, joints_3d, out_path="dataset_debug"
                  ) -> Optional[str]:
    """A loader's sample as three panels: the image, the image with its 2D
    joints, the 3D joints (reference draw_3d_joints.py:201-213); None
    where matplotlib is missing."""
    plt = _plt("the dataset debug plot")
    if plt is None:
        return None
    remap = jointsMapSMPLXToSimple
    fig = plt.figure()
    ax1 = fig.add_subplot(131)
    ax2 = fig.add_subplot(132)
    ax3 = fig.add_subplot(133, projection="3d")
    ax1.imshow(image)
    ax2.imshow(image)
    plot_2d_hand(ax2, np.asarray(joints_2d)[remap], order="uv")
    plot_3d_hand(ax3, np.asarray(joints_3d)[remap])
    ax2.axis("off")
    print("saving debug dataset image...")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
