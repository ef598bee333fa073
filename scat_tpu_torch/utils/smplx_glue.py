"""FrankMocap / SMPL-X glue (port of ``scat_tpu/utils/smplx_glue.py:
20-111``; reference data_utils/general_utils.py:12-72, test.py:55-86):
one hand's joints and vertices out of a whole-body model's output, and
the conversions between the 224-pixel bbox space and the original
image.  They take torch tensors or numpy arrays and return the same
kind; the SMPL-X body model itself is not part of the port (the
reference's ``smplx`` package and SMPLX_NEUTRAL.pkl are external).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

HALF = 224 * 0.5


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def _shift_xy(data3D, shift):
    """``data3D`` with ``shift`` added to its x and y, not in place."""
    if isinstance(data3D, torch.Tensor):
        shift = torch.as_tensor(shift, dtype=data3D.dtype,
                                device=data3D.device)
        return torch.cat([data3D[..., :2] + shift, data3D[..., 2:]], dim=-1)
    return np.concatenate([data3D[..., :2] + shift, data3D[..., 2:]],
                          axis=-1)


def convert_smpl_to_bbox(data3D, scale, trans, bAppTransFirst: bool = False):
    """Scale and translate into the 224 bbox space (reference
    test.py:73-86).  The reference's ``bAppTransFirst=False`` branch writes
    ``data3D[:,0:2] += trans`` on a [B,N,3] array, which shifts the first
    two joints, not x and y; as the JAX package, both branches shift x and
    y (frankmocap's original; the function is never called upstream)."""
    if not isinstance(data3D, torch.Tensor):
        data3D = np.asarray(data3D, dtype=np.float32)
    if bAppTransFirst:
        data3D = _shift_xy(data3D, trans) * scale
    else:
        data3D = _shift_xy(data3D * scale, trans)
    return data3D * HALF


def convert_bbox_to_oriIm(data3D, boxScale_o2n, bboxTopLeft,
                          imgSizeW: int, imgSizeH: int):
    """bbox space -> original-image pixels (reference test.py:55-71)."""
    if not isinstance(data3D, torch.Tensor):
        data3D = np.asarray(data3D, dtype=np.float32)
    data3D = data3D / boxScale_o2n
    shift = np.asarray(bboxTopLeft, dtype=np.float32) + HALF / boxScale_o2n
    return _shift_xy(data3D, shift)


def extract_hand_output(vertices, joints, hand_type: str, hand_info: Dict,
                        top_finger_joints_type: str = "ave") -> Dict:
    """One hand's joints and vertices out of a whole SMPL-X output
    (reference general_utils.py:12-72): the wrist, the 15 hand joints
    and 5 fingertips (vertex picks, or weighted vertex averages for
    "ave"), everything also shifted to the hand-start joint.
    ``vertices`` [B,V,3], ``joints`` [B,J,3]; ``hand_info`` holds the
    ``{side}_hand_verts_idx`` / ``{side}_top_finger_*`` tables of
    SMPLX_HAND_INFO.pkl."""
    if hand_type not in ("left", "right"):
        raise ValueError(f"hand_type {hand_type!r}: 'left' or 'right'")
    xp = _xp(vertices)

    def cat(parts):
        return torch.cat(parts, dim=1) if xp is torch else \
            np.concatenate(parts, axis=1)

    if hand_type == "left":
        wrist_idx, hand_start_idx, middle_finger_idx = 20, 25, 28
    else:
        wrist_idx, hand_start_idx, middle_finger_idx = 21, 40, 43
    root = joints[:, hand_start_idx:hand_start_idx + 1, :]
    hand_verts_idx = np.asarray(hand_info[f"{hand_type}_hand_verts_idx"],
                                dtype=np.int64)
    hand_verts = vertices[:, hand_verts_idx, :]
    hand_joints = cat([joints[:, wrist_idx:wrist_idx + 1, :],
                       joints[:, hand_start_idx:hand_start_idx + 15, :]])
    if top_finger_joints_type in ("long", "manual"):
        key = f"{hand_type}_top_finger_{top_finger_joints_type}_vert_idx"
        idx = np.asarray(hand_info[key], dtype=np.int64)
        hand_joints = cat([hand_joints, vertices[:, idx, :]])
    elif top_finger_joints_type:
        if top_finger_joints_type != "ave":
            raise ValueError(f"top_finger_joints_type "
                             f"{top_finger_joints_type!r}")
        key1 = f"{hand_type}_top_finger_ave_vert_idx"
        key2 = f"{hand_type}_top_finger_ave_vert_weight"
        tops = [hand_joints]
        for tid, selected in enumerate(hand_info[key1]):
            verts = vertices[:, hand_verts_idx[np.asarray(selected)]]
            w = np.asarray(hand_info[key2][tid],
                           dtype=np.float32).reshape(1, -1, 1)
            if xp is torch:
                w = torch.as_tensor(w, dtype=verts.dtype,
                                    device=verts.device)
            tops.append((w * verts).sum(1, keepdims=True) if xp is np
                        else (w * verts).sum(1, keepdim=True))
        hand_joints = cat(tops)
    return dict(
        wrist_idx=wrist_idx,
        hand_start_idx=hand_start_idx,
        middle_finger_idx=middle_finger_idx,
        vertices_shift=vertices - root,
        hand_vertices=hand_verts,
        hand_vertices_shift=hand_verts - root,
        hand_joints=hand_joints,
        hand_joints_shift=hand_joints - root,
    )
