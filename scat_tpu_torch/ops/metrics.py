"""Evaluation metrics: MPJPE, PCK, AUC, acceleration (port of
``scat_tpu/ops/metrics.py``).

Reference formulas: PCK over 20-50 mm thresholds (reference
eval.py:300-316, with the ``dist.flat`` quirk behind ``flat_compat``),
AUC by the trapezoid rule on normalized thresholds (eval.py:328-348),
MPJPE (eval.py:1026-1027), acceleration and acceleration error
(data_utils/eval_utils.py:6-48).  As in the JAX package, samples (and
frames) are excluded by a ``valid`` (``vis``) mask in {0,1} instead of
the reference's slicing, so shapes stay static.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# PCK thresholds in millimeters, reference eval.py:806/963
DEFAULT_PCK_RANGE_MM = tuple(range(20, 51, 5))


def joint_distances_mm(pred_joints: torch.Tensor, gt_joints: torch.Tensor
                       ) -> torch.Tensor:
    """Per-joint L2 distance in millimeters; inputs in meters
    ``[B,J,3]``."""
    d = pred_joints * 1000.0 - gt_joints * 1000.0
    return torch.sqrt((d * d).sum(dim=-1))


def cal_pck(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
            rnge: Sequence[float] = DEFAULT_PCK_RANGE_MM,
            flat_compat: bool = True,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PCK matrix ``[len(rnge), J+1]`` in percent.  ``flat_compat=True``
    reproduces reference eval.py:311-312, where every joint column is the
    all-joint mean; otherwise the columns are per-joint PCKs and the last
    is their mean."""
    dist = joint_distances_mm(pred_joints, gt_joints)  # [B, J]
    B, J = dist.shape
    w = (torch.ones(B, dtype=dist.dtype, device=dist.device)
         if valid is None else valid.to(dist.dtype))
    denom = w.sum().clamp(min=1.0)
    thresholds = torch.as_tensor(rnge, dtype=dist.dtype, device=dist.device)
    hits = (dist[None] <= thresholds[:, None, None]).to(dist.dtype)
    hits = hits * w[None, :, None]
    if flat_compat:
        overall = 100.0 * hits.sum(dim=(1, 2)) / (denom * J)  # [T]
        return overall[:, None].expand(len(rnge), J + 1)
    per_joint = 100.0 * hits.sum(dim=1) / denom  # [T, J]
    return torch.cat([per_joint, per_joint.mean(dim=1, keepdim=True)], 1)


def area_under_curve(xpts, ypts) -> torch.Tensor:
    """Normalized trapezoidal AUC (reference eval.py:328-348); ``xpts``
    unique and sorted."""
    xpts = torch.as_tensor(xpts, dtype=torch.float32)
    ypts = torch.as_tensor(ypts, dtype=torch.float32).to(xpts.device)
    norm = torch.trapezoid(torch.ones_like(xpts), xpts)
    return torch.trapezoid(ypts, xpts) / norm


def mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor
          ) -> torch.Tensor:
    """Per-sample mean per-joint position error in meters ``[B]``."""
    d = pred_joints - gt_joints
    return torch.sqrt((d * d).sum(dim=-1)).mean(dim=-1)


def pck_auc(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
            rnge: Sequence[float] = DEFAULT_PCK_RANGE_MM,
            flat_compat: bool = True,
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(PCK matrix, AUC of its mean-PCK column)."""
    pck = cal_pck(pred_joints, gt_joints, rnge, flat_compat, valid)
    r = torch.as_tensor(rnge, dtype=torch.float32, device=pck.device)
    return pck, area_under_curve(r / r.max(), pck[:, -1])


def compute_accel(joints: torch.Tensor) -> torch.Tensor:
    """Mean joint acceleration magnitude per frame, ``[N,J,3] -> [N-2]``
    (reference data_utils/eval_utils.py:6-17)."""
    velocities = joints[1:] - joints[:-1]
    accel = velocities[1:] - velocities[:-1]
    return torch.linalg.norm(accel, dim=2).mean(dim=1)


def compute_error_accel(joints_gt: torch.Tensor, joints_pred: torch.Tensor,
                        vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Acceleration error against the ground truth, ``[N-2]`` (reference
    data_utils/eval_utils.py:20-48); where the reference drops the
    windows with an invisible frame, they are zero here (the masked mean
    is ``accel_error_mean``)."""
    accel_gt = joints_gt[:-2] - 2 * joints_gt[1:-1] + joints_gt[2:]
    accel_pred = joints_pred[:-2] - 2 * joints_pred[1:-1] + joints_pred[2:]
    normed = torch.linalg.norm(accel_pred - accel_gt, dim=2).mean(dim=1)
    if vis is not None:
        normed = normed * _accel_vis_mask(vis)
    return normed


def _accel_vis_mask(vis: torch.Tensor) -> torch.Tensor:
    """A window counts only if frames i, i+1 and i+2 are all visible
    (reference eval_utils.py:42-46)."""
    invis = ~vis.bool()
    return (~(invis[:-2] | invis[1:-1] | invis[2:])).float()


def accel_error_mean(joints_gt: torch.Tensor, joints_pred: torch.Tensor,
                     vis: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean acceleration error over the visible windows."""
    errs = compute_error_accel(joints_gt, joints_pred)
    if vis is None:
        return errs.mean()
    mask = _accel_vis_mask(vis)
    return (errs * mask).sum() / mask.sum().clamp(min=1.0)


def valid_sample_mask(images: torch.Tensor, threshold: float = 2000.0
                      ) -> torch.Tensor:
    """Float ``[B]`` mask of the crops that are not blank: the static
    replacement of the reference's empty-crop filter (train.py:143-150),
    which drops items whose pixel sum ([-1,1] pixels) is within
    ``threshold`` of +-(H*W*3).  Any image layout: the sum is over every
    axis but the first."""
    content = images.float().sum(dim=tuple(range(1, images.dim()))).abs()
    full = float(images[0].numel())
    return ((content - full).abs() > threshold).float()


def get_dist_pck(pred: torch.Tensor, gt: torch.Tensor,
                 norm_lm_ids=(4, 5)) -> torch.Tensor:
    """Joint distances normalized by the gt distance between two
    landmarks, laid out ``[1, J, B]`` like the reference
    (eval.py:274-298 ``_getDistPCK``)."""
    ref = torch.linalg.norm(gt[:, norm_lm_ids[0]] - gt[:, norm_lm_ids[1]],
                            dim=-1)
    dist = torch.sqrt(((pred - gt) ** 2).sum(dim=-1))  # [B, J]
    return (dist / ref[:, None]).T[None]
