"""VIBE-style temporal and adversarial losses of the video stage (port of
``scat_tpu/models/vibe_loss.py:26-158``; reference models/loss.py:65-356,
``VIBELoss``): the 2D L1 and 3D MSE keypoint terms, the MANO pose and
shape MSE, the temporal smoothness terms, and the LSGAN and Wasserstein
terms against the motion discriminator.  Theta layout: ``[:, :3]``
camera, ``[3:51]`` pose, ``[51:]`` shape (reference
loss.py:169-170,193-194).

Where the reference boolean-indexes the valid samples (loss.py:149-152),
``w_3d`` / ``w_smpl`` weight the means instead, as in the JAX package:
the shapes stay static.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

POSE_SLICE = slice(3, 51)
SHAPE_SLICE = slice(51, None)


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``x`` with rows weighted by ``w`` (None: plain mean)."""
    if w is None:
        return x.mean()
    w = w.reshape(w.shape + (1,) * (x.ndim - w.ndim)).to(x.dtype)
    denom = torch.broadcast_to(w, x.shape).sum().clamp(min=1.0)
    return (x * w).sum() / denom


def keypoint_loss_2d(pred: torch.Tensor, real: torch.Tensor,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 (the frankmocap-style choice, reference loss.py:230)."""
    return _wmean((pred - real).abs(), w)


def keypoint_loss_3d(pred: torch.Tensor, real: torch.Tensor,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE (reference loss.py:233-253)."""
    return _wmean((pred - real) ** 2, w)


def mano_losses(pred_pose, pred_shape, gt_pose, gt_shape,
                w: Optional[torch.Tensor] = None):
    """Pose and shape parameter MSE (reference loss.py:270-273)."""
    return (_wmean((pred_pose - gt_pose) ** 2, w),
            _wmean((pred_shape - gt_shape) ** 2, w))


def batch_smooth_pose_loss(pred_theta: torch.Tensor) -> torch.Tensor:
    """|mean(pose diff)| + 10 |mean(rotation diff)| over the time axis of
    [B, T, 48] (reference loss.py:275-284)."""
    rot_diff = pred_theta[:, 1:, :3] - pred_theta[:, :-1, :3]
    pose_diff = pred_theta[:, 1:, 3:] - pred_theta[:, :-1, 3:]
    return pose_diff.mean().abs() + rot_diff.mean().abs() * 10


def batch_smooth_shape_loss(pred_shape: torch.Tensor) -> torch.Tensor:
    """reference loss.py:287-295."""
    return (pred_shape[:, 1:] - pred_shape[:, :-1]).mean().abs()


def batch_smooth_joints_loss(joints: torch.Tensor) -> torch.Tensor:
    """MSE of consecutive frames' joints [B, T, J, D] (reference
    loss.py:297-314)."""
    return ((joints[:, 1:] - joints[:, :-1]) ** 2).mean()


# LSGAN terms (reference loss.py:316-333)
def encoder_disc_l2_loss(disc_value: torch.Tensor) -> torch.Tensor:
    return ((disc_value - 1.0) ** 2).sum() / disc_value.shape[0]


def adv_disc_l2_loss(real_disc_value: torch.Tensor,
                     fake_disc_value: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    la = ((real_disc_value - 1.0) ** 2).sum() / real_disc_value.shape[0]
    lb = (fake_disc_value ** 2).sum() / fake_disc_value.shape[0]
    return la, lb, la + lb


# Wasserstein terms (reference loss.py:336-356)
def encoder_disc_wasserstein_loss(disc_value: torch.Tensor) -> torch.Tensor:
    return -disc_value.sum() / disc_value.shape[0]


def adv_disc_wasserstein_loss(real_disc_value, fake_disc_value):
    la = -real_disc_value.sum() / real_disc_value.shape[0]
    lb = fake_disc_value.sum() / fake_disc_value.shape[0]
    return la, lb, la + lb


class VIBELossConfig(NamedTuple):
    e_loss_weight: float = 60.0
    e_3d_loss_weight: float = 30.0
    e_pose_loss_weight: float = 1.0
    e_shape_loss_weight: float = 0.001
    d_motion_loss_weight: float = 1.0
    use_smooth: bool = False


def vibe_generator_loss(cfg: VIBELossConfig,
                        pred_theta: torch.Tensor,   # [B, T, 61]
                        pred_j2d: torch.Tensor,     # [B, T, 21, 2]
                        pred_j3d: torch.Tensor,     # [B, T, 21, 3]
                        real_2d: torch.Tensor, real_3d: torch.Tensor,
                        gt_theta: torch.Tensor,
                        w_3d: Optional[torch.Tensor] = None,
                        w_smpl: Optional[torch.Tensor] = None,
                        disc_fake_value: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator's total and its parts (reference loss.py:90-218 less
    the data plumbing; the sequences are [B, T, ...], flattened here)."""
    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    parts: Dict[str, torch.Tensor] = {}
    if cfg.use_smooth:
        parts["smooth_pose_loss"] = (
            batch_smooth_pose_loss(pred_theta[:, :, POSE_SLICE])
            * cfg.e_pose_loss_weight * 10)
        parts["smooth_shape_loss"] = (
            batch_smooth_shape_loss(pred_theta[:, :, SHAPE_SLICE])
            * cfg.e_shape_loss_weight * 100)
    flat_theta = flat(pred_theta)
    parts["loss_kp_2d"] = keypoint_loss_2d(
        flat(pred_j2d), flat(real_2d)) * cfg.e_loss_weight
    parts["loss_kp_3d"] = keypoint_loss_3d(
        flat(pred_j3d), flat(real_3d),
        None if w_3d is None else w_3d.reshape(-1)) * cfg.e_3d_loss_weight
    gt_flat = flat(gt_theta)
    w = None if w_smpl is None else w_smpl.reshape(-1)
    # the shape target is zero (reference loss.py:171)
    loss_pose, loss_shape = mano_losses(
        flat_theta[:, POSE_SLICE], flat_theta[:, SHAPE_SLICE],
        gt_flat[:, POSE_SLICE], torch.zeros_like(flat_theta[:, SHAPE_SLICE]),
        w)
    parts["loss_pose"] = loss_pose * cfg.e_pose_loss_weight
    parts["loss_shape"] = loss_shape * cfg.e_shape_loss_weight
    gen_loss = sum(parts.values())
    if disc_fake_value is not None:
        e_disc = encoder_disc_l2_loss(disc_fake_value) * \
            cfg.d_motion_loss_weight
        parts["e_m_disc_loss"] = e_disc
        gen_loss = gen_loss + e_disc
    return gen_loss, parts


def vibe_discriminator_loss(cfg: VIBELossConfig,
                            real_disc_value: torch.Tensor,
                            fake_disc_value: torch.Tensor):
    """The discriminator's LSGAN terms (real, fake, total), weighted
    (reference loss.py:200-216)."""
    la, lb, total = adv_disc_l2_loss(real_disc_value, fake_disc_value)
    return (la * cfg.d_motion_loss_weight, lb * cfg.d_motion_loss_weight,
            total * cfg.d_motion_loss_weight)
