"""Training losses (port of ``scat_tpu/models/losses.py``).

Reference train.py:176-203: ``loss = w3d*MSE(pred_j3d, gt_j3d) +
w2d*L1(pred_j2d_px, gt_j2d_px) [+ 10*l_pl]`` with label-width dispatch:
105-wide labels (STB/MTC/RHD) carry 3D = [:63], 2D = [63:]; 166-wide
labels (FreiHAND/HO-3D) carry pose = [3:51], 3D = [61:124], 2D = [124:].
A per-sample ``valid`` mask reweights the means instead of slicing the
batch.

Path-length regularization (reference train.py:178-183): the reference
re-initializes its EMA every step, so the "EMA" collapses to
``0.01 * batch_mean``; reproduced with ``ema_reset_compat=True`` (the
default), otherwise a true EMA threaded through the train state.

``group`` (the ``data`` axis of a mesh, ``parallel/mesh.py``): a rank
holds some rows of the global batch, and every mean is over the global
batch, as GSPMD computes it.  A rank's term is its share of the global
value, its rows' sum over the global count (the valid rows, summed
over the group), so that the shares add up to the global loss: DDP's
plain average of the ranks' local means would not give the global
mean of a masked loss.  The PL term's mean length is summed over the
group with the differentiable all-reduce.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from scat_tpu_torch.ops import widen

# the reference's fixed x10 PL-term weight (train.py:200-201)
PL_WEIGHT = 10.0


class LabelViews(NamedTuple):
    joints_3d: torch.Tensor  # [B, 63]
    joints_2d: torch.Tensor  # [B, 42]
    pose: Optional[torch.Tensor]  # [B, 48] for 166-wide labels


def split_labels(labels: torch.Tensor) -> LabelViews:
    """Label-width dispatch (reference train.py:188-196)."""
    width = labels.shape[1]
    if width == 105:
        return LabelViews(labels[:, :63], labels[:, 63:], None)
    if width == 166:
        return LabelViews(labels[:, 61:124], labels[:, 124:],
                          labels[:, 3:51])
    raise ValueError(f"unsupported label width {width} (expected 105/166)")


def _global_count(count: torch.Tensor, group) -> torch.Tensor:
    """``count`` summed over ``group`` (no gradient), or as it is."""
    if group is None:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return count


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor],
                 group=None) -> torch.Tensor:
    """Mean over all elements, counting only rows where valid == 1; over
    ``group``, this rank's share of the global mean."""
    if valid is None and group is None:
        return x.mean()
    if valid is None:
        valid = torch.ones(x.shape[0], device=x.device)
    per_elem = x.shape[1] if x.dim() > 1 else 1
    w = valid.to(x.dtype)
    count = _global_count(w.sum() * per_elem, group)
    return (x * w[:, None]).sum() / count.clamp(min=1.0)


def keypoint_loss_3d(pred: torch.Tensor, gt: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     group=None) -> torch.Tensor:
    """MSE over flattened [B,63] joints (reference train.py:191)."""
    return _masked_mean((pred - gt) ** 2, valid, group)


def keypoint_loss_2d(pred: torch.Tensor, gt: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     group=None) -> torch.Tensor:
    """L1 over flattened [B,42] pixel joints (reference train.py:192)."""
    return _masked_mean((pred - gt).abs(), valid, group)


def path_length_loss(pl_grad: torch.Tensor, pl_mean_state: torch.Tensor,
                     ema_reset_compat: bool = True, decay: float = 0.01,
                     group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l_pl, new_pl_mean_state) from the PL probe gradient ``pl_grad``,
    NCHW [B,21,H,W]: lengths are the sum over the map, the mean over
    channels, the square root (reference train.py:179).  Over ``group``
    the batch mean of the lengths is the global one (the same EMA on
    every rank) and l_pl is this rank's share."""
    pl_lengths = torch.sqrt(
        (widen(pl_grad) ** 2).sum(dim=(2, 3)).mean(dim=1))
    if group is None:
        batch_mean, count = pl_lengths.mean(), None
    else:
        from scat_tpu_torch.parallel.mesh import all_reduce_sum
        count = _global_count(torch.full((), float(pl_lengths.shape[0]),
                                         device=pl_lengths.device), group)
        batch_mean = all_reduce_sum(pl_lengths.sum(), group) / count
    if ema_reset_compat:
        pl_mean = decay * batch_mean  # ref train.py:180-182
        new_state = pl_mean
    else:
        pl_mean = pl_mean_state + decay * (batch_mean - pl_mean_state)
        new_state = pl_mean.detach()
    sq = (pl_lengths - pl_mean) ** 2
    return (sq.mean() if count is None else sq.sum() / count), new_state


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    l_3d: torch.Tensor
    l_2d: torch.Tensor
    l_pl: torch.Tensor


def scat_loss(pred_joints_3d: torch.Tensor, pred_joints_2d_px: torch.Tensor,
              labels: torch.Tensor, l_weight_3d: float, l_weight_2d: float,
              valid: Optional[torch.Tensor] = None,
              pl_grad: Optional[torch.Tensor] = None,
              pl_mean_state: Optional[torch.Tensor] = None,
              ema_reset_compat: bool = True,
              pl_weight: float = PL_WEIGHT, group=None
              ) -> Tuple[LossBreakdown, torch.Tensor]:
    """Full SCAT training loss (reference train.py:176-203).
    ``pred_joints_3d`` [B,63], ``pred_joints_2d_px`` [B,42] in pixels.
    Returns (breakdown, new_pl_mean_state); over ``group``, each term
    is this rank's share of the global batch's."""
    views = split_labels(labels)
    l_3d = keypoint_loss_3d(pred_joints_3d, views.joints_3d, valid, group)
    l_2d = keypoint_loss_2d(pred_joints_2d_px, views.joints_2d, valid,
                            group)
    zero = torch.zeros((), device=labels.device)
    if pl_mean_state is None:
        pl_mean_state = zero
    if pl_grad is not None:
        l_pl, new_state = path_length_loss(pl_grad, pl_mean_state,
                                           ema_reset_compat, group=group)
    else:
        l_pl, new_state = zero, pl_mean_state
    total = l_weight_3d * l_3d + l_weight_2d * l_2d + pl_weight * l_pl
    return LossBreakdown(total, l_3d, l_2d, l_pl), new_state
