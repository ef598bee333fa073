"""Train and eval steps (port of ``scat_tpu/training/steps.py:27-224``).

Reference hot loop (train.py:136-209): empty-sample filter -> forward ->
weak-perspective projection -> 3D MSE + 2D L1 (+ PL reg) -> backward ->
Adam step.  As in the JAX package the filter is a per-sample ``valid``
mask.  Batches are dicts of device tensors: ``image`` NHWC [B,S,S,3] in
[-1,1] (seen by the model as an NCHW channels_last view), ``label``
[B,105] or [B,166], optional ``valid`` [B].
``make_fused_preprocess_train_step`` takes raw uint8 frames and their
crop affines and warps them inside the step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from scat_tpu_torch.models import losses as losses_lib
from scat_tpu_torch.ops import metrics as metrics_lib
from scat_tpu_torch.ops import procrustes
from scat_tpu_torch.ops.geometry import batch_orth_proj_idrot, project_2d
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


def predictions_to_keypoints(pred_params: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Split [B,66] -> (cam [B,3], joints3d [B,21,3], joints2d_px
    [B,21,2]) (reference train.py:164-174)."""
    cam = pred_params[:, :3]
    j3d = pred_params[:, 3:66].reshape(-1, 21, 3)
    return cam, j3d, project_2d(batch_orth_proj_idrot(j3d, cam))


def prediction(outputs) -> torch.Tensor:
    """The prediction of a model's outputs: the first of a tuple (the
    output contract is ``(pred, fmap[, attn][, pl_grad])``, the coarse
    head inserting ``attn``), or a bare tensor whole (the 128-token
    heads), as ``scat_tpu/serving.py:209`` reads it."""
    return outputs[0] if isinstance(outputs, tuple) else outputs


def train_inputs(model: nn.Module, batch_size: int,
                 generator: torch.Generator) -> dict:
    """The random inputs of one training forward of ``model``, drawn from
    ``generator`` (the flagship's token mask, ViP's dropout masks), as
    keyword arguments of its forward; none for a model without
    ``train_inputs``."""
    draw = getattr(model, "train_inputs", None)
    return {} if draw is None else draw(batch_size, generator)


def forward_loss(model: nn.Module, images: torch.Tensor,
                 labels: torch.Tensor, valid: Optional[torch.Tensor],
                 l_weight_3d: float, l_weight_2d: float,
                 pl_reg: bool = False,
                 pl_mean: Optional[torch.Tensor] = None,
                 ema_reset_compat: bool = True, group=None,
                 **model_inputs):
    """The model in its current mode on NHWC ``images`` (with
    ``model_inputs``, e.g. ``token_mask=`` or ``dropout_masks=``), and
    the SCAT loss: ``(breakdown, new_pl_mean, joints3d, joints2d_px)``;
    over ``group`` (a mesh's ``data`` axis) the terms are this rank's
    shares of the global batch's."""
    outputs = model(images.permute(0, 3, 1, 2), **model_inputs)
    _, j3d, j2d = predictions_to_keypoints(prediction(outputs))
    breakdown, new_pl = losses_lib.scat_loss(
        j3d.reshape(-1, 63), j2d.reshape(-1, 42), labels, l_weight_3d,
        l_weight_2d, valid=valid, pl_grad=outputs[-1] if pl_reg else None,
        pl_mean_state=pl_mean, ema_reset_compat=ema_reset_compat,
        group=group)
    return breakdown, new_pl, j3d, j2d


def shard_inputs(inputs, index: int, count: int):
    """This rank's rows (``index`` of ``count``) of the random inputs drawn
    for a global microbatch: every tensor with a batch axis (2-d and
    up; the flagship's token mask is one for the whole batch)."""
    if count == 1:
        return inputs
    if isinstance(inputs, dict):
        return {k: shard_inputs(v, index, count) for k, v in inputs.items()}
    if isinstance(inputs, (list, tuple)):
        return type(inputs)(shard_inputs(v, index, count) for v in inputs)
    if inputs.dim() < 2:
        return inputs
    m = inputs.shape[0] // count
    return inputs[index * m:(index + 1) * m]


def _no_sync(forward: nn.Module, last: bool):
    """Skip the gradient reduction of a micro-step but the last: DDP's
    ``no_sync``; FSDP2's ``set_requires_gradient_sync``."""
    if hasattr(forward, "no_sync"):
        return contextlib.nullcontext() if last else forward.no_sync()
    if hasattr(forward, "set_requires_gradient_sync"):
        forward.set_requires_gradient_sync(last)
    return contextlib.nullcontext()


def make_train_step(l_weight_3d: float, l_weight_2d: float,
                    pl_reg: bool = False, ema_reset_compat: bool = True,
                    grad_accum: int = 1, mesh=None
                    ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """The train step for a state whose model has the ``(pred,
    feat_visual[, attn][, pl_grad])`` output contract: one forward and backward
    (or ``grad_accum`` of them over sequential microbatches) and one
    optimizer and schedule step, in place; returns the step's stats as
    device tensors (nothing waits for the device).

    Under ``grad_accum > 1`` each microbatch's keypoint loss is weighted
    by its share of the batch's valid samples, so that part of the
    summed gradient equals the full-batch gradient; the PL term is
    weighted 1/A, and BN statistics, the PL EMA and the token masks
    thread through the microbatches in turn, as in the JAX package.

    Under a ``mesh`` (``parallel/mesh.py``) the batch is this rank's rows
    (``mesh.shard_batch``), the forward runs through ``state.forward``
    (DDP or FSDP), the random inputs are drawn for the global
    microbatch and sliced, each term is this rank's share of the global
    batch's (multiplied by ``mesh.loss_scale()`` for the backward), a
    micro-step but the last skips the gradient reduction, and the stats
    are the global batch's."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = None if mesh is None else mesh.data_group
    d = 1 if mesh is None else mesh.size("data")
    rank = 0 if mesh is None else mesh.coord("data")
    scale = 1.0 if mesh is None else mesh.loss_scale()

    def global_sum(x: torch.Tensor) -> torch.Tensor:
        if group is None:
            return x
        x = x.detach().clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    def train_step(state: TrainState, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        model = state.model
        forward = state.forward
        model.train()
        images, labels = batch["image"], batch["label"]
        valid = batch.get("valid")
        if valid is None:
            valid = metrics_lib.valid_sample_mask(images)
        n = images.shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} is not divisible by "
                             f"--grad_accum {grad_accum}")
        m = n // grad_accum
        sv_total = global_sum(valid.sum()).clamp(min=1.0)
        state.optimizer.zero_grad(set_to_none=True)
        sums = torch.zeros(4, device=labels.device)
        pl_mean = state.pl_mean
        pred0 = None
        for i in range(grad_accum):
            sl = slice(i * m, (i + 1) * m)
            inputs = shard_inputs(train_inputs(model, m * d, state.generator),
                                  rank, d)
            with _no_sync(forward, i == grad_accum - 1):
                with span("scat.train.forward"):
                    bd, pl_mean, j3d, j2d = forward_loss(
                        forward, images[sl], labels[sl], valid[sl],
                        l_weight_3d, l_weight_2d, pl_reg, pl_mean,
                        ema_reset_compat, group, **inputs)
                if grad_accum == 1:
                    total, parts = bd.total, (bd.total, bd.l_3d, bd.l_2d,
                                              bd.l_pl)
                else:
                    w = global_sum(valid[sl].sum()) / sv_total
                    w_pl = 1.0 / grad_accum
                    pl_part = losses_lib.PL_WEIGHT * bd.l_pl
                    total = w * (bd.total - pl_part) + w_pl * pl_part
                    parts = (total, w * bd.l_3d, w * bd.l_2d,
                             w_pl * bd.l_pl)
                with span("scat.train.backward"):
                    (total * scale if mesh is not None
                     else total).backward()
            sums += torch.stack(parts).detach()
            pl_mean = pl_mean.detach()
            if pred0 is None:
                pred0 = (j3d[0].detach(), j2d[0].detach())
        if state.reduce_gradients is not None:
            state.reduce_gradients()
        sums = global_sum(sums)
        with span("scat.train.optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        state.pl_mean = pl_mean
        return {"loss": sums[0],
                "loss_3d": l_weight_3d * sums[1],
                "loss_2d": l_weight_2d * sums[2],
                "loss_pl": losses_lib.PL_WEIGHT * sums[3],
                "valid_frac": valid.float().mean(),
                "pred0_3d": pred0[0],
                "pred0_2d": pred0[1]}

    return train_step


def make_fused_preprocess_train_step(
        l_weight_3d: float, l_weight_2d: float, out_size: int = 224,
        pl_reg: bool = False, ema_reset_compat: bool = True
        ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """The train step with the image preprocessing inside it (port of
    ``scat_tpu/training/steps.py:227-258``).  Batch contract:
    ``raw_image`` uint8 [B,H,W,3] frames, ``affine`` [B,2,3] (input px ->
    crop px, from ``preprocess.crop_hand_affine`` and friends),
    ``label`` and an optional ``valid``; the warp and the normalisation
    run on the frames' device, then the step of ``make_train_step``."""
    from scat_tpu_torch.data import preprocess

    inner = make_train_step(l_weight_3d, l_weight_2d, pl_reg=pl_reg,
                            ema_reset_compat=ema_reset_compat)

    def train_step(state: TrainState, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        raw = batch["raw_image"]
        images = preprocess.affine_sample(
            preprocess.normalize_to_unit(raw), batch["affine"], out_size,
            out_size, fill=-1.0)
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(raw.shape[0], device=raw.device)
        return inner(state, {"image": images, "label": batch["label"],
                             "valid": valid})

    return train_step


def keypoint_metrics(aligned: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor,
                     pck_range: Sequence[float] =
                     metrics_lib.DEFAULT_PCK_RANGE_MM,
                     flat_compat: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(PCK over ``pck_range``, per-sample MPJPE) of Procrustes-aligned
    joints [B,21,3] against the labels' 3D joints (the evaluator runs it
    on the gathered global batch under a mesh)."""
    gt3d = losses_lib.split_labels(labels).joints_3d.reshape(-1, 21, 3)
    pck = metrics_lib.cal_pck(aligned, gt3d, pck_range,
                              flat_compat=flat_compat, valid=valid)
    return pck, metrics_lib.mpjpe(aligned, gt3d)


def make_eval_step(model: nn.Module,
                   pck_range: Sequence[float] =
                   metrics_lib.DEFAULT_PCK_RANGE_MM,
                   flat_compat: bool = True, return_attn: bool = False
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Eval step: forward in eval mode -> projection -> PA-Procrustes ->
    PCK and MPJPE (reference eval.py:810-1027 minus visualization).  The
    model's train/eval mode is restored afterwards.  ``return_attn``
    (the coarse head under ``--debug``) also returns ``attn``, the last
    layer's attention from the same forward: the reference runs a second
    forward for it (eval.py:834)."""

    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        images, labels = batch["image"], batch["label"]
        valid = batch.get("valid")
        if valid is None:
            valid = metrics_lib.valid_sample_mask(images)
        was_training = model.training
        model.eval()
        with torch.no_grad():
            outputs = model(images.permute(0, 3, 1, 2))
            _, j3d, j2d = predictions_to_keypoints(prediction(outputs))
            gt3d = losses_lib.split_labels(labels).joints_3d.reshape(-1, 21,
                                                                     3)
            aligned = procrustes.similarity_align(j3d, gt3d)
            pck, err = keypoint_metrics(aligned, labels, valid, pck_range,
                                        flat_compat)
        model.train(was_training)
        out = {"pck": pck, "mpjpe_per_sample": err, "valid": valid,
               "pred_joints_3d": aligned, "pred_joints_2d": j2d}
        if return_attn:
            # the coarse head's contract: (pred, feat_visual, attn[, ...])
            out["attn"] = outputs[2]
        return out

    return eval_step
