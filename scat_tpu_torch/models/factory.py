"""Model factory keyed by the ``--net`` flag (port of
``scat_tpu/models/factory.py:29-121``): the flagship ``reg_transformer``,
``reg_transformer_coarse``, the 128-token heads ``backbone_hrnet`` and
``backbone_incepv3``, ``frankmocap`` (``H3DWEncoder``; with
``for_keypoints=True`` ``H3DWJointsEncoder``, its MANO decode in the
forward), ``ViT`` (the default ``--net``) and ``ViP``.

``ViT`` reads ``--vit_dim``, ``--vit_depth``, ``--vit_heads``,
``--vit_dropout`` and ``--iteration``; ``--vit_mlp_dim`` is ignored, as
the JAX package's pyramid ignores its ``mlp_dim`` (the FFN hidden width
is ``(dim*3)//4``).  Like the JAX package's, it takes the plain
attention: no flag routes it to the kernels.

``--use_pallas_attention`` routes the attention of the flagship and of
the 128-token heads through the hand-written kernels (N = 21 and
N = 128), and ``--pl_reg`` takes the flagship back to the plain path.
The JAX package builds the 128-token heads on its plain path
(``factory.py:69-81``); the port's kernels are its path on the card.

A 61-dim head is served through its MANO decode (``keypoint_decode``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.models.hand_net import (
    MANO_PARAMS, EncoderTransformer, EncoderTransformerCoarse,
    EncoderTransformerHRNet, EncoderTransformerInception, H3DWEncoder,
    H3DWJointsEncoder)
from scat_tpu_torch.models.mano import ManoDecode
from scat_tpu_torch.models.performer import ViP
from scat_tpu_torch.models.vit import ViT
from scat_tpu_torch.ops.favor import PRECISIONS

NETS = ("reg_transformer", "reg_transformer_coarse", "backbone_hrnet",
        "backbone_incepv3", "frankmocap", "ViT", "ViP")
# the nets whose output is 61 MANO parameters, not the 66-dim camera +
# 21x3 joints that the keypoint losses, metrics and predictor read
MANO_PARAM_NETS = ("backbone_hrnet", "backbone_incepv3", "frankmocap")
KEYPOINT_DIM = 66


def check_keypoint_head(model: nn.Module, who: str) -> None:
    """Raise where ``model`` does not give the 66-dim camera + joints
    contract that ``who`` reads."""
    out_dim = getattr(model, "out_dim", KEYPOINT_DIM)
    if out_dim != KEYPOINT_DIM:
        raise ValueError(
            f"{who} reads the {KEYPOINT_DIM}-dim camera + 21x3 joints "
            f"contract; {type(model).__name__} predicts {out_dim} MANO "
            "parameters")


def keypoint_decode(model: nn.Module) -> Optional[nn.Module]:
    """What a served forward of ``model`` runs on its output: nothing
    (None) for a head of the 66-dim camera + 21x3 joints contract; for a
    head of the 61 MANO parameters (the bare heads of
    ``MANO_PARAM_NETS``), their decode to that contract,
    ``mano.ManoDecode``, on the model's device.  Another width raises."""
    out_dim = getattr(model, "out_dim", KEYPOINT_DIM)
    if out_dim == KEYPOINT_DIM:
        return None
    if out_dim != MANO_PARAMS:
        raise ValueError(f"{type(model).__name__} predicts {out_dim} "
                         f"numbers: neither the {KEYPOINT_DIM}-dim camera + "
                         f"joints nor {MANO_PARAMS} MANO parameters")
    return ManoDecode().to(next(model.parameters()).device)


def compute_dtype(opt: Options) -> torch.dtype:
    dtype = getattr(torch, opt.compute_dtype, None)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"--compute_dtype {opt.compute_dtype!r}: the port "
                         "computes in float32 or bfloat16")
    return dtype


def build_model(opt: Options, image_size: int = 224,
                for_keypoints: bool = False
                ) -> Tuple[nn.Module, np.ndarray]:
    """``(float32 module with fresh parameters, mean_params ndarray)``
    for ``opt.net``.  ``for_keypoints=True`` gives the MANO-parameter head
    ``frankmocap`` its MANO decode, so that it meets the 66-dim camera +
    joints contract of the keypoint eval step (the JAX package's
    Evaluator builds it so; the reference decodes outside the model,
    test.py:332-348)."""
    if opt.net not in NETS:
        raise ValueError(f"unknown --net {opt.net!r}")
    # --pl_reg differentiates twice through the attention stack (the loss
    # takes the gradient of the path-length probe); the kernel's backward
    # is once_differentiable, so pl_reg takes the plain attention path,
    # as the JAX package's factory.py:46-60 does
    use_kernel = opt.use_pallas_attention and not opt.pl_reg
    if opt.net == "frankmocap":
        mean = assets.load_mean_mano_pose(opt.mean_mano_param)
        cls = H3DWJointsEncoder if for_keypoints else H3DWEncoder
        return cls(mean_params=torch.from_numpy(mean)), mean
    if opt.net in ("backbone_hrnet", "backbone_incepv3"):
        mean = assets.load_mean_mano_pose(opt.mean_mano_param)
        cls = (EncoderTransformerHRNet if opt.net == "backbone_hrnet"
               else EncoderTransformerInception)
        model = cls(mean_params=torch.from_numpy(mean),
                    iteration=opt.iteration, heads=opt.vit_heads,
                    depth=opt.vit_depth, mask_rate=opt.mask_rate,
                    pos_embed=opt.pos_embed, image_size=image_size,
                    use_kernel=use_kernel)
        return model, mean
    mean = assets.load_mean_params(outside=opt.outside)
    if opt.net == "ViT":
        model = ViT(mean_params=torch.from_numpy(mean),
                    image_size=image_size, dim=opt.vit_dim,
                    depth=opt.vit_depth, heads=opt.vit_heads,
                    dropout=opt.vit_dropout, iteration=opt.iteration)
        return model, mean
    if opt.net == "reg_transformer_coarse":
        model = EncoderTransformerCoarse(
            mean_params=torch.from_numpy(mean), heads=opt.vit_heads,
            depth=opt.vit_depth, mask_rate=opt.mask_rate,
            pos_embed=opt.pos_embed, pl_reg=opt.pl_reg,
            token_dim=(image_size // 8) ** 2)
        return model, mean
    if opt.net == "ViP":
        if opt.favor_precision not in PRECISIONS:
            raise ValueError(
                f"--favor_precision {opt.favor_precision!r} is not one of "
                f"{'/'.join(PRECISIONS)} (ops/favor.py favor_precisions)")
        model = ViP(mean_params=torch.from_numpy(mean),
                    image_pix=image_size, iteration=opt.iteration,
                    use_kernel=opt.use_pallas_favor,
                    remat=opt.remat_blocks,
                    favor_precision=opt.favor_precision)
        return model, mean
    if opt.use_pallas_attention and opt.pl_reg:
        print("--pl_reg needs double-backward: using the plain attention "
              "path (the kernel's backward is once_differentiable)")
    model = EncoderTransformer(
        mean_params=torch.from_numpy(mean), iteration=opt.iteration,
        heads=opt.vit_heads, depth=opt.vit_depth, mask_rate=opt.mask_rate,
        pos_embed=opt.pos_embed, pl_reg=opt.pl_reg,
        token_dim=(image_size // 8) ** 2, norm_layer=opt.norm_layer,
        use_kernel=use_kernel)
    return model, mean
