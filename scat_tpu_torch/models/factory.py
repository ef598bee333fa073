"""Model factory keyed by the ``--net`` flag (port of
``scat_tpu/models/factory.py:29-121``).  Ported: the flagship
``reg_transformer``, ``reg_transformer_coarse``, the 128-token heads
``backbone_hrnet`` and ``backbone_incepv3``, and ``ViP``; every other net
raises and names the ROADMAP.md queue 1 item that ports it.

The 128-token heads take the plain attention path, as the JAX package
builds them (``factory.py:69-81``): ``--use_pallas_attention`` is the
flagship's flag and never routes them.  Their kernel path is
``use_kernel=True`` on the constructor, the counterpart of the JAX
package's ``clone(use_pallas=True)``."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.models.hand_net import (
    EncoderTransformer, EncoderTransformerCoarse, EncoderTransformerHRNet,
    EncoderTransformerInception)
from scat_tpu_torch.models.performer import ViP
from scat_tpu_torch.ops.favor import PRECISIONS

_NOT_PORTED = {
    "frankmocap": 11,
    "ViT": 12,
}
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


def compute_dtype(opt: Options) -> torch.dtype:
    dtype = getattr(torch, opt.compute_dtype, None)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"--compute_dtype {opt.compute_dtype!r}: the port "
                         "computes in float32 or bfloat16")
    return dtype


def build_model(opt: Options, image_size: int = 224
                ) -> Tuple[nn.Module, np.ndarray]:
    """``(float32 module with fresh parameters, mean_params ndarray)``
    for ``opt.net``."""
    if opt.net in _NOT_PORTED:
        raise NotImplementedError(
            f"--net {opt.net} is not ported to scat_tpu_torch yet "
            f"(ROADMAP.md queue 1 item {_NOT_PORTED[opt.net]})")
    if opt.net not in ("reg_transformer", "reg_transformer_coarse",
                       "backbone_hrnet", "backbone_incepv3", "ViP"):
        raise ValueError(f"unknown --net {opt.net!r}")
    if opt.net in ("backbone_hrnet", "backbone_incepv3"):
        mean = assets.load_mean_mano_pose(opt.mean_mano_param)
        cls = (EncoderTransformerHRNet if opt.net == "backbone_hrnet"
               else EncoderTransformerInception)
        model = cls(mean_params=torch.from_numpy(mean),
                    iteration=opt.iteration, heads=opt.vit_heads,
                    depth=opt.vit_depth, mask_rate=opt.mask_rate,
                    pos_embed=opt.pos_embed, image_size=image_size)
        return model, mean
    mean = assets.load_mean_params(outside=opt.outside)
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
    # --pl_reg differentiates twice through the attention stack (the loss
    # takes the gradient of the path-length probe); the kernel's backward
    # is once_differentiable, so pl_reg takes the plain attention path,
    # as the JAX package's factory.py:46-60 does
    use_kernel = opt.use_pallas_attention and not opt.pl_reg
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
