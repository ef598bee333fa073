"""Model factory keyed by the ``--net`` flag (port of
``scat_tpu/models/factory.py:29-121``).  The flagship ``reg_transformer``
and ``ViP`` are ported; every other net raises and names the ROADMAP.md
queue 1 item that ports it."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.models.performer import ViP
from scat_tpu_torch.ops.favor import PRECISIONS

_NOT_PORTED = {
    "reg_transformer_coarse": 9,
    "backbone_hrnet": 10,
    "backbone_incepv3": 10,
    "frankmocap": 11,
    "ViT": 12,
}


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
    if opt.net not in ("reg_transformer", "ViP"):
        raise ValueError(f"unknown --net {opt.net!r}")
    mean = assets.load_mean_params(outside=opt.outside)
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
