"""The flagship head, ``--net reg_transformer`` (port of the eval path of
``scat_tpu/models/hand_net.py:40-144``; reference hand_net.py:315-398).

  resnet 5-tuple -> 1x1 conv on x2 (512 -> 21 channels on resnet50) ->
  21 tokens, token i = channel i's map flattened row-major -> sinusoidal
  PE -> pyramid transformer -> [B,63] offsets -> mean + offsets ->
  ``iteration`` refinements ``pred += Linear(1024+66 -> 66)(cat(feat,
  pred))`` -> root-centring on joint index 1.

Images and feature maps are NCHW, as in the reference torch model whose
key layout the module keeps; ``forward`` returns ``(pred [B,66],
feat_visual [B,21,H/8,W/8])``.

Compute dtype: ``cast_compute(dtype)`` puts the backbone, the 1x1 conv
and the transformer in ``dtype`` (bf16 for serving); the regressor stays
float32 and its input is cast to float32, as in the JAX package, whose
``Dense(66)`` has no compute dtype.

The training-only parts, token masking and the path-length probe
(``pl_reg``), raise: they arrive with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from scat_tpu_torch.models import resnet as resnet_lib
from scat_tpu_torch.models.transformer import (
    PyramidTransformer, sinusoidal_position_encoding)

NUM_TOKENS = 21  # one token per joint
_TRAINING_SLICE = ("arrives with the training slice of the port "
                   "(ROADMAP.md queue 1 item 5)")


class EncoderTransformer(nn.Module):
    """Primary SCAT head, ``--net reg_transformer``."""

    def __init__(self, mean_params: torch.Tensor, iteration: int = 3,
                 heads: int = 8, depth: int = 3, mask_rate: float = 0.0,
                 pos_embed: bool = True, pl_reg: bool = False,
                 token_dim: int = 784,
                 backbone: str = "resnet50", norm_layer: str = "batch",
                 use_kernel: bool = False):
        super().__init__()
        if pl_reg:
            raise NotImplementedError(f"pl_reg {_TRAINING_SLICE}")
        self.iteration = iteration
        self.mask_rate = mask_rate
        self.pos_embed = pos_embed
        self.main_encoder = resnet_lib.get_model(backbone,
                                                 norm_layer=norm_layer)
        x2_channels = 128 * self.main_encoder.block.expansion
        self.conv1x1_channel_reduction = nn.Conv2d(
            x2_channels, NUM_TOKENS, 1, bias=False)
        self.transformer = PyramidTransformer(
            dim=token_dim, depth=depth, heads=heads, dim_head=64,
            use_kernel=use_kernel)
        feat_dim = self.main_encoder.fc1.out_features
        self.regressor = nn.Linear(feat_dim + 66, 66)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, token_dim))
        # deterministic tables, not part of the checkpoint
        self.register_buffer(
            "mean_params", torch.as_tensor(mean_params,
                                           dtype=torch.float32).reshape(66),
            persistent=False)
        self.register_buffer(
            "pe", sinusoidal_position_encoding(NUM_TOKENS, token_dim),
            persistent=False)

    def cast_compute(self, dtype: torch.dtype) -> "EncoderTransformer":
        """Backbone, 1x1 conv and transformer compute in ``dtype``; the
        regressor stays float32."""
        for m in (self.main_encoder, self.conv1x1_channel_reduction,
                  self.transformer):
            m.to(dtype)
        return self

    def _head(self, feat_visual: torch.Tensor) -> torch.Tensor:
        """21-channel map -> transformer offsets [B,63] float32."""
        feat = feat_visual.flatten(2)  # [B,21,H*W], token i = channel i
        if self.pos_embed:
            feat = feat + self.pe.to(feat.dtype)
        if self.training and 0.1 <= self.mask_rate <= 0.9:
            raise NotImplementedError(f"token masking {_TRAINING_SLICE}")
        out = self.transformer(feat)
        return out.reshape(out.shape[0], -1).float()

    def forward(self, x: torch.Tensor):
        dtype = self.conv1x1_channel_reduction.weight.dtype
        main_feat, _, x2, _, _ = self.main_encoder(x.to(dtype))
        feat_visual = self.conv1x1_channel_reduction(x2)
        feat_out = self._head(feat_visual)

        mean = self.mean_params.expand(x.shape[0], 66)
        pred = torch.cat([mean[:, :3], mean[:, 3:] + feat_out], dim=1)
        # HMR iterative refinement (reference hand_net.py:385-387)
        for _ in range(self.iteration):
            pred = pred + self.regressor(torch.cat([main_feat, pred], 1))
        pred_3d = pred[:, 3:].reshape(-1, NUM_TOKENS, 3)
        pred_3d = pred_3d - pred_3d[:, 1:2]  # root-centre (ref :389-393)
        pred = torch.cat([pred[:, :3], pred_3d.reshape(-1, 63)], dim=1)
        return pred, feat_visual
