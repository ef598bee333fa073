"""The flagship head, ``--net reg_transformer`` (port of
``scat_tpu/models/hand_net.py:40-144``; reference hand_net.py:315-398).

  resnet 5-tuple -> 1x1 conv on x2 (512 -> 21 channels on resnet50) ->
  21 tokens, token i = channel i's map flattened row-major -> sinusoidal
  PE -> in training, random token masking with the learned mask token ->
  pyramid transformer -> [B,63] offsets -> mean + offsets -> ``iteration``
  refinements ``pred += Linear(1024+66 -> 66)(cat(feat, pred))`` ->
  root-centring on joint index 1.  With ``pl_reg`` the forward also
  returns the path-length probe d(sum feat_out)/d(feat_visual).

Images and feature maps are NCHW, as in the reference torch model whose
key layout the module keeps; ``forward`` returns ``(pred [B,66],
feat_visual [B,21,H/8,W/8])``, plus ``pl_grad`` (the shape of
feat_visual) when ``pl_reg``.

Compute dtype, and where bf16 rounding happens.  The JAX package keeps
every parameter in float32 and computes the backbone, the 1x1 conv and
the transformer's Dense layers in bf16; BatchNorm (or GroupNorm) and
LayerNorm compute in float32 from float32 parameters and statistics (the
BN or GN output is rounded to bf16, the LN output is rounded by the
Dense it feeds); the regressor is float32.  The port places the
rounding at the same points in two ways:
  * ``set_compute_dtype(dtype)`` (training): parameters stay float32 and
    the backbone, conv and transformer run under ``torch.autocast``, which
    rounds the inputs and weights of every convolution and Linear to
    ``dtype``; BatchNorm takes the bf16 activation with its float32
    parameters and statistics, GroupNorm and LayerNorm run in float32;
  * ``cast_compute(dtype)`` (serving): the weights of the backbone, conv
    and transformer are stored in ``dtype`` once, the BatchNorm,
    GroupNorm and LayerNorm modules stay float32.
Either way the transformer output and the backbone feature are cast to
float32 before the regressor, which runs outside autocast.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from scat_tpu_torch.models import resnet as resnet_lib
from scat_tpu_torch.models.transformer import (
    PyramidTransformer, random_token_mask, sinusoidal_position_encoding)

NUM_TOKENS = 21  # one token per joint
_NORM_LAYERS = (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)


class EncoderTransformer(nn.Module):
    """Primary SCAT head, ``--net reg_transformer``."""

    def __init__(self, mean_params: torch.Tensor, iteration: int = 3,
                 heads: int = 8, depth: int = 3, mask_rate: float = 0.0,
                 pos_embed: bool = True, pl_reg: bool = False,
                 token_dim: int = 784,
                 backbone: str = "resnet50", norm_layer: str = "batch",
                 use_kernel: bool = False):
        super().__init__()
        self.iteration = iteration
        self.mask_rate = mask_rate
        self.pos_embed = pos_embed
        self.pl_reg = pl_reg
        self.compute_dtype = torch.float32
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

    def set_compute_dtype(self, dtype: torch.dtype) -> "EncoderTransformer":
        """Compute the backbone, 1x1 conv and transformer in ``dtype``
        under autocast; the parameters stay float32 (training)."""
        self.compute_dtype = dtype
        return self

    def cast_compute(self, dtype: torch.dtype) -> "EncoderTransformer":
        """Store the weights of the backbone, 1x1 conv and transformer in
        ``dtype`` (serving); the norm layers' parameters and statistics,
        and the regressor, stay float32."""
        for m in (self.main_encoder, self.conv1x1_channel_reduction,
                  self.transformer):
            m.to(dtype)
            for norm in m.modules():
                if isinstance(norm, _NORM_LAYERS):
                    norm.float()
        self.compute_dtype = dtype
        return self

    def _autocast(self, device_type: str):
        # autocast only where the weights are float32 and the compute
        # dtype is lower; cast_compute stores the weights in it instead
        on = (self.compute_dtype != torch.float32 and
              self.conv1x1_channel_reduction.weight.dtype == torch.float32)
        return torch.autocast(device_type, dtype=self.compute_dtype,
                              enabled=on)

    def train_inputs(self, batch_size: int,
                     generator: Optional[torch.Generator] = None) -> dict:
        """The random inputs of one training forward: the token mask's
        flags, drawn from ``generator``, when 0.1 <= mask_rate <= 0.9;
        nothing otherwise.  One mask serves the whole batch."""
        if not 0.1 <= self.mask_rate <= 0.9:
            return {}
        return {"token_mask": random_token_mask(NUM_TOKENS, self.mask_rate,
                                                generator)}

    def _head(self, feat_visual: torch.Tensor,
              token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """21-channel map -> transformer offsets [B,63] float32 (the
        PL-probe segment, reference hand_net.py:364-377,396)."""
        feat = feat_visual.flatten(2)  # [B,21,H*W], token i = channel i
        if self.pos_embed:
            feat = feat + self.pe.to(feat.dtype)
        if self.training and 0.1 <= self.mask_rate <= 0.9:
            # one mask per forward, shared across the batch (reference
            # hand_net.py:369-373, JAX _mask_tokens); the train step
            # passes flags drawn from its own generator
            if token_mask is None:
                token_mask = random_token_mask(feat.shape[1], self.mask_rate,
                                               device=feat.device)
            feat = torch.where(token_mask[None, :, None],
                               self.mask_token.to(feat.dtype), feat)
        out = self.transformer(feat)
        return out.reshape(out.shape[0], -1).float()

    def forward(self, x: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None):
        """``token_mask``: bool [21] flags of the tokens to mask (training
        with 0.1 <= mask_rate <= 0.9 only); drawn here when omitted."""
        with self._autocast(x.device.type):
            main_feat, _, x2, _, _ = self.main_encoder(
                x.to(self.conv1x1_channel_reduction.weight.dtype))
            feat_visual = self.conv1x1_channel_reduction(x2)
            feat_out = self._head(feat_visual, token_mask)
        pl_grad = None
        if self.pl_reg and torch.is_grad_enabled():
            # the StyleGAN2-style path-length probe, JAX's nn.vjp of _head
            # with a ones cotangent (hand_net.py:117-122): a graph of its
            # own, so the loss can differentiate it (double backward).
            # Where autograd records nothing (eval, serving) no probe runs
            # and pl_grad is None: nothing reads it there.
            (pl_grad,) = torch.autograd.grad(feat_out.sum(), feat_visual,
                                             create_graph=True)

        mean = self.mean_params.expand(x.shape[0], 66)
        pred = torch.cat([mean[:, :3], mean[:, 3:] + feat_out], dim=1)
        # HMR iterative refinement (reference hand_net.py:385-387)
        for _ in range(self.iteration):
            pred = pred + self.regressor(torch.cat([main_feat, pred], 1))
        pred_3d = pred[:, 3:].reshape(-1, NUM_TOKENS, 3)
        pred_3d = pred_3d - pred_3d[:, 1:2]  # root-centre (ref :389-393)
        pred = torch.cat([pred[:, :3], pred_3d.reshape(-1, 63)], dim=1)
        if self.pl_reg:
            return pred, feat_visual, pl_grad
        return pred, feat_visual
