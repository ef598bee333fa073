"""Auxiliary modules (port of ``scat_tpu/models/helpers.py:23-96``):

* ``TruncatedResNet``: the ResNet-50 trunk cut after layer2, returning
  the stride-8 512-channel map (reference
  models/helper/resnet_helper.py:101-158);
* ``SPADE``: spatially-adaptive denormalisation, a parameter-free
  BatchNorm or InstanceNorm of x modulated by gamma and beta maps
  computed from a segmentation map (reference
  models/helper/spatial_norm.py:20-59).

Neither is on an entry point's path, in the reference or in the JAX
package; they complete the inventory.  NCHW, float32; the BatchNorms are flax's
(``resnet.BatchNorm2d``).  Keys: torchvision's (``conv1``, ``bn1``,
``layer{1,2}.*``); SPADE's ``param_free_norm`` (running statistics
only), ``mlp_shared.0``, ``mlp_gamma``, ``mlp_beta``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from scat_tpu_torch.models.resnet import BatchNorm2d, Bottleneck, make_layer


class TruncatedResNet(nn.Module):
    """conv1, bn1, ReLU, max-pool, then ``stage_sizes`` stages of
    Bottlenecks (64 and 128 planes): [B,3,H,W] -> [B,512,H/8,W/8]."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for i, blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** i
            setattr(self, f"layer{i + 1}", make_layer(
                Bottleneck, inplanes, planes, blocks, 2 if i else 1))
            inplanes = planes * Bottleneck.expansion
        self.stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class SPADE(nn.Module):
    """Normalise ``x`` without parameters ("batch": flax's BatchNorm with
    no scale or bias, running statistics in eval mode; "instance": each
    sample's and channel's spatial mean and biased variance, eps 1e-5),
    then ``* (1 + gamma) + beta`` from the segmentation map resized to
    x's size by nearest index (``ys = arange(h) * sh // h``, the JAX
    package's, not ``F.interpolate``'s rounding)."""

    def __init__(self, norm_nc: int, label_nc: int, nhidden: int = 32,
                 param_free_norm_type: str = "batch", ks: int = 3):
        super().__init__()
        if param_free_norm_type not in ("batch", "instance"):
            raise ValueError(f"{param_free_norm_type} is not a recognized "
                             "param-free norm type in SPADE")
        self.norm_type = param_free_norm_type
        if param_free_norm_type == "batch":
            self.param_free_norm = BatchNorm2d(norm_nc, affine=False)
        pad = ks // 2
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, nhidden, ks, padding=pad), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=pad)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=pad)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "batch":
            normalized = self.param_free_norm(x)
        else:
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
            normalized = (x - mean) / torch.sqrt(var + 1e-5)
        h, w = x.shape[2:]
        sh, sw = segmap.shape[2:]
        ys = torch.arange(h, device=x.device) * sh // h
        xs = torch.arange(w, device=x.device) * sw // w
        seg = segmap[:, :, ys][:, :, :, xs]
        actv = self.mlp_shared(seg)
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)
