"""ResNet backbones with the reference's 5-output contract (port of
``scat_tpu/models/resnet.py``; reference models/resnet.py:101-162).

``forward(x)`` with NCHW ``x`` returns ``(feat [B,1024] float32, x1, x2,
x3, x4)``: the fc1 feature plus the four stage maps (x2 is [B,512,28,28]
at 224 input on resnet50 and feeds the token head).  Module names follow
torchvision, so reference checkpoints load by key.

Differences from the JAX package that are not differences in value:
  * the stem is the plain 7x7/s2/pad-3 convolution; the JAX package's
    ``Conv7S2D`` is an exact space-to-depth rewrite of it for the TPU;
  * the stride sits on the 3x3 convolution of ``Bottleneck``, as there.
Only ``norm_layer="batch"`` is ported: ``BatchNorm2d`` below, flax's
``nn.BatchNorm`` (eps 1e-5, momentum 0.9, which is torch's 0.1) in train
and eval mode.
"""

from __future__ import annotations

from typing import List, Sequence, Type, Union

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``torch.nn.BatchNorm2d`` whose train-mode update of
    ``running_var`` is flax's.

    Both normalise with the biased batch variance, and both update
    ``running_mean`` as ``(1-m)*old + m*mean``.  For ``running_var``
    torch takes the unbiased batch variance, n/(n-1) times the biased one
    (n = batch * height * width), flax's ``_compute_stats`` the biased
    one: a 14% larger update at the tests' bs 2 on 2x2 maps, 2e-4 at bs 96
    on 7x7.  The port keeps torch's fused kernel and corrects its result
    on the [C] vector afterwards, with no second pass over the
    activation: torch's kernel updates a copy of the running variance to
    ``t = (1-m)*old + m*var*n/(n-1)`` (a copy, because autograd saves the
    tensor it is given), and ``((n-1)*t + (1-m)*old) / n = (1-m)*old +
    m*var`` is flax's value.  Both terms are positive, so the correction
    loses no precision."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        t = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, t, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(
                t, alpha=(n - 1) / n)
        return y


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    """Reference resnet.py:30-59."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module = None):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, stride)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    """Reference resnet.py:62-98; the stride is on conv2 (the 3x3)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module = None):
        super().__init__()
        self.conv1 = _conv1x1(inplanes, planes)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv1x1(planes, planes * self.expansion)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


Block = Type[Union[BasicBlock, Bottleneck]]


class ResNet(nn.Module):
    """Five-output ResNet (reference resnet.py:101-162)."""

    def __init__(self, block: Block, stage_sizes: Sequence[int],
                 norm_layer: str = "batch"):
        super().__init__()
        if norm_layer != "batch":
            raise NotImplementedError(
                f"norm_layer={norm_layer!r}: only 'batch' is ported "
                "(ROADMAP.md queue 1 item 4)")
        self.block = block
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, stage_sizes[0])
        self.layer2 = self._make_layer(128, stage_sizes[1], stride=2)
        self.layer3 = self._make_layer(256, stage_sizes[2], stride=2)
        self.layer4 = self._make_layer(512, stage_sizes[3], stride=2)
        self.fc1 = nn.Linear(512 * block.expansion, 1024)

    def _make_layer(self, planes: int, blocks: int, stride: int = 1
                    ) -> nn.Sequential:
        out = planes * self.block.expansion
        downsample = None
        if stride != 1 or self.inplanes != out:
            downsample = nn.Sequential(_conv1x1(self.inplanes, out, stride),
                                       BatchNorm2d(out))
        layers: List[nn.Module] = [
            self.block(self.inplanes, planes, stride, downsample)]
        self.inplanes = out
        layers += [self.block(out, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x: torch.Tensor):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        # global average pool + relu + fc1 + relu (reference :155-160)
        feat = torch.relu(self.fc1(torch.relu(x4.mean(dim=(2, 3)))))
        return feat.float(), x1, x2, x3, x4


_ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


def get_model(arch: str, norm_layer: str = "batch") -> ResNet:
    """Backbone factory by name (reference hand_net.py:21-26)."""
    if arch not in _ARCHS:
        raise ValueError("Invalid Backbone Architecture")
    block, stages = _ARCHS[arch]
    return ResNet(block, stages, norm_layer)
