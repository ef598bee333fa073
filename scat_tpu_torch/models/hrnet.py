"""HRNet-W{c}, the multi-resolution backbone of ``--net backbone_hrnet``
(port of ``scat_tpu/models/hrnet.py:25-209``; reference
models/hrnet.py:10-261).

Stem (two stride-2 3x3 convolutions) -> four bottlenecks -> branches
added one resolution at a time (transitions 1-3), each stage module runs
four basic blocks a branch and then fuses every branch into every output
branch: a 1x1 convolution, BatchNorm and a nearest upsample going up,
chains of stride-2 3x3 convolutions going down, summed, then ReLU.
``forward`` returns the ``nof_joints``-channel map of the highest
resolution (56x56 at 224 input), NCHW.

Module names are those of the official weights, which the JAX package's
``_walk_hrnet`` writes (``utils/torch_import.py:259-311``):
``transition1.1.0.0``, ``stage3.2.branches.1.3.conv2``,
``stage4.0.fuse_layers.3.0.1.0``, ``final_layer``.  BatchNorm is the
port's ``resnet.BatchNorm2d`` (eps 1e-5, momentum 0.1, flax's running
variance).  Only the JAX package's ``"sum"`` fuse is ported; its
``fuse_mode="concat"`` and ``stop_after`` are knobs of a probe in
``benchmarks/``.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from scat_tpu_torch.models.resnet import BatchNorm2d


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1,
             relu: bool = True) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                        bias=False), BatchNorm2d(cout)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


class HRBottleneck(nn.Module):
    """Reference hrnet.py:10-45 (expansion 4)."""

    def __init__(self, inplanes: int, planes: int, project: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_conv_bn(inplanes, planes * 4, 1, relu=False)
                           if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class HRBasicBlock(nn.Module):
    """Reference hrnet.py:48-77 (expansion 1, same width in and out)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + x)


class StageModule(nn.Module):
    """Parallel branches and the full fuse (reference hrnet.py:79-144).
    ``fuse_layers[i][j]`` carries branch j to output branch i: empty
    (identity) where i == j."""

    def __init__(self, stage: int, output_branches: int, c: int):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*[HRBasicBlock(c * 2 ** i) for _ in range(4)])
            for i in range(stage))
        self.fuse_layers = nn.ModuleList()
        for i in range(output_branches):
            row = nn.ModuleList()
            for j in range(stage):
                if i == j:
                    row.append(nn.Sequential())
                elif i < j:
                    row.append(nn.Sequential(
                        nn.Conv2d(c * 2 ** j, c * 2 ** i, 1, bias=False),
                        BatchNorm2d(c * 2 ** i),
                        nn.Upsample(scale_factor=2.0 ** (j - i),
                                    mode="nearest")))
                else:
                    chain = [_conv_bn(c * 2 ** j, c * 2 ** j, 3, 2)
                             for _ in range(i - j - 1)]
                    chain.append(_conv_bn(c * 2 ** j, c * 2 ** i, 3, 2,
                                          relu=False))
                    row.append(nn.Sequential(*chain))
            self.fuse_layers.append(row)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for row in self.fuse_layers:
            acc = row[0](ys[0])
            for layer, y in zip(row[1:], ys[1:]):
                acc = acc + layer(y)
            fused.append(self.relu(acc))
        return fused


class HRNet(nn.Module):
    """Reference hrnet.py:147-261."""

    def __init__(self, c: int = 48, nof_joints: int = 17):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(HRBottleneck(64, 64, project=True),
                                    *[HRBottleneck(256, 64)
                                      for _ in range(3)])
        # a new branch comes from the lowest resolution; the empty
        # Sequentials keep the official weights' indices
        self.transition1 = nn.ModuleList([
            _conv_bn(256, c, 3),
            nn.Sequential(_conv_bn(256, c * 2, 3, 2))])
        self.stage2 = nn.Sequential(StageModule(2, 2, c))
        self.transition2 = nn.ModuleList(
            [nn.Sequential(), nn.Sequential(),
             nn.Sequential(_conv_bn(c * 2, c * 4, 3, 2))])
        self.stage3 = nn.Sequential(*[StageModule(3, 3, c)
                                      for _ in range(4)])
        self.transition3 = nn.ModuleList(
            [nn.Sequential(), nn.Sequential(), nn.Sequential(),
             nn.Sequential(_conv_bn(c * 4, c * 8, 3, 2))])
        self.stage4 = nn.Sequential(StageModule(4, 4, c),
                                    StageModule(4, 4, c),
                                    StageModule(4, 1, c))
        self.final_layer = nn.Conv2d(c, nof_joints, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        xs = self.stage2(xs)
        xs = xs + [self.transition2[-1](xs[-1])]
        xs = self.stage3(xs)
        xs = xs + [self.transition3[-1](xs[-1])]
        xs = self.stage4(xs)
        return self.final_layer(xs[0])
