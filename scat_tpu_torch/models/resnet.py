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
``norm_layer`` (``make_norm``, as the JAX package's): "batch" is
``BatchNorm2d`` below, flax's ``nn.BatchNorm`` (eps 1e-5, momentum 0.9,
which is torch's 0.1) in train and eval mode; "group" is ``GroupNorm``,
flax's ``nn.GroupNorm`` with min(32, C) groups and eps 1e-5, the same in
both modes.  Either keeps the reference's module names (``bn1``,
``downsample.1``); GroupNorm has no running statistics.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Type, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from scat_tpu_torch.ops import widen


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
    loses no precision.

    ``process_group`` (set by ``parallel.mesh.sync_batch_norm``): over a
    group of several ranks the training statistics are those of the
    global batch, as GSPMD computes them (``scat_tpu/parallel/mesh.py:
    11-12``): sum x, sum x^2 and the count in float32 through one
    differentiable all-reduce, then flax's ``E[x^2] - E[x]^2`` clamped at
    0 (``use_fast_variance``).  The running statistics take the same
    global values on every rank.  With no group, or a group of one rank,
    the fused local path runs."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = self.process_group
        if group is not None and dist.get_world_size(group) > 1:
            return self._global_batch_norm(x)
        self.num_batches_tracked.add_(1)
        t = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, t, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(
                t, alpha=(n - 1) / n)
        return y

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        from scat_tpu_torch.parallel.mesh import all_reduce_sum
        self.num_batches_tracked.add_(1)
        c = x.shape[1]
        xf = widen(x)
        dims = (0, 2, 3)
        count = xf.new_full((1,), x.numel() // c)
        sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                         count]), self.process_group)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        scale = self.weight * torch.rsqrt(var + self.eps)
        # the bias enters through a product: a [1,C,1,1] output's gradient
        # summed to [C] is that gradient itself, which the residual add
        # also hands to the other branch's BatchNorm, and two .grad
        # sharing one tensor would count a second micro-step twice
        shift = self.bias * torch.ones_like(self.bias) - mean * scale
        y = torch.addcmul(shift[None, :, None, None], xf,
                          scale[None, :, None, None])
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups=min(32, C), epsilon=1e-5,
    dtype=compute)`` (``scat_tpu/models/resnet.py:37-45``): the
    statistics and the affine in float32 from float32 parameters, the
    output in the input's dtype (bf16 under bf16 compute).

    ``F.group_norm`` on CUDA works on NCHW-contiguous float32, so a
    channels_last bf16 model pays a layout copy and a cast around each
    norm; computing the statistics on the NHWC storage by hand was no
    faster on the H100 (PERF.md section 6, PR 7)."""

    def __init__(self, channels: int):
        super().__init__(min(32, channels), channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(widen(x), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


Norm = Callable[[int], nn.Module]
NORMS = {"batch": BatchNorm2d, "group": GroupNorm}


def make_norm(norm_layer: str) -> Norm:
    """The normalisation of ``norm_layer``, "batch" or "group"."""
    if norm_layer not in NORMS:
        raise ValueError(f"norm_layer={norm_layer!r}: expected 'batch' or "
                         "'group'")
    return NORMS[norm_layer]


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False)


class BasicBlock(nn.Module):
    """Reference resnet.py:30-59."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module = None, norm: Norm = BatchNorm2d):
        super().__init__()
        self.conv1 = _conv3x3(inplanes, planes, stride)
        self.bn1 = norm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = _conv3x3(planes, planes)
        self.bn2 = norm(planes)
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
                 downsample: nn.Module = None, norm: Norm = BatchNorm2d):
        super().__init__()
        self.conv1 = _conv1x1(inplanes, planes)
        self.bn1 = norm(planes)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn2 = norm(planes)
        self.conv3 = _conv1x1(planes, planes * self.expansion)
        self.bn3 = norm(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


Block = Type[Union[BasicBlock, Bottleneck]]


def make_layer(block: Block, inplanes: int, planes: int, blocks: int,
               stride: int = 1, norm: Norm = BatchNorm2d) -> nn.Sequential:
    """A stage of ``blocks`` blocks, the first with the stride and, where
    the shape changes, the 1x1 downsample (torchvision's
    ``_make_layer``)."""
    out = planes * block.expansion
    downsample = None
    if stride != 1 or inplanes != out:
        downsample = nn.Sequential(_conv1x1(inplanes, out, stride),
                                   norm(out))
    layers: List[nn.Module] = [block(inplanes, planes, stride, downsample,
                                     norm)]
    layers += [block(out, planes, norm=norm) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet(nn.Module):
    """Five-output ResNet (reference resnet.py:101-162)."""

    def __init__(self, block: Block, stage_sizes: Sequence[int],
                 norm_layer: str = "batch"):
        super().__init__()
        self.norm = make_norm(norm_layer)
        self.block = block
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = self.norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, stage_sizes[0])
        self.layer2 = self._make_layer(128, stage_sizes[1], stride=2)
        self.layer3 = self._make_layer(256, stage_sizes[2], stride=2)
        self.layer4 = self._make_layer(512, stage_sizes[3], stride=2)
        self.fc1 = nn.Linear(512 * block.expansion, 1024)

    def _make_layer(self, planes: int, blocks: int, stride: int = 1
                    ) -> nn.Sequential:
        layer = make_layer(self.block, self.inplanes, planes, blocks,
                           stride, self.norm)
        self.inplanes = planes * self.block.expansion
        return layer

    def forward(self, x: torch.Tensor):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        # global average pool + relu + fc1 + relu (reference :155-160)
        feat = torch.relu(self.fc1(torch.relu(x4.mean(dim=(2, 3)))))
        return widen(feat), x1, x2, x3, x4


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
