"""The flagship ``--net reg_transformer`` (reference hand_net.py:315-398,
resnet.py:101-162, vision_transformer.py:13-101) as plain functions of
a state_dict in the reference key layout.

ResNet-50 (BatchNorm: the batch's statistics in training, the running
ones in eval) -> x2 [B,512,28,28] -> 1x1 conv to 21 tokens of 784 ->
sinusoidal position encoding -> in training the learned mask token on
the drawn tokens -> the pyramid 784 -> 392 -> 196 -> 3 (pre-LN
attention with a residual, then a non-residual pre-LN feed-forward that
halves the width; the last layer's feed-forward is bare and ends in 3)
-> mean + offsets -> ``iteration`` refinements ``pred += regressor(cat(
feat, pred))`` -> joint 1 moved to the origin.  LayerNorm eps 1e-6 and
exact GELU, as the port and the JAX package have them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import F32, Numerics, batch_norm, layer_norm

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # resnet50
BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def trainable(key: str) -> bool:
    return not key.endswith(BUFFER_SUFFIXES)


def resnet50(P, x, train: bool, num: Numerics, pre="main_encoder"):
    """(feat [B,1024], x2) of NCHW ``x``."""
    relu = F.relu
    x = relu(batch_norm(num.conv(x, P[f"{pre}.conv1.weight"], 2, 3), P,
                        f"{pre}.bn1", train))
    x = F.max_pool2d(x, 3, 2, 1)
    x2 = None
    for s, (planes, blocks, stride) in enumerate(STAGES, start=1):
        for j in range(blocks):
            b = f"{pre}.layer{s}.{j}"
            st = stride if j == 0 else 1
            y = relu(batch_norm(num.conv(x, P[f"{b}.conv1.weight"]), P,
                                f"{b}.bn1", train))
            y = relu(batch_norm(num.conv(y, P[f"{b}.conv2.weight"], st, 1),
                                P, f"{b}.bn2", train))
            y = batch_norm(num.conv(y, P[f"{b}.conv3.weight"]), P,
                           f"{b}.bn3", train)
            if j == 0:
                x = batch_norm(num.conv(x, P[f"{b}.downsample.0.weight"], st),
                               P, f"{b}.downsample.1", train)
            x = relu(y + x)
        if s == 2:
            x2 = x
    feat = relu(num.linear(relu(x.mean(dim=(2, 3))), P[f"{pre}.fc1.weight"],
                           P[f"{pre}.fc1.bias"]))
    return feat, x2


def position_encoding(n: int, d: int, device) -> torch.Tensor:
    """[n, d] sin/cos table (reference hand_net.py:61-77)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)[:, : d // 2]
    return pe


def attention(P, x, key, heads: int, dim_head: int, num: Numerics):
    b, n, _ = x.shape
    qkv = num.linear(x, P[f"{key}.to_qkv.weight"])
    q, k, v = qkv.view(b, n, 3, heads, dim_head).permute(2, 0, 3, 1, 4)
    p = torch.softmax(num.mm(q, k.transpose(-1, -2)) * dim_head ** -0.5, -1)
    out = num.mm(p, v).transpose(1, 2).reshape(b, n, heads * dim_head)
    return num.linear(out, P[f"{key}.to_out.0.weight"],
                      P[f"{key}.to_out.0.bias"])


def feed_forward(P, x, key, num: Numerics):
    h = F.gelu(num.linear(x, P[f"{key}.net.0.weight"], P[f"{key}.net.0.bias"]))
    return num.linear(h, P[f"{key}.net.2.weight"], P[f"{key}.net.2.bias"])


def forward(P, images, model: dict, train: bool, draw=None,
            num: Numerics = F32, mean=None) -> torch.Tensor:
    """[B,66] prediction of NHWC float ``images`` in [-1, 1]; ``draw``,
    in training, the bool [21] flags of the masked tokens."""
    feat, x2 = resnet50(P, images.permute(0, 3, 1, 2), train, num)
    fmap = num.conv(x2, P["conv1x1_channel_reduction.weight"])
    tok = fmap.flatten(2)
    n, d = tok.shape[1:]
    if model["pos_embed"]:
        tok = tok + position_encoding(n, d, tok.device)
    if train and draw is not None:
        tok = torch.where(draw[None, :, None], P["mask_token"], tok)
    depth = model["depth"]
    for i in range(depth):
        key = f"transformer.layers.{i}"
        tok = tok + attention(P, layer_norm(tok, P, f"{key}.0.fn.norm"),
                              f"{key}.0.fn.fn", model["heads"],
                              model["dim_head"], num)
        if i < depth - 1:
            tok = feed_forward(P, layer_norm(tok, P, f"{key}.1.norm"),
                               f"{key}.1.fn", num)
        else:
            tok = feed_forward(P, tok, f"{key}.1", num)
    offsets = tok.reshape(tok.shape[0], -1)
    pred = torch.cat([mean[:3].expand(offsets.shape[0], 3),
                      mean[3:] + offsets], dim=1)
    for _ in range(model["iteration"]):
        pred = pred + F.linear(torch.cat([feat, pred], 1),
                               P["regressor.weight"], P["regressor.bias"])
    j3d = pred[:, 3:].reshape(-1, 21, 3)
    j3d = j3d - j3d[:, 1:2]
    return torch.cat([pred[:, :3], j3d.reshape(-1, 63)], dim=1)


def draw(gen: torch.Generator, batch: int, model: dict):
    """The token mask one train step draws (``mask_rate`` of the 21
    tokens, by a permutation on ``gen``), or None where the rate is
    outside [0.1, 0.9]."""
    rate, n = model["mask_rate"], model["tokens"]
    if not 0.1 <= rate <= 0.9:
        return None
    perm = torch.randperm(n, generator=gen, device=gen.device)
    flags = torch.zeros(n, dtype=torch.bool, device=perm.device)
    return flags.index_fill_(0, perm[:int(rate * n)], True)


def slice_draw(draw, rows: slice):
    return draw   # one mask serves the whole batch
