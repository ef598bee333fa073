"""The yardstick the per-layer metrics share: the card's published
peaks, the model FLOPs of one crop's forward of each configuration, the
serving path's chunking, and a kernel's share of its roofline over a
trace's launches.  Operations and bytes are reckoned from shapes: they
count the same work whatever implements it."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAK_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_F32 = 67e12            # FLOP/s, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

RESNET50 = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def resnet50_macs(size: int) -> Tuple[int, int]:
    """(multiply-adds of ResNet-50's convolutions and fc1 [2048 -> 1024]
    at ``size``^2, the side of layer2's map x2)."""
    side = (size + 2 * 3 - 7) // 2 + 1             # conv1 7x7/2
    macs = side * side * 64 * 3 * 49
    side = (side + 2 - 3) // 2 + 1                 # max pool 3x3/2
    cin, x2_side = 64, 0
    for s, (planes, blocks, stride) in enumerate(RESNET50, start=1):
        for j in range(blocks):
            st = stride if j == 0 else 1
            out = (side - 1) // st + 1
            macs += side * side * planes * cin             # conv1 1x1
            macs += out * out * planes * planes * 9        # conv2 3x3/st
            macs += out * out * planes * 4 * planes        # conv3 1x1
            if j == 0:
                macs += out * out * planes * 4 * cin       # downsample
            cin, side = planes * 4, out
        if s == 2:
            x2_side = side
    return macs + 2048 * 1024, x2_side


def flagship_flops(model: dict, size: int) -> float:
    """One crop's forward: ResNet-50, the 1x1 conv to the tokens, the
    pyramid (the attention's four Linears and two products, the
    feed-forward), the refinements; 2 FLOPs a multiply-add."""
    macs, x2 = resnet50_macs(size)
    n, d = model["tokens"], model["token_dim"]
    macs += x2 * x2 * 512 * n
    inner = model["heads"] * model["dim_head"]
    for i in range(model["depth"]):
        hidden = (d * 3) // 4
        out = 3 if i == model["depth"] - 1 else d // 2
        macs += n * d * 3 * inner + 2 * n * n * inner + n * inner * d
        macs += n * d * hidden + n * hidden * out
        d = out if i < model["depth"] - 1 else d
    macs += model["iteration"] * (1024 + 66) * 66
    return 2.0 * macs


def vip_flops(model: dict, size: int) -> float:
    """One crop's forward: the patch embedding, each block's kqv, the
    FAVOR+ products (both feature maps, phi(k)^T v, the output and the
    normaliser), proj and the MLP, the refinements; 2 FLOPs a
    multiply-add."""
    p, heads, e, m = model["patch"], model["heads"], model["emb_s"], \
        model["features"]
    emb = heads * e
    t = (size // p) ** 2 + 1
    macs = (t - 1) * 3 * p * p * emb
    per_token = (heads * e * 3 * e            # kqv, each head's slice
                 + heads * (2 * m * e + m * e + m * e + m)   # FAVOR+
                 + emb * emb                  # proj
                 + 2 * emb * 4 * emb)         # MLP
    macs += model["depth"] * t * per_token
    macs += model["iteration"] * (emb + 66) * 66
    return 2.0 * macs


def forward_flops(config: dict) -> float:
    count = {"flagship": flagship_flops, "vip": vip_flops}[
        config["model"]["kind"]]
    return count(config["model"], config["image_size"])


def chunks(n: int, ladder: Sequence[int]) -> List[int]:
    """The bucket sizes a request of ``n`` crops runs as: full top-bucket
    chunks, then the remainder padded to the smallest bucket that holds
    it (the port's serving.run_bucketed)."""
    big = ladder[-1]
    out = [big] * (n // big)
    rem = n % big
    if rem or not out:
        out.append(next((b for b in ladder if b >= rem), big))
    return out


def bound_s(n_bytes: float, flops: float, peak: float = PEAK_BF16) -> float:
    """The least time: the larger of bytes over the memory rate and
    operations over ``peak``."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)


def roofline_pct(traces, patterns: Sequence[str], count_pattern: str,
                 bounds: Sequence[float]) -> "float | None":
    """100 x the sum of ``bounds`` (one a launch) over the device time of
    the events matching ``patterns`` in the stretch traced with the CUDA
    activity alone, or None where that stretch holds no such event (the
    kernel is off the path).  Raises where the launches of
    ``count_pattern`` do not number ``len(bounds)``: the traced work is
    not what was reckoned, and a share of it would be wrong."""
    if traces is None:
        return None
    seconds, _ = traces.cuda_only.device_time(patterns)
    _, launches = traces.cuda_only.device_time((count_pattern,))
    if launches == 0:
        return None
    if launches != len(bounds) or seconds <= 0:
        raise RuntimeError(
            f"{count_pattern}: the traced stretch holds {launches} launches "
            f"where the reader reckoned {len(bounds)}; its roofline cannot "
            "be read")
    return 100.0 * math.fsum(bounds) / seconds

