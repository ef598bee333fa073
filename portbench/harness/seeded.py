"""Weights and inputs made from ``--seed``, on the device, by a
``torch.Generator`` there, in a few large calls.

Weights: the configuration's ``init`` lists rules ``[pattern, law,
shift, scale]``; the first whose regular expression matches a key gives
that leaf's law: ``normal`` (shift + scale z), ``uniform`` (shift +
scale u, u in [-1, 1)), ``zero``; a scale of ``"fan_in"`` is
1/sqrt(fan_in) of the leaf (of its weight, for a bias), times the
rule's fifth entry where it has one.  One normal and
one uniform draw over all leaves, then one affine map with the leaves'
shifts and scales repeated over their elements.  Keys are taken in
sorted order, so a seed gives the same tensors however the key list
was obtained."""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

Shapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``: 0 weights,
    1 inputs, ...) of run ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 4 + stream) % (1 << 63))


def _law(key: str, shape, shapes: Shapes, rules) -> Tuple[str, float, float]:
    for rule in rules:
        pattern, law = rule[0], rule[1]
        if re.search(pattern, key):
            if law == "zero":
                return "zero", 0.0, 0.0
            shift, scale = float(rule[2]), rule[3]
            if scale == "fan_in":
                ref = shape
                if key.endswith("bias"):
                    ref = shapes[key[:-len("bias")] + "weight"][0]
                factor = float(rule[4]) if len(rule) > 4 else 1.0
                scale = factor / math.sqrt(math.prod(ref[1:]))
            return law, shift, float(scale)
    raise KeyError(f"no init rule of the configuration matches {key!r}")


def weights(shapes: Shapes, rules, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 (integer leaves: zero) tensors for every key of ``shapes``
    ({key: (shape, dtype)}), drawn from ``seed`` on ``device``."""
    gen = generator(seed, device, 0)
    keys = sorted(shapes)
    laws = [_law(k, shapes[k][0], shapes, rules) for k in keys]
    sizes = [math.prod(shapes[k][0]) for k in keys]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2 - 1
    use_u = torch.tensor([law == "uniform" for law, _, _ in laws],
                         device=device)
    shift = torch.tensor([s for _, s, _ in laws], device=device)
    scale = torch.tensor([0.0 if law == "zero" else c for law, _, c in laws],
                         device=device)
    counts = torch.tensor(sizes, device=device)
    flat = torch.where(use_u.repeat_interleave(counts, output_size=total),
                       uniform, normal)
    flat = flat * scale.repeat_interleave(counts, output_size=total) \
        + shift.repeat_interleave(counts, output_size=total)
    out = {}
    for k, part in zip(keys, torch.split(flat, sizes)):
        shape, dtype = shapes[k]
        t = part.view(shape)
        out[k] = t if dtype.is_floating_point else t.to(dtype)
    return out


def shapes_of(state: Dict[str, torch.Tensor]) -> Shapes:
    """The shape of every tensor of ``state``, floating ones drawn in
    float32 whatever dtype they are held or served in."""
    return {k: (tuple(v.shape), torch.float32 if v.is_floating_point()
                else v.dtype) for k, v in state.items()}


def images(gen: torch.Generator, n: int, size: int) -> torch.Tensor:
    """``n`` NHWC float32 crops in [-1, 1] on ``gen``'s device: a smooth
    field of 8 x 8 random values a channel, bilinearly enlarged, with
    pixel noise, through tanh, so that crops differ as wholes and not
    only pixel by pixel."""
    device = gen.device
    low = torch.randn(n, 3, 8, 8, generator=gen, device=device)
    field = torch.nn.functional.interpolate(low, size=(size, size),
                                           mode="bilinear",
                                           align_corners=False)
    field += 0.25 * torch.randn(n, 3, size, size, generator=gen,
                                device=device)
    return torch.tanh(field).permute(0, 2, 3, 1).contiguous()


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    return ((x + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8)


def labels(gen: torch.Generator, n: int, template: torch.Tensor,
           sigma_3d: float, sigma_2d: float) -> torch.Tensor:
    """[n, 105] labels in the STB layout: 63 floats of 3D joints, the
    template's 21 joints [21, 3] with N(0, sigma_3d^2) each, then their 42
    2D pixel joints under the mean camera (scale 5, no shift: 560 x + 112
    in a 224-pixel crop) with N(0, sigma_2d^2) pixels each.  Labels near
    the template, as a model that regresses offsets from the mean starts
    near them, give every row a gradient of its own."""
    device = gen.device
    j3d = template.reshape(1, 21, 3) + sigma_3d * torch.randn(
        n, 21, 3, generator=gen, device=device)
    j2d = 5.0 * j3d[..., :2] * 112.0 + 112.0 + sigma_2d * torch.randn(
        n, 21, 2, generator=gen, device=device)
    return torch.cat([j3d.reshape(n, 63), j2d.reshape(n, 42)], dim=1)


def log_uniform_sizes(lo: int, hi: int, count: int) -> np.ndarray:
    """``count`` request sizes at the midpoints of ``count`` equal
    quantile bins of the log-uniform law on [lo, hi]: every seed serves
    this same multiset, in its own order."""
    q = (np.arange(count) + 0.5) / count
    return np.floor(np.exp(np.log(lo) + q * (np.log(hi + 1) - np.log(lo)))
                    ).astype(np.int64)


def request_plan(seed: int, lo: int, hi: int, count: int, pool: int,
                 n_requests: int) -> List[Tuple[int, int]]:
    """(offset, size) of the first ``n_requests`` requests of run
    ``seed``: the sizes of ``log_uniform_sizes`` in a seeded order, again
    in a new order after each pass; each at a seeded offset into a pool
    of ``pool`` crops."""
    rng = np.random.default_rng(int(seed))
    sizes = log_uniform_sizes(lo, hi, count)
    out = []
    while len(out) < n_requests:
        for n in rng.permutation(sizes):
            out.append((int(rng.integers(0, pool - n + 1)), int(n)))
    return out[:n_requests]
