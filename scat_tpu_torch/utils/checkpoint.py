"""Weights of a model: a reference ``.pth`` or a seeded fresh init (the
eval-path part of ``scat_tpu/utils/checkpoint.py:138-171``).

  * ``""`` (empty path): a fresh init drawn from a ``torch.Generator``
    seeded with ``seed``, with the distributions of the JAX package's
    flax init (truncated lecun-normal kernels, zero biases, unit norms,
    normal(1) mask token), so a fresh port model is scaled like a fresh
    JAX one.
  * ``*.pth``: a reference-keyed state_dict (or ``{"state_dict": ...}``)
    read with ``torch.load(weights_only=True)`` and loaded with
    ``strict=True``; only the reference's positional-encoding buffer,
    which the port recomputes, is dropped.  A missing file raises, as
    in the JAX package: a typo must not serve random weights.

Orbax checkpoints of the JAX package are not read here; export them to a
``.pth`` with ``scat_tpu.utils.torch_import.export_torch_encoder_transformer``.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn

PE_KEY = "positionalEncoding.pe"  # reference hand_net.py:61-77 buffer
# std of a standard normal truncated to [-2, 2] (flax truncated_normal)
_TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded fresh init in place (flax's default distributions)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        mask_token = getattr(model, "mask_token", None)
        if mask_token is not None:
            nn.init.normal_(mask_token, generator=gen)


def load_weights(model: nn.Module, path: str, seed: int = 0) -> None:
    """Fill ``model`` from ``path`` (see the module docstring)."""
    if not path:
        init_weights(model, seed)
        return
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: scat_tpu_torch reads reference-keyed .pth "
            "checkpoints; pass an empty path for a seeded fresh init")
    apath = os.path.abspath(path)
    if not os.path.exists(apath):
        raise FileNotFoundError(f"torch checkpoint {apath} does not exist")
    sd = torch.load(apath, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    model.load_state_dict({k: v for k, v in sd.items() if k != PE_KEY},
                          strict=True)
