"""Checkpoints (port of ``scat_tpu/utils/checkpoint.py:27-171``): the
weights of a model, a reference ``.pth`` or a seeded fresh init, and the
full train state.

Weights, ``load_weights(model, path, seed)``:

  * ``""`` (empty path): a fresh init drawn from a ``torch.Generator``
    seeded with ``seed``, with the distributions of the JAX package's
    init (flagship: flax's truncated lecun-normal kernels, zero biases,
    unit norms, normal(1) mask token, cls token and ViT's position
    embedding; ViP and the motion discriminator: their own, see
    ``ViP.init_weights``), so a fresh port model is scaled like a fresh
    JAX one.
  * ``*.pth``: a reference-keyed state_dict (or ``{"state_dict": ...}``)
    read with ``torch.load(weights_only=True)`` and loaded with
    ``strict=True``; only the reference's positional-encoding buffer,
    which the port recomputes, is dropped.  A missing file raises, as
    in the JAX package: a typo must not serve random weights, and a ViP
    file without its frozen projections ``mains.{i}.w`` must not load.

Train state, ``save_state``/``restore_state``: one ``torch.save`` of
``TrainState.state_dict()`` (model, optimizer, schedule, generator,
step, PL EMA), loadable with ``torch.load(weights_only=True)``, written
atomically to ``{folder}/hand_net.pth`` (periodic) and
``hand_net_final.pth`` (final), the reference's names (train.py:237-246).
The model part sits under ``"state_dict"`` in the reference key layout,
so the file is also a reference ``.pth`` that ``load_weights`` (and
``HandPosePredictor.from_checkpoint``) reads as it is.

Orbax checkpoints of the JAX package are not read here; export them to a
``.pth`` with ``scat_tpu.utils.torch_import.export_torch_encoder_transformer``.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn

PE_KEY = "positionalEncoding.pe"  # reference hand_net.py:61-77 buffer
FINAL_NAME = "hand_net_final.pth"
PERIODIC_NAME = "hand_net.pth"
# std of a standard normal truncated to [-2, 2] (flax truncated_normal)
_TRUNC_STD = 0.87962566103423978
NORMAL_PARAMETERS = ("mask_token", "cls_token", "pos_embedding")


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init in place: lecun normal truncated to two
    standard deviations, fan-in the weight's input width."""
    std = math.sqrt(1.0 / weight[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded fresh init in place: the model's own ``init_weights`` where
    it has one (ViP: the JAX package's torch-style init), else flax's
    default distributions."""
    gen = torch.Generator().manual_seed(seed)
    own = getattr(model, "init_weights", None)
    if own is not None:
        own(gen)
        return
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        # the learned tokens and ViT's position embedding: normal(1)
        for name in NORMAL_PARAMETERS:
            p = getattr(model, name, None)
            if p is not None:
                nn.init.normal_(p, generator=gen)


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
    load_state_dict(model, _read(apath))


def load_state_dict(model: nn.Module, sd: dict) -> None:
    """A reference-keyed state_dict (or ``{"state_dict": ...}``) into
    ``model``, strictly, but for the positional-encoding buffer that the
    port recomputes."""
    sd = sd.get("state_dict", sd)
    model.load_state_dict({k: v for k, v in sd.items() if k != PE_KEY},
                          strict=True)


def _read(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state_dict")
    return sd


def save_state(folder: str, state, name: str = PERIODIC_NAME) -> str:
    """Atomic full-state save; returns the path."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.abspath(os.path.join(folder, name))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    return path


def restore_state(path: str, state) -> bool:
    """Resume ``state`` in place from ``path``; False (and a message) if
    the file is missing, as the reference trains from scratch then
    (train.py:68-70).  A full-state file restores everything; a reference
    ``.pth`` (weights only) merges the tensors whose names and shapes
    match, non-strict, and the optimizer starts fresh, the reference's
    resume (train.py:66-75)."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        print(f"Error: {path} does not exists, Start from Scratch...")
        return False
    sd = _read(path)
    if "optimizer" in sd:
        state.load_state_dict(sd)
    else:
        merged = merge_matching(state.model, sd.get("state_dict", sd))
        print(f"torch checkpoint: merged {merged} tensors from {path}")
    print(f"Checkpoint loaded from: {path}")
    return True


def merge_matching(module: nn.Module, sd: dict, prefix: str = "") -> int:
    """Copy the tensors of ``sd`` whose ``prefix``-stripped names and
    shapes match ``module``'s state into it (``strict=False`` semantics,
    size mismatches skipped); returns how many were copied."""
    own = module.state_dict()
    picked = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        if name in own and tuple(own[name].shape) == tuple(v.shape):
            picked[name] = v
    module.load_state_dict(picked, strict=False)
    return len(picked)


def load_pretrained_backbone(model: nn.Module, path: str) -> int:
    """Merge a torchvision ImageNet ResNet ``.pth`` into
    ``model.main_encoder``, non-strict (the reference initializes from
    model-zoo weights, resnet.py:186-196; ``--pretrained_resnet_pth``).
    A file with no matching tensor raises: a wrong file must not train
    from scratch unnoticed."""
    sd = _read(path)
    sd = sd.get("state_dict", sd)
    # a full hand_net .pth carries the backbone under main_encoder.
    prefix = ("main_encoder." if any(k.startswith("main_encoder.")
                                      for k in sd) else "")
    merged = merge_matching(model.main_encoder, sd, prefix)
    if merged == 0:
        raise ValueError(
            f"--pretrained_resnet_pth {path!r}: no tensor matched the "
            "torchvision ResNet layout (expected keys like "
            "'conv1.weight', 'layer1.0.conv1.weight')")
    print(f"pretrained backbone: merged {merged} tensors from {path}")
    return merged
