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
    read with ``torch.load(weights_only=True)`` and merged non-strictly,
    with the JAX package's semantics (``_load_pth_into``,
    ``scat_tpu/utils/checkpoint.py:78-112``; ``load_pth``): the layout
    is detected as ``torch_import.import_torch_auto`` detects it, every
    tensor whose name and shape match lands, a partial merge prints the
    JAX package's ``WARNING: only M/N checkpoint tensors matched`` line
    and keeps the fresh initialisation for the rest, and zero matches
    raise its "architecture mismatch" error.  A missing file raises, as
    in the JAX package: a typo must not serve random weights.  A ViP
    file loads strictly: its frozen projections ``mains.{i}.w`` are
    buffers of the port's model, and one without them is refused (the
    JAX package refuses every ViP ``.pth`` on this path, as its
    importer cannot place the constants).

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
import re

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


def load_weights(model: nn.Module, path: str, seed: int = 0) -> int:
    """Fill ``model`` from ``path`` (see the module docstring); returns
    the number of tensors merged (0 for a fresh init)."""
    if not path:
        init_weights(model, seed)
        return 0
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: scat_tpu_torch reads reference-keyed .pth "
            "checkpoints; pass an empty path for a seeded fresh init")
    apath = os.path.abspath(path)
    if not os.path.exists(apath):
        raise FileNotFoundError(f"torch checkpoint {apath} does not exist")
    sd = _read(apath)
    if not covers(sd.get("state_dict", sd), model):
        # what the file does not hold keeps a seeded fresh init
        init_weights(model, seed)
    return load_pth(model, sd, apath)


def covers(sd: dict, model: nn.Module) -> bool:
    """Whether ``sd`` holds every tensor of ``model``'s state_dict, by
    name and shape (a full file: no fresh init is left to draw)."""
    own = {_canonical(k): tuple(v.shape) for k, v in sd.items()
           if torch.is_tensor(v)}
    return all(own.get(_canonical(k)) == tuple(v.shape)
               for k, v in model.state_dict().items())


def load_state_dict(model: nn.Module, sd: dict) -> None:
    """A reference-keyed state_dict (or ``{"state_dict": ...}``) into
    ``model``, strictly, but for the positional-encoding buffer that the
    port recomputes."""
    sd = sd.get("state_dict", sd)
    model.load_state_dict({k: v for k, v in sd.items() if k != PE_KEY},
                          strict=True)


def detect_layout(sd: dict) -> str:
    """The layout of a reference state_dict, detected as the JAX
    package's ``torch_import.import_torch_auto`` detects it
    (``torch_import.py:483-541``): "vit", "encoder" (EncoderTransformer,
    plain or coarse, and the HRNet and Inception encoders), "h3dw",
    "hrnet", "inception" or "resnet" (the bare backbones); "vip" for a
    ViP file.  An unknown layout raises the JAX package's error."""
    ks = list(sd)
    if "patch_emb.weight" in sd:
        return "vip"
    if "patch_to_embedding.weight" in sd and any(
            k.startswith("transformer.layers.") for k in ks):
        return "vit"
    if any(k.startswith("transformer.layers") for k in ks):
        return "encoder"
    if any(k.startswith("feat_encoder.") for k in ks):
        return "h3dw"
    for prefix, layout in (("stage2.", "hrnet"), ("Mixed_5b", "inception"),
                           ("layer1.", "resnet")):
        if any(k.startswith(prefix) for k in ks):
            return layout
    raise ValueError("unrecognized torch checkpoint layout: "
                     + ", ".join(sorted(ks)[:5]))


# a pyramid layer's FeedForward is ``{L}.{i}.fn.net`` behind its PreNorm
# and ``{L}.{i}.net`` on the final layer; the JAX package's importer maps
# both to one flax module (``ff_{i}``), so a file of another depth merges
# its FeedForward weights there
_FF = re.compile(r"^(.*transformer\.layers\.\d+\.\d+)\.fn\.net\.")


def _canonical(key: str) -> str:
    return _FF.sub(r"\1.net.", key)


def portable_keys(sd: dict) -> list:
    """The tensors of a file that the JAX package's merge counts against
    (``_load_pth_into``): weights, biases, BN statistics and the mask
    token, less the positional encoding."""
    return [k for k in sd
            if k.endswith((".weight", ".bias", ".running_mean",
                           ".running_var"))
            and "positionalEncoding" not in k] \
        + (["mask_token"] if "mask_token" in sd else [])


def load_pth(model: nn.Module, sd: dict, path: str = "checkpoint") -> int:
    """Merge a reference state_dict into ``model`` with the JAX package's
    semantics (module docstring); returns the merged count, which
    counts what the JAX package's importer counts (the BN step counters
    load but are not counted)."""
    sd = sd.get("state_dict", sd)
    if detect_layout(sd) == "vip":
        missing = [k for k in model.state_dict() if k.endswith(".w")
                   and k.startswith("mains.") and k not in sd]
        if missing:
            # the strict load's error type, with the JAX package's words
            # (torch_import.import_torch_auto)
            raise RuntimeError(
                "ViP checkpoints carry the frozen FAVOR+ features in "
                f"mains.{{i}}.w; {path} lacks {', '.join(missing)}")
        load_state_dict(model, sd)
        merged = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
        print(f"torch checkpoint: merged {merged} tensors from {path}")
        return merged
    own = {_canonical(k): (k, v) for k, v in model.state_dict().items()}
    picked, merged = {}, 0
    for k, v in sd.items():
        if k == PE_KEY or not torch.is_tensor(v):
            continue
        hit = own.get(_canonical(k))
        if hit is not None and tuple(hit[1].shape) == tuple(v.shape):
            picked[hit[0]] = v
            merged += not k.endswith("num_batches_tracked")
    if merged == 0:
        raise ValueError(
            f"{path}: no tensor of the torch checkpoint matched the "
            "built model — architecture mismatch "
            f"(checkpoint keys: {sorted(sd)[:4]}...)")
    portable = portable_keys(sd)
    if merged < len(portable):
        print(f"WARNING: only {merged}/{len(portable)} checkpoint "
              f"tensors matched the model (shape/arch mismatch — check "
              "--vit_heads/--vit_depth/--net against the checkpoint); "
              "unmatched weights keep their fresh initialization")
    model.load_state_dict(picked, strict=False)
    print(f"torch checkpoint: merged {merged} tensors from {path}")
    return merged


def _read(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state_dict")
    return sd


def save_state(folder: str, state, name: str = PERIODIC_NAME) -> str:
    """Atomic full-state save; returns the path.  Under a mesh every rank
    gathers (``TrainState.state_dict``) and process 0 writes."""
    path = os.path.abspath(os.path.join(folder, name))
    sd = state.state_dict()
    from scat_tpu_torch.parallel.mesh import is_main_process
    if not is_main_process():
        return path
    os.makedirs(folder, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)
    return path


def restore_state(path: str, state) -> bool:
    """Resume ``state`` in place from ``path``; False (and a message) if
    the file is missing, as the reference trains from scratch then
    (train.py:68-70).  A full-state file restores everything; a reference
    ``.pth`` (weights only) merges as ``load_pth`` does (the JAX
    package's ``restore_state`` takes ``_load_pth_into`` there), and the
    optimizer starts fresh, the reference's resume (train.py:66-75)."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        print(f"Error: {path} does not exists, Start from Scratch...")
        return False
    sd = _read(path)
    if "optimizer" in sd:
        state.load_state_dict(sd)
    else:
        load_pth(state.model, sd, path)
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
