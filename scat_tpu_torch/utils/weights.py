"""Weights of the JAX package's flax trees as the port's state_dict.

``state_dict_from_flax(params, batch_stats)`` renders the numpy (or any
array-like) trees of a ``scat_tpu`` ``EncoderTransformer`` as a state_dict
in the reference SCAT key layout, which the port's ``EncoderTransformer``
loads with ``load_state_dict(strict=True)``; ``vip_state_dict_from_flax
(params, constants)`` does the same for ``ViP``.  They are the port's own
copy of the mapping in ``scat_tpu/utils/torch_import.py`` (``_Exporter``
:100-165, ``_walk_resnet``/``_walk_pyramid``/``_walk_encoder`` :191-256,
``_walk_vip`` :343-358, ``export_torch_encoder_transformer`` :551-567,
``export_torch_vip`` :472-480), for the plain (not coarse) head.  Layout
conversions: conv kernels HWIO -> OIHW, dense kernels [in,out] ->
[out,in].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


class _Exporter:
    """Visitor that renders flax trees as a torch-keyed dict of arrays."""

    def __init__(self, params: Dict, batch_stats: Optional[Dict]):
        self.params = params
        self.batch_stats = batch_stats or {}
        self.out: Dict[str, np.ndarray] = {}

    @staticmethod
    def _leaf(tree, path):
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                return None
            node = node[k]
        return None if isinstance(node, dict) else np.asarray(node)

    def has(self, flax_path: Tuple[str, ...]) -> bool:
        node = self.params
        for k in flax_path:
            if not isinstance(node, dict) or k not in node:
                return False
            node = node[k]
        return True

    def conv(self, flax_path, torch_name):
        k = self._leaf(self.params, flax_path + ("kernel",))
        if k is not None:
            self.out[torch_name + ".weight"] = np.transpose(k, (3, 2, 0, 1))

    def bn(self, flax_path, torch_name):
        table = [("scale", ".weight", self.params),
                 ("bias", ".bias", self.params),
                 ("mean", ".running_mean", self.batch_stats),
                 ("var", ".running_var", self.batch_stats)]
        wrote = False
        for leaf, suffix, tree in table:
            v = self._leaf(tree, flax_path + (leaf,))
            if v is not None:
                self.out[torch_name + suffix] = v
                wrote = True
        if wrote:
            self.out[torch_name + ".num_batches_tracked"] = np.asarray(
                0, np.int64)

    def dense(self, flax_path, torch_name):
        w = self._leaf(self.params, flax_path + ("kernel",))
        if w is not None:
            self.out[torch_name + ".weight"] = w.T
        b = self._leaf(self.params, flax_path + ("bias",))
        if b is not None:
            self.out[torch_name + ".bias"] = b

    def ln(self, flax_path, torch_name):
        for leaf, suffix in (("scale", ".weight"), ("bias", ".bias")):
            v = self._leaf(self.params, flax_path + (leaf,))
            if v is not None:
                self.out[torch_name + suffix] = v

    def raw(self, flax_path, torch_name):
        v = self._leaf(self.params, flax_path)
        if v is not None:
            self.out[torch_name] = v


def _norm(v, flax_path, torch_name) -> None:
    """A BatchNorm, or the GroupNorm of ``norm_layer="group"``, whose
    ``_GN`` wrapper (``scat_tpu/models/resnet.py:37-45``) nests its
    ``GroupNorm_0`` one level down and has no running statistics."""
    gn = flax_path + ("GroupNorm_0",)
    if v.has(gn):
        v.ln(gn, torch_name)
    else:
        v.bn(flax_path, torch_name)


def _walk_resnet(v) -> None:
    """The backbone under ``main_encoder`` (torchvision key layout; fc1
    is the reference's replacement head).  The walk covers resnet50's
    stages; blocks and convs absent from the tree (resnet18) are
    skipped.  A block's norms are auto-named ``BatchNorm_<i>``, or
    ``_GN_<i>`` under GroupNorm."""
    fp, tp = ("main_encoder",), "main_encoder."
    v.conv(fp + ("conv1",), tp + "conv1")
    _norm(v, fp + ("bn1",), tp + "bn1")
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            fb = fp + (f"layer{stage + 1}_{b}",)
            tb = f"{tp}layer{stage + 1}.{b}"
            for ci in range(1, 4):
                if not v.has(fb + (f"Conv_{ci - 1}",)):
                    continue
                v.conv(fb + (f"Conv_{ci - 1}",), f"{tb}.conv{ci}")
                norm = fb + (f"BatchNorm_{ci - 1}",)
                if not v.has(norm):
                    norm = fb + (f"_GN_{ci - 1}",)
                _norm(v, norm, f"{tb}.bn{ci}")
            if v.has(fb + ("downsample_conv",)):
                v.conv(fb + ("downsample_conv",), f"{tb}.downsample.0")
                _norm(v, fb + ("downsample_bn",), f"{tb}.downsample.1")
    v.dense(fp + ("fc1",), tp + "fc1")


def _walk_pyramid(v, depth: int) -> None:
    """Plain pyramid transformer: ``transformer.layers.{i}.0`` is
    Residual(PreNorm(Attention)), ``.1`` is PreNorm(FeedForward), or a
    bare FeedForward on the final layer."""
    for i in range(depth):
        L = f"transformer.layers.{i}"
        attn = ("transformer", f"attn_{i}")
        v.dense(attn + ("to_qkv",), f"{L}.0.fn.fn.to_qkv")
        v.dense(attn + ("to_out",), f"{L}.0.fn.fn.to_out.0")
        v.ln(("transformer", f"attn_norm_{i}"), f"{L}.0.fn.norm")
        net = f"{L}.1"
        if i != depth - 1:
            v.ln(("transformer", f"ff_norm_{i}"), f"{L}.1.norm")
            net += ".fn"
        v.dense(("transformer", f"ff_{i}", "Dense_0"), net + ".net.0")
        v.dense(("transformer", f"ff_{i}", "Dense_1"), net + ".net.2")


def _walk_vip(v, depth: int) -> None:
    """ViP (``_walk_vip`` :343-358): patch embedding, position embedding,
    cls token, head and the blocks; the frozen ``w`` is walked from the
    ``constants`` tree by the caller."""
    v.raw(("pos_emb",), "pos_emb")
    v.raw(("cls_token",), "cls_token")
    v.dense(("patch_emb",), "patch_emb")
    v.dense(("head",), "head")
    for i in range(depth):
        fb, tb = f"block_{i}", f"mains.{i}"
        v.dense((fb, "kqv"), f"{tb}.kqv")
        v.dense((fb, "proj"), f"{tb}.proj")
        v.ln((fb, "ln1"), f"{tb}.ln1")
        v.ln((fb, "ln2"), f"{tb}.ln2")
        v.dense((fb, "mlp1"), f"{tb}.mlp.0")
        v.dense((fb, "mlp2"), f"{tb}.mlp.2")


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}


def vip_state_dict_from_flax(params: Dict, constants: Dict
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ViP`` (params, constants) trees as a
    reference-keyed state_dict of CPU tensors (the port's copy of
    ``export_torch_vip`` :472-480): dense kernels transposed, each
    block's frozen projection ``constants/block_{i}/w`` as
    ``mains.{i}.w``.  The depth is read from the tree."""
    depth = sum(1 for k in params if k.startswith("block_"))
    e = _Exporter(params, None)
    _walk_vip(e, depth)
    c = _Exporter(constants, None)
    for i in range(depth):
        c.raw((f"block_{i}", "w"), f"mains.{i}.w")
    return _tensors({**e.out, **c.out})


def state_dict_from_flax(params: Dict, batch_stats: Optional[Dict] = None
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncoderTransformer`` (params, batch_stats)
    trees as a reference-keyed state_dict of CPU tensors; the pyramid
    depth is read from the tree.  Subtrees absent from ``params`` are
    skipped, so a tree holding only ``main_encoder`` or ``transformer``
    gives that part's keys.  The sinusoidal PE and the mean template are
    deterministic and not part of it."""
    tr = params.get("transformer", {})
    depth = 1 + max((int(k.split("_")[-1]) for k in tr
                     if k.startswith("attn_") and "norm" not in k),
                    default=-1)
    e = _Exporter(params, batch_stats)
    _walk_resnet(e)
    e.conv(("conv1x1_channel_reduction",), "conv1x1_channel_reduction")
    e.raw(("mask_token",), "mask_token")
    e.dense(("regressor",), "regressor")
    _walk_pyramid(e, depth)
    return _tensors(e.out)
