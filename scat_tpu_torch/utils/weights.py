"""Weights of the JAX package's flax trees as the port's state_dict.

``state_dict_from_flax(params, batch_stats)`` renders the numpy (or any
array-like) trees of a ``scat_tpu`` ``EncoderTransformer`` as a state_dict
in the reference SCAT key layout, which the port's ``EncoderTransformer``
loads with ``load_state_dict(strict=True)``.  It is the port's own copy of
the mapping in ``scat_tpu/utils/torch_import.py`` (``_Exporter`` :100-165,
``_walk_resnet``/``_walk_pyramid``/``_walk_encoder`` :191-256,
``export_torch_encoder_transformer`` :551-567), for the plain (not
coarse) head.  Layout conversions: conv kernels HWIO -> OIHW, dense
kernels [in,out] -> [out,in].
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


def _walk_resnet(v) -> None:
    """The backbone under ``main_encoder`` (torchvision key layout; fc1
    is the reference's replacement head).  The walk covers resnet50's
    stages; blocks and convs absent from the tree (resnet18) are
    skipped."""
    fp, tp = ("main_encoder",), "main_encoder."
    v.conv(fp + ("conv1",), tp + "conv1")
    v.bn(fp + ("bn1",), tp + "bn1")
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            fb = fp + (f"layer{stage + 1}_{b}",)
            tb = f"{tp}layer{stage + 1}.{b}"
            for ci in range(1, 4):
                if not v.has(fb + (f"Conv_{ci - 1}",)):
                    continue
                v.conv(fb + (f"Conv_{ci - 1}",), f"{tb}.conv{ci}")
                v.bn(fb + (f"BatchNorm_{ci - 1}",), f"{tb}.bn{ci}")
            if v.has(fb + ("downsample_conv",)):
                v.conv(fb + ("downsample_conv",), f"{tb}.downsample.0")
                v.bn(fb + ("downsample_bn",), f"{tb}.downsample.1")
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
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in e.out.items()}
