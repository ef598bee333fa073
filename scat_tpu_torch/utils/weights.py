"""Weights of the JAX package's flax trees as the port's state_dict.

``state_dict_from_flax(params, batch_stats, coarse=False)`` renders the
numpy (or any array-like) trees of a ``scat_tpu`` ``EncoderTransformer``
(or, with ``coarse=True``, ``EncoderTransformerCoarse``) as a state_dict
in the reference SCAT key layout, which the port's module loads with
``load_state_dict(strict=True)``; ``vip_state_dict_from_flax(params,
constants)`` does the same for ``ViP``, and
``hrnet_state_dict_from_flax`` / ``inception_state_dict_from_flax`` for
``EncoderTransformerHRNet`` / ``EncoderTransformerInception``,
``vit_state_dict_from_flax`` for ``ViT``, ``h3dw_state_dict_from_flax``
for ``H3DWEncoder`` and ``H3DWJointsEncoder``, and
``{yunqian,truncated_resnet,spade,motion_discriminator}_state_dict_from_flax``
for the rest.  They are the port's own copy of the mapping in
``scat_tpu/utils/torch_import.py`` (``_Exporter`` :100-165,
``_walk_resnet``/``_walk_pyramid``/``_walk_encoder`` :191-256,
``_walk_hrnet`` :259-311, ``_walk_h3dw`` :313-319, ``_walk_token_head``
:321-331, ``_walk_vit`` :333-341, ``_walk_vip`` :343-358,
``_walk_conv_bn_tree`` :361-379, the ``h3dw`` scope :525-527,
``export_torch_encoder_transformer`` :551-567, ``export_torch_vip``
:472-480, ``export_torch_{hrnet,inception}_encoder`` :593-615, and the
GRU gates of ``import_torch_motion_discriminator`` :616-680).  Layout
conversions: conv kernels HWIO -> OIHW, dense kernels [in,out] ->
[out,in].

``flax_from_state_dict(net, sd)`` is the inverse: a reference-keyed
state_dict as ``{"params", "batch_stats", "constants"}`` numpy trees
under flax's names, through the same walks (the port's counterpart of
``torch_import.import_torch_*``, ``torch_import.py:381-464, 616``).
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

    def has(self, flax_path: Tuple[str, ...],
            torch_name: Optional[str] = None) -> bool:
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


    def is_group_norm(self, flax_path, torch_name) -> bool:
        return self.has(flax_path + ("GroupNorm_0",))

    def block_norm(self, fb, i: int, torch_name) -> Tuple[str, ...]:
        """A block's i-th norm: ``BatchNorm_<i>``, or ``_GN_<i>``."""
        bn = fb + (f"BatchNorm_{i}",)
        return bn if self.has(bn) else fb + (f"_GN_{i}",)


def _norm(v, flax_path, torch_name) -> None:
    """A BatchNorm, or the GroupNorm of ``norm_layer="group"``, whose
    ``_GN`` wrapper (``scat_tpu/models/resnet.py:37-45``) nests its
    ``GroupNorm_0`` one level down and has no running statistics."""
    if v.is_group_norm(flax_path, torch_name):
        v.ln(flax_path + ("GroupNorm_0",), torch_name)
    else:
        v.bn(flax_path, torch_name)


def _walk_resnet(v, fp: Tuple[str, ...] = ("main_encoder",),
                 tp: str = "main_encoder.") -> None:
    """The backbone under flax path ``fp``, torch prefix ``tp``
    (torchvision key layout; fc1 is the reference's replacement head).
    The walk covers resnet50's stages; blocks, convs and the fc1 absent
    from the tree (resnet18, the truncated trunk) are skipped.  A block's
    norms are auto-named ``BatchNorm_<i>``, or ``_GN_<i>`` under
    GroupNorm."""
    v.conv(fp + ("conv1",), tp + "conv1")
    _norm(v, fp + ("bn1",), tp + "bn1")
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            fb = fp + (f"layer{stage + 1}_{b}",)
            tb = f"{tp}layer{stage + 1}.{b}"
            for ci in range(1, 4):
                if not v.has(fb + (f"Conv_{ci - 1}",), f"{tb}.conv{ci}"):
                    continue
                v.conv(fb + (f"Conv_{ci - 1}",), f"{tb}.conv{ci}")
                _norm(v, v.block_norm(fb, ci - 1, f"{tb}.bn{ci}"),
                      f"{tb}.bn{ci}")
            if v.has(fb + ("downsample_conv",), f"{tb}.downsample.0"):
                v.conv(fb + ("downsample_conv",), f"{tb}.downsample.0")
                _norm(v, fb + ("downsample_bn",), f"{tb}.downsample.1")
    v.dense(fp + ("fc1",), tp + "fc1")


def _walk_pyramid(v, depth: int, coarse: bool = False,
                  fp: Tuple[str, ...] = ("transformer",)) -> None:
    """The pyramid transformer under flax path ``fp``.  Plain:
    ``transformer.layers.{i}.0`` is Residual(PreNorm(Attention)), ``.1``
    is PreNorm(FeedForward), or a bare FeedForward on the final layer.
    Coarse (the attention-returning variant): ``.0`` is a bare Attention,
    ``.1.norm`` the post-norm, ``.2`` the feed-forward as ``.1`` above."""
    for i in range(depth):
        L = f"transformer.layers.{i}"
        if coarse:
            attn_base, norm_name, ff = f"{L}.0", f"{L}.1.norm", f"{L}.2"
        else:
            attn_base, norm_name, ff = f"{L}.0.fn.fn", f"{L}.0.fn.norm", \
                f"{L}.1"
        attn = fp + (f"attn_{i}",)
        v.dense(attn + ("to_qkv",), attn_base + ".to_qkv")
        v.dense(attn + ("to_out",), attn_base + ".to_out.0")
        v.ln(fp + (f"attn_norm_{i}",), norm_name)
        net = ff
        if i != depth - 1:
            v.ln(fp + (f"ff_norm_{i}",), ff + ".norm")
            net += ".fn"
        v.dense(fp + (f"ff_{i}", "Dense_0"), net + ".net.0")
        v.dense(fp + (f"ff_{i}", "Dense_1"), net + ".net.2")


def _pyramid_depth(tree: Dict) -> int:
    return 1 + max((int(k.split("_")[-1]) for k in tree
                    if k.startswith("attn_") and "norm" not in k),
                   default=-1)


def _walk_hrnet(v, fp: Tuple[str, ...], tp: str) -> None:
    """HRNet (``_walk_hrnet`` :259-311): the official weights' layout,
    transitions as double Sequentials, stages as branches and
    fuse_layers."""
    for cv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        v.conv(fp + (cv,), tp + cv)
        v.bn(fp + (bn,), tp + bn)
    for b in range(4):
        fb, tb = fp + (f"layer1_{b}",), f"{tp}layer1.{b}"
        for ci in range(1, 4):
            v.conv(fb + (f"Conv_{ci - 1}",), f"{tb}.conv{ci}")
            v.bn(fb + (f"BatchNorm_{ci - 1}",), f"{tb}.bn{ci}")
        if v.has(fb + ("downsample_conv",), f"{tb}.downsample.0"):
            v.conv(fb + ("downsample_conv",), f"{tb}.downsample.0")
            v.bn(fb + ("downsample_bn",), f"{tb}.downsample.1")
    for fl, tr in (("t1_conv0", "transition1.0"),
                   ("t1_conv1", "transition1.1.0"),
                   ("t2_conv", "transition2.2.0"),
                   ("t3_conv", "transition3.3.0")):
        v.conv(fp + (fl,), f"{tp}{tr}.0")
        v.bn(fp + (fl.replace("conv", "bn"),), f"{tp}{tr}.1")
    for s, nmod in ((2, 1), (3, 4), (4, 3)):
        for mod in range(nmod):
            fmod, tmod = fp + (f"stage{s}_{mod}",), f"{tp}stage{s}.{mod}"
            out_b = 1 if (s == 4 and mod == 2) else s
            for i in range(s):
                for b in range(4):
                    fb = fmod + (f"branch{i}_block{b}",)
                    tb = f"{tmod}.branches.{i}.{b}"
                    for ci in (1, 2):
                        v.conv(fb + (f"Conv_{ci - 1}",), f"{tb}.conv{ci}")
                        v.bn(fb + (f"BatchNorm_{ci - 1}",), f"{tb}.bn{ci}")
            for i in range(out_b):
                for j in range(s):
                    base = f"{tmod}.fuse_layers.{i}.{j}"
                    if i < j:
                        v.conv(fmod + (f"fuse{i}_{j}_conv",), f"{base}.0")
                        v.bn(fmod + (f"fuse{i}_{j}_bn",), f"{base}.1")
                    elif i > j:
                        for k in range(i - j - 1):
                            v.conv(fmod + (f"fuse{i}_{j}_down{k}_conv",),
                                   f"{base}.{k}.0")
                            v.bn(fmod + (f"fuse{i}_{j}_down{k}_bn",),
                                 f"{base}.{k}.1")
                        v.conv(fmod + (f"fuse{i}_{j}_final_conv",),
                               f"{base}.{i - j - 1}.0")
                        v.bn(fmod + (f"fuse{i}_{j}_final_bn",),
                             f"{base}.{i - j - 1}.1")
    v.conv(fp + ("final_layer",), tp + "final_layer")
    v.raw(fp + ("final_layer", "bias"), tp + "final_layer.bias")


def _walk_conv_bn_tree(v, tree: Dict, fp: Tuple[str, ...], tp: str) -> None:
    """The truncated Inception (``_walk_conv_bn_tree`` :361-379): every
    ``<prefix>/conv`` and ``<prefix>/bn`` pair maps by its dotted path."""
    for k, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if k == "conv" and "kernel" in sub:
            v.conv(fp + (k,), tp + k)
        elif k == "bn" and "scale" in sub:
            v.bn(fp + (k,), tp + k)
        else:
            _walk_conv_bn_tree(v, sub, fp + (k,), f"{tp}{k}.")


def _walk_token_head(v, params: Dict) -> None:
    """The 128-token head (``_walk_token_head`` :321-331): the conv
    reduction, and the flax ``head`` subtree's mask token, regressor
    (``regressor.0``) and plain pyramid, beside the backbone."""
    v.conv(("conv1x1_channel_reduction",), "conv1x1_channel_reduction")
    v.raw(("head", "mask_token"), "mask_token")
    v.dense(("head", "regressor"), "regressor.0")
    depth = _pyramid_depth(params.get("head", {}).get("transformer", {}))
    _walk_pyramid(v, depth, fp=("head", "transformer"))


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


def state_dict_from_flax(params: Dict, batch_stats: Optional[Dict] = None,
                         coarse: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncoderTransformer`` (``coarse``:
    ``EncoderTransformerCoarse``) (params, batch_stats) trees as a
    reference-keyed state_dict of CPU tensors; the pyramid depth is read
    from the tree.  Subtrees absent from ``params`` are skipped, so a tree
    holding only ``main_encoder`` or ``transformer`` gives that part's
    keys.  The sinusoidal PE and the mean template are deterministic and
    not part of it."""
    e = _Exporter(params, batch_stats)
    _walk_resnet(e)
    e.conv(("conv1x1_channel_reduction",), "conv1x1_channel_reduction")
    e.raw(("mask_token",), "mask_token")
    e.dense(("regressor",), "regressor")
    _walk_pyramid(e, _pyramid_depth(params.get("transformer", {})), coarse)
    return _tensors(e.out)


def hrnet_state_dict_from_flax(params: Dict,
                               batch_stats: Optional[Dict] = None
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncoderTransformerHRNet`` trees as the
    reference-keyed state_dict (``export_torch_hrnet_encoder``); a tree
    holding only ``main_encoder`` gives the HRNet's keys."""
    e = _Exporter(params, batch_stats)
    _walk_hrnet(e, ("main_encoder",), "main_encoder.")
    _walk_token_head(e, params)
    return _tensors(e.out)


def inception_state_dict_from_flax(params: Dict,
                                   batch_stats: Optional[Dict] = None
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``EncoderTransformerInception`` trees as the
    reference-keyed state_dict (``export_torch_inception_encoder``)."""
    e = _Exporter(params, batch_stats)
    _walk_conv_bn_tree(e, params.get("main_encoder", {}), ("main_encoder",),
                       "main_encoder.")
    _walk_token_head(e, params)
    return _tensors(e.out)


def vit_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ViT`` params as the reference-keyed state_dict
    (``export_torch_vit``, ``_walk_vit`` :333-341): ``patch_to_embedding``,
    ``cls_token``, ``pos_embedding``, ``head.0`` and the pyramid, whose
    depth is read from the tree."""
    e = _Exporter(params, None)
    e.dense(("patch_to_embedding",), "patch_to_embedding")
    e.raw(("cls_token",), "cls_token")
    e.raw(("pos_embedding",), "pos_embedding")
    e.dense(("head",), "head.0")
    _walk_pyramid(e, _pyramid_depth(params.get("transformer", {})))
    return _tensors(e.out)


def h3dw_state_dict_from_flax(params: Dict,
                              batch_stats: Optional[Dict] = None
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``H3DWEncoder`` trees, or ``H3DWJointsEncoder``'s
    (the encoder under its ``h3dw`` scope), as the reference-keyed
    state_dict (``export_torch_h3dw``, ``_walk_h3dw`` :313-319): the
    backbone (flax ``ResNet_0``) under ``main_encoder.``, ``fc2`` as
    ``feat_encoder.1``, ``regressor.0``."""
    if "h3dw" in params:
        params = params["h3dw"]
        batch_stats = (batch_stats or {}).get("h3dw", {})
    e = _Exporter(params, batch_stats)
    _walk_resnet(e, ("ResNet_0",))
    e.dense(("fc2",), "feat_encoder.1")
    e.dense(("regressor",), "regressor.0")
    return _tensors(e.out)


def yunqian_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``YunqianTransformer`` params in the reference's
    models/vit.py layout: ``transformer.layers.{i}.0.fn`` (the attention),
    ``transformer.layers.{i}.1.fn.net.{0,3}`` (the feed-forward),
    ``mlp_head.{0,1}`` (LayerNorm, Linear)."""
    e = _Exporter(params, None)
    depth = sum(1 for k in params if k.startswith("attn_"))
    for i in range(depth):
        L = f"transformer.layers.{i}"
        e.dense((f"attn_{i}", "to_qkv"), f"{L}.0.fn.to_qkv")
        e.dense((f"attn_{i}", "to_out"), f"{L}.0.fn.to_out.0")
        e.dense((f"ff_{i}_1",), f"{L}.1.fn.net.0")
        e.dense((f"ff_{i}_2",), f"{L}.1.fn.net.3")
    e.ln(("head_norm",), "mlp_head.0")
    e.dense(("head",), "mlp_head.1")
    return _tensors(e.out)


def truncated_resnet_state_dict_from_flax(
        params: Dict, batch_stats: Optional[Dict] = None
        ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``TruncatedResNet`` trees in torchvision's key
    layout (``conv1``, ``bn1``, ``layer{1,2}.*``)."""
    e = _Exporter(params, batch_stats)
    _walk_resnet(e, (), "")
    return _tensors(e.out)


def spade_state_dict_from_flax(params: Dict,
                               batch_stats: Optional[Dict] = None
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SPADE`` trees in the reference's
    models/helper/spatial_norm.py layout: ``mlp_shared.0``,
    ``mlp_gamma``, ``mlp_beta`` and, for the batch norm, the running
    statistics of ``param_free_norm``."""
    e = _Exporter(params, batch_stats)
    for flax_name, torch_name in (("mlp_shared", "mlp_shared.0"),
                                  ("mlp_gamma", "mlp_gamma"),
                                  ("mlp_beta", "mlp_beta")):
        e.conv((flax_name,), torch_name)
        e.raw((flax_name, "bias"), torch_name + ".bias")
    e.bn(("param_free_norm",), "param_free_norm")
    return _tensors(e.out)


def motion_discriminator_state_dict_from_flax(
        params: Dict, batch_stats: Optional[Dict] = None
        ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MotionDiscriminator`` trees as the port's
    state_dict: each flax ``GRUCell_{k}`` (Denses ``ir``, ``iz``, ``in``
    with biases, ``hr``, ``hz`` without, ``hn`` with) as torch's
    ``gru.*_l{k}``, gates stacked [r; z; n]: ``weight_ih = [ir; iz; in]``,
    ``bias_ih = [b_ir; b_iz; b_in]``, ``weight_hh = [hr; hz; hn]``,
    ``bias_hh = [0; 0; b_hn]`` (torch's n gate multiplies ``W_hn h +
    b_hn`` by r, as flax's does); the attention pooling's Denses as
    ``attention.attention.{0,3,...}`` (Linear, activation, dropout a
    layer), ``fc``, and under spectral norm the power iteration's
    ``fc_u`` [1, out] and ``fc_sigma``."""
    e = _Exporter(params, None)
    layers = sorted(int(k.split("_")[1]) for k in params
                    if k.startswith("GRUCell_"))
    for k in layers:
        cell = params[f"GRUCell_{k}"]
        kern = {g: np.asarray(cell[g]["kernel"]).T for g in
                ("ir", "iz", "in", "hr", "hz", "hn")}
        e.out[f"gru.weight_ih_l{k}"] = np.concatenate(
            [kern["ir"], kern["iz"], kern["in"]])
        e.out[f"gru.weight_hh_l{k}"] = np.concatenate(
            [kern["hr"], kern["hz"], kern["hn"]])
        e.out[f"gru.bias_ih_l{k}"] = np.concatenate(
            [np.asarray(cell[g]["bias"]) for g in ("ir", "iz", "in")])
        b_hn = np.asarray(cell["hn"]["bias"])
        e.out[f"gru.bias_hh_l{k}"] = np.concatenate(
            [np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
    attn = params.get("attention", {})
    hidden = sorted(int(k.split("_")[1]) for k in attn
                    if k.startswith("attn_") and k != "attn_out")
    for j in hidden:
        e.dense(("attention", f"attn_{j}"), f"attention.attention.{3 * j}")
    if "attn_out" in attn:
        e.dense(("attention", "attn_out"),
                f"attention.attention.{3 * len(hidden)}")
    e.dense(("fc",), "fc")
    sn = (batch_stats or {}).get("SpectralNorm_0", {})
    if sn:
        e.out["fc_u"] = np.asarray(sn["fc/kernel/u"])
        e.out["fc_sigma"] = np.asarray(sn["fc/kernel/sigma"])
    return _tensors(e.out)


# ----------------------------------------------------------------------
# The flax direction: a reference-keyed state_dict as the JAX package's
# trees (the counterpart of torch_import.import_torch_*, :381-464, 616).
# ----------------------------------------------------------------------

class _Importer:
    """Visitor that writes a torch-keyed state_dict into nested numpy
    trees under flax's names, through the same walks as ``_Exporter``;
    what the state_dict lacks is skipped."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self.params: Dict = {}
        self.batch_stats: Dict = {}

    @staticmethod
    def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = np.ascontiguousarray(value)

    def has(self, flax_path, torch_name: Optional[str] = None) -> bool:
        return torch_name is not None and torch_name + ".weight" in self.sd

    def is_group_norm(self, flax_path, torch_name) -> bool:
        return (torch_name + ".weight" in self.sd
                and torch_name + ".running_mean" not in self.sd)

    def block_norm(self, fb, i: int, torch_name) -> Tuple[str, ...]:
        return fb + ((f"_GN_{i}",) if self.is_group_norm(fb, torch_name)
                     else (f"BatchNorm_{i}",))

    def conv(self, flax_path, torch_name):
        w = self.sd.get(torch_name + ".weight")
        if w is not None:
            self._set(self.params, flax_path + ("kernel",),
                      np.transpose(w, (2, 3, 1, 0)))

    def bn(self, flax_path, torch_name):
        for leaf, suffix, tree in (("scale", ".weight", self.params),
                                   ("bias", ".bias", self.params),
                                   ("mean", ".running_mean", self.batch_stats),
                                   ("var", ".running_var", self.batch_stats)):
            v = self.sd.get(torch_name + suffix)
            if v is not None:
                self._set(tree, flax_path + (leaf,), v)

    def dense(self, flax_path, torch_name):
        w = self.sd.get(torch_name + ".weight")
        if w is not None:
            self._set(self.params, flax_path + ("kernel",), w.T)
        b = self.sd.get(torch_name + ".bias")
        if b is not None:
            self._set(self.params, flax_path + ("bias",), b)

    def ln(self, flax_path, torch_name):
        for leaf, suffix in (("scale", ".weight"), ("bias", ".bias")):
            v = self.sd.get(torch_name + suffix)
            if v is not None:
                self._set(self.params, flax_path + (leaf,), v)

    def raw(self, flax_path, torch_name):
        v = self.sd.get(torch_name)
        if v is not None:
            self._set(self.params, flax_path, v)


def _layers_depth(sd: Dict, prefix: str = "transformer.layers.") -> int:
    """The pyramid depth of a state_dict, from its layer keys (as the JAX
    package's ``import_torch_auto`` infers it)."""
    return 1 + max((int(k[len(prefix):].split(".")[0]) for k in sd
                    if k.startswith(prefix)), default=-1)


def _conv_bn_keys(imp: _Importer, fp: Tuple[str, ...], tp: str) -> None:
    """The inverse of ``_walk_conv_bn_tree``: every ``<path>.conv`` and
    ``<path>.bn`` under ``tp`` by its dotted path."""
    for key in imp.sd:
        if not key.startswith(tp) or not key.endswith(".weight"):
            continue
        parts = tuple(key[len(tp):-len(".weight")].split("."))
        if parts[-1] == "conv":
            imp.conv(fp + parts, key[:-len(".weight")])
        elif parts[-1] == "bn":
            imp.bn(fp + parts, key[:-len(".weight")])


def _motion_discriminator_trees(imp: _Importer) -> None:
    """The inverse of ``motion_discriminator_state_dict_from_flax``: torch's
    stacked [r; z; n] GRU gates as flax's per-gate Denses.  The r and z
    biases fold, ``ir.b = b_ih_r + b_hh_r`` (the JAX package's
    ``import_torch_motion_discriminator``), ``in.b = b_ih_n``, ``hn.b =
    b_hh_n``: exact, since r and z apply sigmoid(Wx + b_ih + Uh + b_hh)."""
    sd = imp.sd
    layer = 0
    while f"gru.weight_ih_l{layer}" in sd:
        w_ih, w_hh = sd[f"gru.weight_ih_l{layer}"], sd[f"gru.weight_hh_l{layer}"]
        b_ih, b_hh = sd[f"gru.bias_ih_l{layer}"], sd[f"gru.bias_hh_l{layer}"]
        h = w_hh.shape[1]
        cell = ("GRUCell_%d" % layer,)
        for i, gate in enumerate(("r", "z", "n")):
            rows = slice(i * h, (i + 1) * h)
            imp._set(imp.params, cell + (f"i{gate}", "kernel"), w_ih[rows].T)
            imp._set(imp.params, cell + (f"h{gate}", "kernel"), w_hh[rows].T)
            if gate == "n":
                imp._set(imp.params, cell + ("in", "bias"), b_ih[rows])
                imp._set(imp.params, cell + ("hn", "bias"), b_hh[rows])
            else:
                imp._set(imp.params, cell + (f"i{gate}", "bias"),
                         b_ih[rows] + b_hh[rows])
        layer += 1
    linears = sorted(int(k.split(".")[2]) for k in sd
                     if k.startswith("attention.attention.")
                     and k.endswith(".weight"))
    for j, idx in enumerate(linears):
        name = "attn_out" if j == len(linears) - 1 else f"attn_{j}"
        imp.dense(("attention", name), f"attention.attention.{idx}")
    imp.dense(("fc",), "fc")
    if "fc_u" in sd:
        imp.batch_stats["SpectralNorm_0"] = {
            "fc/kernel/u": np.ascontiguousarray(sd["fc_u"]),
            "fc/kernel/sigma": np.ascontiguousarray(sd["fc_sigma"])}


FLAX_NETS = ("reg_transformer", "reg_transformer_coarse", "backbone_hrnet",
             "backbone_incepv3", "frankmocap", "ViT", "ViP",
             "motion_discriminator", "resnet", "hrnet", "inception",
             "yunqian", "spade")


def flax_from_state_dict(net: str, sd: Dict) -> Dict[str, Dict]:
    """A reference-keyed state_dict of ``net`` as the JAX package's trees:
    ``{"params", "batch_stats", "constants"}`` of numpy arrays under
    flax's names, the inverse of the ``*_state_dict_from_flax`` maps
    above (and the counterpart of ``torch_import.import_torch_*``).
    ``net`` is a ``--net`` name, ``motion_discriminator``, ``yunqian``,
    ``spade``, or a bare backbone (``resnet``, also the truncated trunk;
    ``hrnet``; ``inception``).  ``ViP``'s frozen ``mains.{i}.w`` land in
    ``constants``; the BN step counters and the positional-encoding
    buffer have no flax counterpart and are dropped."""
    if net not in FLAX_NETS:
        raise ValueError(f"no flax interchange for {net!r}; expected one "
                         f"of {', '.join(FLAX_NETS)}")
    sd = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                        else v) for k, v in sd.get("state_dict", sd).items()}
    imp = _Importer(sd)
    constants: Dict = {}
    depth = _layers_depth(sd)
    if net in ("reg_transformer", "reg_transformer_coarse"):
        _walk_resnet(imp)
        imp.conv(("conv1x1_channel_reduction",), "conv1x1_channel_reduction")
        imp.raw(("mask_token",), "mask_token")
        imp.dense(("regressor",), "regressor")
        _walk_pyramid(imp, depth, net == "reg_transformer_coarse")
    elif net in ("backbone_hrnet", "backbone_incepv3"):
        if net == "backbone_hrnet":
            _walk_hrnet(imp, ("main_encoder",), "main_encoder.")
        else:
            _conv_bn_keys(imp, ("main_encoder",), "main_encoder.")
        imp.conv(("conv1x1_channel_reduction",), "conv1x1_channel_reduction")
        imp.raw(("head", "mask_token"), "mask_token")
        imp.dense(("head", "regressor"), "regressor.0")
        _walk_pyramid(imp, depth, fp=("head", "transformer"))
    elif net == "ViT":
        imp.dense(("patch_to_embedding",), "patch_to_embedding")
        imp.raw(("cls_token",), "cls_token")
        imp.raw(("pos_embedding",), "pos_embedding")
        imp.dense(("head",), "head.0")
        _walk_pyramid(imp, depth)
    elif net == "ViP":
        vip_depth = _layers_depth(sd, "mains.")
        _walk_vip(imp, vip_depth)
        for i in range(vip_depth):
            if f"mains.{i}.w" in sd:
                constants[f"block_{i}"] = {
                    "w": np.ascontiguousarray(sd[f"mains.{i}.w"])}
    elif net == "frankmocap":
        _walk_resnet(imp, ("ResNet_0",))
        imp.dense(("fc2",), "feat_encoder.1")
        imp.dense(("regressor",), "regressor.0")
    elif net == "motion_discriminator":
        _motion_discriminator_trees(imp)
    elif net == "resnet":
        _walk_resnet(imp, (), "")
    elif net == "hrnet":
        _walk_hrnet(imp, (), "")
    elif net == "inception":
        _conv_bn_keys(imp, (), "")
    elif net == "yunqian":
        for i in range(depth):
            L = f"transformer.layers.{i}"
            imp.dense((f"attn_{i}", "to_qkv"), f"{L}.0.fn.to_qkv")
            imp.dense((f"attn_{i}", "to_out"), f"{L}.0.fn.to_out.0")
            imp.dense((f"ff_{i}_1",), f"{L}.1.fn.net.0")
            imp.dense((f"ff_{i}_2",), f"{L}.1.fn.net.3")
        imp.ln(("head_norm",), "mlp_head.0")
        imp.dense(("head",), "mlp_head.1")
    else:   # spade
        for flax_name, torch_name in (("mlp_shared", "mlp_shared.0"),
                                      ("mlp_gamma", "mlp_gamma"),
                                      ("mlp_beta", "mlp_beta")):
            imp.conv((flax_name,), torch_name)
            imp.raw((flax_name, "bias"), torch_name + ".bias")
        imp.bn(("param_free_norm",), "param_free_norm")
    return {"params": imp.params, "batch_stats": imp.batch_stats,
            "constants": constants}
