"""The encoder heads (port of ``scat_tpu/models/hand_net.py:40-218,
247-376``; reference hand_net.py:87-398): backbone -> token transformer
-> regressor.

The flagship ``--net reg_transformer`` (``EncoderTransformer``, reference
hand_net.py:315-398):
  resnet 5-tuple -> 1x1 conv on x2 (512 -> 21 channels on resnet50) ->
  21 tokens, token i = channel i's map flattened row-major -> sinusoidal
  PE -> in training, random token masking with the learned mask token ->
  pyramid transformer -> [B,63] offsets -> mean + offsets -> ``iteration``
  refinements ``pred += Linear(1024+66 -> 66)(cat(feat, pred))`` ->
  root-centring on joint index 1.  With ``pl_reg`` the forward also
  returns the path-length probe d(sum feat_out)/d(feat_visual).
  ``forward`` returns ``(pred [B,66], feat_visual [B,21,H/8,W/8])``, plus
  ``pl_grad`` (the shape of feat_visual) when ``pl_reg``.

The coarse head ``--net reg_transformer_coarse``
(``EncoderTransformerCoarse``, reference hand_net.py:216-311): the same
tokens through ``PyramidTransformerAttn``, no refinement loop, the
camera from ``Linear(1024+3 -> 3)(cat(feat, pred[:, :3]))``, root-centring;
``forward`` returns ``(pred, feat_visual, attn[, pl_grad])``, attn the
last layer's softmax [B,H,21,21] from the plain attention path.  It is
BatchNorm only and takes no kernel, as in the JAX package.

The 128-token heads ``--net backbone_hrnet`` and ``backbone_incepv3``
(``EncoderTransformerHRNet``, ``EncoderTransformerInception``, reference
hand_net.py:87-213): HRNet-W24's 56x56x128 map read as 512 x 28x28, or
Inception-v3's 768 x 12x12 read as 192 x 24x24 (``_reinterpret_channels``)
-> 3x3 stride-2 conv to 128 channels -> 128 tokens (196 wide at 224 px)
-> PE, masking, the plain pyramid transformer -> the tokens' mean [B,3]
-> ``iteration`` refinements ``pred += Linear(3+61 -> 61)`` from the
61-dim mean MANO parameters.  They return the bare [B,61] tensor.  The
reference declares that Linear 196+61 wide, a shape it never ran; flax
infers 3+61, and so does the port.  ``use_kernel`` routes their attention
through the kernels (the JAX package's ``use_pallas``).

Images and feature maps are NCHW, as in the reference torch model whose
key layout the modules keep.

Compute dtype, and where bf16 rounding happens.  The JAX package keeps
every parameter in float32 and computes the backbone, the conv and the
transformer's Dense layers in bf16; BatchNorm (or GroupNorm) and
LayerNorm compute in float32 from float32 parameters and statistics (the
BN or GN output is rounded to bf16, the LN output is rounded by the
Dense it feeds); the regressor is float32.  The port places the
rounding at the same points in two ways:
  * ``set_compute_dtype(dtype)`` (training): parameters stay float32 and
    the backbone, conv and transformer run under ``torch.autocast``, which
    rounds the inputs and weights of every convolution and Linear to
    ``dtype``; BatchNorm takes the bf16 activation with its float32
    parameters and statistics, GroupNorm and LayerNorm run in float32;
  * ``cast_compute(dtype)`` (serving): the weights of the backbone, conv
    and transformer are stored in ``dtype`` once, the BatchNorm,
    GroupNorm and LayerNorm modules stay float32.
Either way the transformer output and the backbone feature are cast to
float32 before the regressor, which runs outside autocast.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from scat_tpu_torch.models import mano as mano_lib
from scat_tpu_torch.models import resnet as resnet_lib
from scat_tpu_torch.ops import widen
from scat_tpu_torch.models.transformer import (
    PyramidTransformer, PyramidTransformerAttn, random_token_mask,
    sinusoidal_position_encoding)
from scat_tpu_torch.utils.profiling import span

NUM_TOKENS = 21  # one token per joint
_NORM_LAYERS = (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)


class _TokenEncoder(nn.Module):
    """What the heads share: the backbone, the channel-reduction conv
    and the transformer in the compute dtype, the learned mask token, the
    PE table, and token masking in training."""

    def _init_tokens(self, mean_params, num_tokens: int, token_dim: int,
                     mask_rate: float, pos_embed: bool) -> None:
        self.mask_rate = mask_rate
        self.pos_embed = pos_embed
        self.compute_dtype = torch.float32
        self.mask_token = nn.Parameter(torch.zeros(1, 1, token_dim))
        # deterministic tables, not part of the checkpoint
        self.register_buffer(
            "mean_params",
            torch.as_tensor(mean_params, dtype=torch.float32).reshape(-1),
            persistent=False)
        self.register_buffer(
            "pe", sinusoidal_position_encoding(num_tokens, token_dim),
            persistent=False)

    def set_compute_dtype(self, dtype: torch.dtype) -> "_TokenEncoder":
        """Compute the backbone, conv and transformer in ``dtype`` under
        autocast; the parameters stay float32 (training)."""
        self.compute_dtype = dtype
        return self

    def cast_compute(self, dtype: torch.dtype) -> "_TokenEncoder":
        """Store the weights of the backbone, conv and transformer in
        ``dtype`` (serving); the norm layers' parameters and statistics,
        and the regressor, stay float32."""
        for m in (self.main_encoder, self.conv1x1_channel_reduction,
                  self.transformer):
            m.to(dtype)
            for norm in m.modules():
                if isinstance(norm, _NORM_LAYERS):
                    norm.float()
        self.compute_dtype = dtype
        return self

    def _autocast(self, device_type: str):
        # autocast only where the weights are float32 and the compute
        # dtype is lower; cast_compute stores the weights in it instead
        on = (self.compute_dtype != torch.float32 and
              self.conv1x1_channel_reduction.weight.dtype == torch.float32)
        return torch.autocast(device_type, dtype=self.compute_dtype,
                              enabled=on)

    def train_inputs(self, batch_size: int,
                     generator: Optional[torch.Generator] = None) -> dict:
        """The random inputs of one training forward: the token mask's
        flags, drawn from ``generator``, when 0.1 <= mask_rate <= 0.9;
        nothing otherwise.  One mask serves the whole batch."""
        if not 0.1 <= self.mask_rate <= 0.9:
            return {}
        return {"token_mask": random_token_mask(
            self.pe.shape[0], self.mask_rate, generator)}

    def _tokens(self, fmap: torch.Tensor,
                token_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """[B,C,H,W] map -> [B,C,H*W] tokens (token i = channel i's map,
        reference hand_net.py:363-364), PE added, masked in training."""
        feat = fmap.flatten(2)
        if self.pos_embed:
            feat = feat + self.pe.to(feat.dtype)
        if self.training and 0.1 <= self.mask_rate <= 0.9:
            # one mask per forward, shared across the batch (reference
            # hand_net.py:369-373, JAX _mask_tokens); the train step
            # passes flags drawn from its own generator
            if token_mask is None:
                token_mask = random_token_mask(feat.shape[1], self.mask_rate,
                                               device=feat.device)
            feat = torch.where(token_mask[None, :, None],
                               self.mask_token.to(feat.dtype), feat)
        return feat

    def _pl_probe(self, feat_out: torch.Tensor, feat_visual: torch.Tensor):
        """The StyleGAN2-style path-length probe, JAX's nn.vjp of the head
        with a ones cotangent (hand_net.py:117-122): a graph of its own,
        so the loss can differentiate it (double backward).  Where
        autograd records nothing (eval, serving) no probe runs and it is
        None: nothing reads it there."""
        if not (self.pl_reg and torch.is_grad_enabled()):
            return None
        (pl_grad,) = torch.autograd.grad(feat_out.sum(), feat_visual,
                                         create_graph=True)
        return pl_grad


def _root_centred(pred: torch.Tensor) -> torch.Tensor:
    """[B,66] with the joints moved so that joint 1 is the origin
    (reference hand_net.py:389-393)."""
    pred_3d = pred[:, 3:].reshape(-1, NUM_TOKENS, 3)
    pred_3d = pred_3d - pred_3d[:, 1:2]
    return torch.cat([pred[:, :3], pred_3d.reshape(-1, 63)], dim=1)


class EncoderTransformer(_TokenEncoder):
    """Primary SCAT head, ``--net reg_transformer``."""

    def __init__(self, mean_params: torch.Tensor, iteration: int = 3,
                 heads: int = 8, depth: int = 3, mask_rate: float = 0.0,
                 pos_embed: bool = True, pl_reg: bool = False,
                 token_dim: int = 784,
                 backbone: str = "resnet50", norm_layer: str = "batch",
                 use_kernel: bool = False):
        super().__init__()
        self.iteration = iteration
        self.pl_reg = pl_reg
        self.main_encoder = resnet_lib.get_model(backbone,
                                                 norm_layer=norm_layer)
        x2_channels = 128 * self.main_encoder.block.expansion
        self.conv1x1_channel_reduction = nn.Conv2d(
            x2_channels, NUM_TOKENS, 1, bias=False)
        self.transformer = PyramidTransformer(
            dim=token_dim, depth=depth, heads=heads, dim_head=64,
            use_kernel=use_kernel)
        feat_dim = self.main_encoder.fc1.out_features
        self.regressor = nn.Linear(feat_dim + 66, 66)
        self._init_tokens(mean_params, NUM_TOKENS, token_dim, mask_rate,
                          pos_embed)

    def forward(self, x: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None):
        """``token_mask``: bool [21] flags of the tokens to mask (training
        with 0.1 <= mask_rate <= 0.9 only); drawn here when omitted."""
        with self._autocast(x.device.type):
            with span("scat.model.encoder"):
                main_feat, _, x2, _, _ = self.main_encoder(
                    x.to(self.conv1x1_channel_reduction.weight.dtype))
                feat_visual = self.conv1x1_channel_reduction(x2)
            with span("scat.model.tokens"):
                out = self.transformer(self._tokens(feat_visual,
                                                    token_mask))
            feat_out = widen(out.reshape(out.shape[0], -1))  # [B,63]
        pl_grad = self._pl_probe(feat_out, feat_visual)

        mean = self.mean_params.expand(x.shape[0], 66)
        pred = torch.cat([mean[:, :3], mean[:, 3:] + feat_out], dim=1)
        # HMR iterative refinement (reference hand_net.py:385-387)
        for _ in range(self.iteration):
            pred = pred + self.regressor(torch.cat([main_feat, pred], 1))
        pred = _root_centred(pred)
        if self.pl_reg:
            return pred, feat_visual, pl_grad
        return pred, feat_visual


class EncoderTransformerCoarse(_TokenEncoder):
    """The attention-returning head, ``--net reg_transformer_coarse``
    (JAX ``hand_net.py:147-218``).  BatchNorm only: the JAX package's
    coarse head takes no ``norm_layer``, no ``iteration`` and no
    kernel."""

    def __init__(self, mean_params: torch.Tensor, heads: int = 8,
                 depth: int = 3, mask_rate: float = 0.0,
                 pos_embed: bool = True, pl_reg: bool = False,
                 token_dim: int = 784, backbone: str = "resnet50"):
        super().__init__()
        self.pl_reg = pl_reg
        self.main_encoder = resnet_lib.get_model(backbone)
        x2_channels = 128 * self.main_encoder.block.expansion
        self.conv1x1_channel_reduction = nn.Conv2d(
            x2_channels, NUM_TOKENS, 1, bias=False)
        self.transformer = PyramidTransformerAttn(
            dim=token_dim, depth=depth, heads=heads, dim_head=64)
        feat_dim = self.main_encoder.fc1.out_features
        self.regressor = nn.Linear(feat_dim + 3, 3)
        self._init_tokens(mean_params, NUM_TOKENS, token_dim, mask_rate,
                          pos_embed)

    def forward(self, x: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None):
        with self._autocast(x.device.type):
            main_feat, _, x2, _, _ = self.main_encoder(
                x.to(self.conv1x1_channel_reduction.weight.dtype))
            feat_visual = self.conv1x1_channel_reduction(x2)
            out, attn = self.transformer(self._tokens(feat_visual,
                                                      token_mask))
            feat_out = widen(out.reshape(out.shape[0], -1))
        # the probe differentiates feat_out only: attn's cotangent is zero
        pl_grad = self._pl_probe(feat_out, feat_visual)

        mean = self.mean_params.expand(x.shape[0], 66)
        pred = torch.cat([mean[:, :3], mean[:, 3:] + feat_out], dim=1)
        cameras = self.regressor(torch.cat([main_feat, pred[:, :3]], 1))
        pred = _root_centred(pred)
        pred = torch.cat([cameras, pred[:, 3:]], dim=1)
        if self.pl_reg:
            return pred, feat_visual, attn, pl_grad
        return pred, feat_visual, attn


def _reinterpret_channels(fmap: torch.Tensor, new_c: int) -> torch.Tensor:
    """[B,C,H,W] read as [B,new_c,S,S] in NCHW order, the reference's
    ``.view`` (hand_net.py:123 [768,12,12] -> [192,24,24], :187
    [128,56,56] -> [512,28,28]).  ``reshape`` reads the logical NCHW
    order whatever the memory format (a channels_last map is copied)."""
    b, c, h, w = fmap.shape
    total = c * h * w
    if total % new_c:
        raise ValueError(f"{c}x{h}x{w} does not split into {new_c} "
                         "channels")
    side = math.isqrt(total // new_c)
    if side * side * new_c != total:
        raise ValueError(f"non-square reinterpret of {c}x{h}x{w} into "
                         f"{new_c} channels")
    return fmap.reshape(b, new_c, side, side)


def _conv_out(size: int, k: int, stride: int = 1, pad: int = 0) -> int:
    return (size + 2 * pad - k) // stride + 1


class _TokenRegressorHead(_TokenEncoder):
    """The 128-token head of the HRNet and Inception variants (JAX
    ``hand_net.py:262-302``): reinterpret, 3x3 stride-2 conv to 128
    channels, tokens, the plain pyramid transformer, the tokens' mean,
    ``iteration`` refinements of the 61-dim MANO mean.  Its parameters
    sit beside the backbone (``mask_token``, ``regressor.0``,
    ``transformer.layers``), the reference's key layout."""

    out_dim = 61  # MANO parameters, not the 66-dim keypoint contract

    def _init_head(self, mean_params, new_c: int, side: int, pad: int,
                   iteration: int, heads: int, depth: int,
                   mask_rate: float, pos_embed: bool,
                   use_kernel: bool) -> None:
        self.new_c = new_c
        self.iteration = iteration
        self.conv1x1_channel_reduction = nn.Conv2d(
            new_c, 128, 3, stride=2, padding=pad, bias=False)
        token_dim = _conv_out(side, 3, 2, pad) ** 2
        self.transformer = PyramidTransformer(
            dim=token_dim, depth=depth, heads=heads, dim_head=64,
            use_kernel=use_kernel)
        # the pyramid ends in 3 wide: Linear(3 + 61 -> 61)
        self.regressor = nn.Sequential(nn.Linear(3 + 61, 61))
        self._init_tokens(mean_params, 128, token_dim, mask_rate, pos_embed)

    def forward(self, x: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``token_mask``: bool [128] flags (training with 0.1 <=
        mask_rate <= 0.9 only); drawn here when omitted.  Returns the
        [B,61] MANO parameters."""
        with self._autocast(x.device.type):
            fmap = self.main_encoder(
                x.to(self.conv1x1_channel_reduction.weight.dtype))
            fmap = self.conv1x1_channel_reduction(
                _reinterpret_channels(fmap, self.new_c))
            out = self.transformer(self._tokens(fmap, token_mask))
            feat = widen(out.mean(dim=1))  # [B,3]
        pred = self.mean_params.expand(x.shape[0], 61)
        for _ in range(self.iteration):
            pred = pred + self.regressor(torch.cat([feat, pred], 1))
        return pred


class EncoderTransformerHRNet(_TokenRegressorHead):
    """``--net backbone_hrnet`` (JAX ``hand_net.py:305-337``):
    HRNet(c=24, 128 joints) -> 56x56x128 read as 512 x 28x28 -> conv(512
    -> 128, k3 s2 p1) -> 128 tokens x 196 -> the token head."""

    def __init__(self, mean_params: torch.Tensor, iteration: int = 3,
                 heads: int = 8, depth: int = 3, mask_rate: float = 0.0,
                 pos_embed: bool = True, image_size: int = 224,
                 use_kernel: bool = False):
        super().__init__()
        from scat_tpu_torch.models.hrnet import HRNet
        self.main_encoder = HRNet(c=24, nof_joints=128)
        fmap = _conv_out(_conv_out(image_size, 3, 2, 1), 3, 2, 1)
        side = math.isqrt(128 * fmap * fmap // 512)
        self._init_head(mean_params, 512, side, 1, iteration, heads, depth,
                        mask_rate, pos_embed, use_kernel)


class EncoderTransformerInception(_TokenRegressorHead):
    """``--net backbone_incepv3`` (JAX ``hand_net.py:340-372``):
    Inception-v3 through Mixed_6e -> 768 x 12x12 read as 192 x 24x24 ->
    conv(192 -> 128, k3 s2 p3) -> 128 tokens x 196 -> the token head."""

    def __init__(self, mean_params: torch.Tensor, iteration: int = 3,
                 heads: int = 8, depth: int = 3, mask_rate: float = 0.0,
                 pos_embed: bool = True, image_size: int = 224,
                 use_kernel: bool = False):
        super().__init__()
        from scat_tpu_torch.models.inception import Inception3
        self.main_encoder = Inception3()
        # the map's side: Conv2d_1a_3x3, Conv2d_2a_3x3, the first pool,
        # Conv2d_4a_3x3, the second pool, Mixed_6a (the rest keep it)
        s = image_size
        for k, stride in ((3, 2), (3, 1), (3, 2), (3, 1), (3, 2), (3, 2)):
            s = _conv_out(s, k, stride)
        side = math.isqrt(768 * s * s // 192)
        self._init_head(mean_params, 192, side, 3, iteration, heads, depth,
                        mask_rate, pos_embed, use_kernel)


MANO_PARAMS = 61  # camera 3 + pose 48 (global 3 + local 45) + shape 10


class H3DWEncoder(nn.Module):
    """The FrankMocap-style baseline, ``--net frankmocap`` (JAX
    ``hand_net.py:222-244``; reference hand_net.py:28-58): the resnet
    feature -> ReLU -> ``fc2`` (1024) -> ReLU -> a fixed 3-step loop
    ``pred += regressor(cat(feat, pred))`` from the 61-dim mean MANO
    parameters.  ``forward`` returns ``(feat [B,1024], pred [B,61])``.
    Keys: ``main_encoder.*``, ``feat_encoder.1`` (fc2), ``regressor.0``.

    The backbone computes in the compute dtype (``set_compute_dtype``:
    autocast, training; ``cast_compute``: stored weights, serving), its
    BatchNorm in float32; fc2 and the regressor are float32, as flax's
    undtyped Dense layers of the JAX package."""

    out_dim = MANO_PARAMS
    ITERATIONS = 3

    def __init__(self, mean_params: torch.Tensor,
                 backbone: str = "resnet50"):
        super().__init__()
        self.main_encoder = resnet_lib.get_model(backbone)
        self.feat_encoder = nn.Sequential(nn.ReLU(), nn.Linear(1024, 1024),
                                          nn.ReLU())
        self.regressor = nn.Sequential(nn.Linear(1024 + MANO_PARAMS,
                                                 MANO_PARAMS))
        self.compute_dtype = torch.float32
        self.register_buffer(
            "mean_params",
            torch.as_tensor(mean_params, dtype=torch.float32).reshape(-1),
            persistent=False)

    def set_compute_dtype(self, dtype: torch.dtype) -> "H3DWEncoder":
        """Compute the backbone in ``dtype`` under autocast; the
        parameters stay float32 (training)."""
        self.compute_dtype = dtype
        return self

    def cast_compute(self, dtype: torch.dtype) -> "H3DWEncoder":
        """Store the backbone's convolution and fc1 weights in ``dtype``
        (serving); its norms, fc2 and the regressor stay float32."""
        self.main_encoder.to(dtype)
        for norm in self.main_encoder.modules():
            if isinstance(norm, _NORM_LAYERS):
                norm.float()
        self.compute_dtype = dtype
        return self

    def forward(self, x: torch.Tensor):
        """(feat [B,1024], pred [B,61]) of NCHW crops ``x``."""
        on = (self.compute_dtype != torch.float32 and
              self.main_encoder.conv1.weight.dtype == torch.float32)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=on):
            main_feat = self.main_encoder(
                x.to(self.main_encoder.conv1.weight.dtype))[0]
        feat = self.feat_encoder(widen(main_feat))
        pred = self.mean_params.expand(x.shape[0], MANO_PARAMS)
        for _ in range(self.ITERATIONS):
            pred = pred + self.regressor(torch.cat([feat, pred], 1))
        return feat, pred


class H3DWJointsEncoder(H3DWEncoder):
    """``H3DWEncoder`` with the MANO decode in the forward (JAX
    ``hand_net.py:379-404``), so that ``--net frankmocap`` gives the
    66-dim camera + 21x3 joints contract of the keypoint eval step:
    ``rot_pose_beta_to_mesh`` of the parameters, in float32 whatever the
    compute dtype; ``forward`` returns ``(pred66, feat)``.  The keys are
    ``H3DWEncoder``'s (the JAX package's ``h3dw`` scope is no level of the
    reference layout).  The MANO model is ``assets.load_mano()``, moved
    to the input's device at its first forward there."""

    out_dim = 66

    def __init__(self, mean_params: torch.Tensor,
                 backbone: str = "resnet50"):
        super().__init__(mean_params, backbone)
        self.mano = mano_lib.ManoModel.from_data()

    def forward(self, x: torch.Tensor):
        feat, pred = super().forward(x)
        if self.mano.device != pred.device:
            self.mano = self.mano.to(pred.device)
        out = mano_lib.rot_pose_beta_to_mesh(
            self.mano, pred[:, 3:6], pred[:, 6:51], pred[:, 51:61])
        joints = out[:, :NUM_TOKENS].reshape(-1, 63)
        return torch.cat([pred[:, :3], joints], dim=1), feat
