"""The whole-image ViT regressor, ``--net ViT`` (port of
``scat_tpu/models/vit.py:24-122``; reference
models/vision_transformer.py:103-153), and ``YunqianTransformer``
(reference models/vit.py:71-101).

ViT: NCHW crop -> p x p patches flattened in the reference's
``(p1 p2 c)`` order (einops ``b c (h p1) (w p2) -> b (h w) (p1 p2 c)``),
tokens row-major -> ``patch_to_embedding`` -> cls token at position 0 ->
+ ``pos_embedding`` -> emb dropout -> the pyramid transformer (dim ->
dim/2 -> dim/4 -> 3) on the plain attention, as the JAX package builds
it (no ``use_pallas``) -> the tokens' mean, float32 -> ``iteration``
refinements ``pred += head(cat(feat, pred))`` from the mean template's
first ``num_classes`` entries.  No root-centring.  ``forward`` returns
``(pred [B,num_classes], feat [B,3])``.  Keys: ``patch_to_embedding``,
``cls_token``, ``pos_embedding``, ``transformer.layers.*`` (the
pyramid's), ``head.0``.  Over a ``seq`` mesh axis
(``set_seq_parallel``; the JAX package's ``shard_tokens`` anchors,
``vit.py:68-75``) each rank runs its slice of the tokens, the attentions
gather K and V over the axis, and the tokens' mean sums there.

Compute dtype, as in the JAX package: ``patch_to_embedding`` and the
transformer's Linear layers compute in the compute dtype
(``set_compute_dtype``: autocast over float32 parameters;
``cast_compute``: stored weights), ``cls_token`` and ``pos_embedding``
are float32, so the residual stream into the first layer is float32;
the LayerNorms and the head are float32.

Dropout (``dropout`` after each attention, ``emb_dropout`` on the
embedded tokens; 0 by default) applies in training only, with keep-masks
drawn by ``train_inputs`` from the train state's generator, as ViP's.

YunqianTransformer: ``depth`` layers of ``Residual(Attention)`` and
``Residual(FeedForward)`` with no PreNorm (the reference defines PreNorm
and never applies it), the attention scaled by ``dim**-0.5``, then
LayerNorm + Linear to ``out_dim``.  Keys:
``transformer.layers.{i}.0.fn.{to_qkv,to_out.0}``,
``transformer.layers.{i}.1.fn.net.{0,3}``, ``mlp_head.{0,1}``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from scat_tpu_torch.models.transformer import (LN_EPS, Attention, Residual,
                                               PyramidTransformer, dropout)
from scat_tpu_torch.ops import widen
from scat_tpu_torch.parallel.sharding_rules import shard_tokens, token_mean


class ViT(nn.Module):
    """reference vision_transformer.py:103-153."""

    def __init__(self, mean_params: torch.Tensor, image_size: int = 224,
                 patch_size: int = 16, num_classes: int = 66,
                 dim: int = 256, depth: int = 3, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, iteration: int = 1):
        super().__init__()
        self.patch_size, self.iteration = patch_size, iteration
        self.dropout, self.emb_dropout = dropout, emb_dropout
        self.out_dim = num_classes
        self.tokens = (image_size // patch_size) ** 2 + 1  # with the cls
        self.compute_dtype = torch.float32
        self.patch_to_embedding = nn.Linear(3 * patch_size ** 2, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, self.tokens, dim))
        self.transformer = PyramidTransformer(
            dim=dim, depth=depth, heads=heads, dim_head=dim_head,
            dropout=dropout)
        # the pyramid ends 3 wide: Linear(3 + num_classes -> num_classes)
        self.head = nn.Sequential(nn.Linear(3 + num_classes, num_classes))
        self.register_buffer(
            "mean_params", torch.as_tensor(mean_params, dtype=torch.float32)
            .reshape(-1)[:num_classes].clone(), persistent=False)
        self.sp = None

    def set_seq_parallel(self, sp) -> "ViT":
        """Split the token stream over a ``seq`` axis
        (``parallel.sharding_rules.SeqParallel``, None for none): each
        rank runs its tokens, the attentions gather K and V, and the
        tokens' mean sums over the axis (JAX ``vit.py:68-75``)."""
        self.sp = None if sp is None else sp.of_tokens(self.tokens)
        for m in self.transformer.modules():
            if hasattr(m, "sp"):
                m.sp = self.sp
        return self

    def set_compute_dtype(self, dtype: torch.dtype) -> "ViT":
        """Compute the patch embedding and the transformer in ``dtype``
        under autocast; the parameters stay float32 (training)."""
        self.compute_dtype = dtype
        return self

    def cast_compute(self, dtype: torch.dtype) -> "ViT":
        """Store the weights of the patch embedding and the transformer's
        Linear layers in ``dtype`` (serving); the LayerNorms, the cls
        token, the position embedding and the head stay float32."""
        for m in (self.patch_to_embedding, *self.transformer.modules()):
            if isinstance(m, nn.Linear):
                m.to(dtype)
        self.compute_dtype = dtype
        return self

    def train_inputs(self, batch_size: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> dict:
        """The random inputs of one training forward: the keep-masks of
        the emb dropout [B,T,dim] and of each attention's output
        [B,T,dim_i], drawn from ``generator`` (on its device, else on
        ``device``); none where the rate is 0."""
        if generator is not None:
            device = generator.device
        out = {}

        def keep(width, rate):
            return torch.rand((batch_size, self.tokens, width),
                              generator=generator, device=device) < 1 - rate
        if self.emb_dropout > 0:
            out["emb_mask"] = keep(self.transformer.dims[0],
                                   self.emb_dropout)
        if self.dropout > 0:
            out["dropout_masks"] = [keep(d, self.dropout)
                                    for d in self.transformer.dims]
        return out

    def forward(self, img: torch.Tensor,
                emb_mask: Optional[torch.Tensor] = None,
                dropout_masks: Optional[list] = None):
        """``img`` NCHW crops; ``emb_mask``, ``dropout_masks``: the
        keep-masks of ``train_inputs`` (drawn here from the global
        generator when omitted in training)."""
        b, c, height, width = img.shape
        p = self.patch_size
        if self.training:
            drawn = self.train_inputs(b, device=img.device)
            emb_mask = drawn.get("emb_mask") if emb_mask is None \
                else emb_mask
            dropout_masks = drawn.get("dropout_masks") \
                if dropout_masks is None else dropout_masks
        else:
            emb_mask = dropout_masks = None
        on = (self.compute_dtype != torch.float32 and
              self.patch_to_embedding.weight.dtype == torch.float32)
        with torch.autocast(img.device.type, dtype=self.compute_dtype,
                            enabled=on):
            # b c (h p1) (w p2) -> b (h w) (p1 p2 c)
            patches = img.reshape(b, c, height // p, p, width // p, p)
            patches = patches.permute(0, 2, 4, 3, 5, 1).reshape(
                b, -1, p * p * c)
            x = self.patch_to_embedding(
                patches.to(self.patch_to_embedding.weight.dtype))
            # the float32 cls token and position embedding promote the
            # stream to float32, as in the JAX package
            x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
            x = x + self.pos_embedding
            if self.sp is not None:
                # this rank's tokens, and of the masks drawn for all
                x = shard_tokens(x, self.sp)
                if emb_mask is not None:
                    emb_mask = shard_tokens(emb_mask, self.sp)
                if dropout_masks is not None:
                    dropout_masks = [shard_tokens(m, self.sp)
                                     for m in dropout_masks]
            x = dropout(x, emb_mask, self.emb_dropout)
            x = self.transformer(x, dropout_masks)
            feat = widen(token_mean(x, self.sp, self.tokens))
        pred = self.mean_params.expand(b, -1)
        for _ in range(self.iteration):
            pred = pred + self.head(torch.cat([feat, pred], dim=1))
        return pred, feat


class _YunqianFeedForward(nn.Module):
    """Linear-GELU-Dropout-Linear-Dropout (keys ``net.0``, ``net.3``);
    the dropouts are 0, as the JAX package runs it."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _YunqianBlocks(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(Attention(dim, heads=heads, dim_head=dim_head,
                               scale_override=dim ** -0.5)),
            Residual(_YunqianFeedForward(dim, mlp_dim))])
            for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = ff(attn(x))
        return x


class YunqianTransformer(nn.Module):
    """The plain (non-pyramid) transformer + LayerNorm/Linear head to
    ``out_dim`` (JAX ``vit.py:84-122``; reference models/vit.py:71-101),
    float32; [B,N,dim] -> [B,N,out_dim]."""

    def __init__(self, dim: int = 256, depth: int = 3, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 512, out_dim: int = 61):
        super().__init__()
        self.transformer = _YunqianBlocks(dim, depth, heads, dim_head,
                                          mlp_dim)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=LN_EPS),
                                      nn.Linear(dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp_head(self.transformer(x))
