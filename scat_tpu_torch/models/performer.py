"""The Performer regressor, ``--net ViP`` (port of
``scat_tpu/models/performer.py:74-230``; reference
models/vision_performer.py:12-116).

  NCHW crop -> patches of p x p in torch's Unfold order (C, ph, pw),
  tokens row-major -> Linear to emb -> + pos_emb -> cls_token at position
  0 -> ``depth`` pre-LN Performer blocks (FAVOR+ attention over all heads
  at once, then a 4x GELU MLP) -> mean over all tokens -> ``iteration``
  refinements ``pred += head(cat(feat, pred))`` from the mean template.
  No root-centring: ViP predicts joint 1 like every other joint.

The module keeps the reference key layout (``patch_emb``, ``pos_emb``,
``cls_token``, ``head``, ``mains.{i}.{ln1,kqv,proj,ln2,mlp.0,mlp.2}``);
the frozen Gaussian projection ``mains.{i}.w`` [m, emb_s] is a persistent
buffer, as it is a ``requires_grad=False`` parameter in the reference and
a flax ``constants`` variable in the JAX package.  Each head's slice of
the embedding goes through one shared ``kqv`` Linear(emb_s -> 3 emb_s),
split k, q, v in that order.  ``forward`` returns ``(pred [B,66],
feat [B,emb])``.

Compute dtype, as in the JAX package: the Linear layers compute in
bf16 (``set_compute_dtype``: autocast over float32 parameters, training;
``cast_compute``: bf16 weights, serving), the residual stream is float32
(``tok + pos_emb`` promotes), the LayerNorms (eps 1e-6) compute in float32
and the head is float32.  FAVOR+ takes the block's ``kqv`` output as it
is: ``use_kernel`` sends it to ``ops.favor.favor_attention_fused`` (the
CUDA kernels, which read bf16 operands as their float32 values: the JAX
package casts q, k, v to float32 first), otherwise ``favor_attention``
runs in the operands' promoted dtype with autocast off; both return
float32.

Over a ``seq`` mesh axis (``set_seq_parallel``; JAX
``performer.py:129-140, 209``) each rank runs its slice of the tokens;
the blocks take the plain FAVOR+ path there, whose two cross-token
moments, sum_t phi(k) and phi(k)^T v, are summed over the axis, as is
the tokens' mean.  ``embed`` and ``readout`` are the forward's two ends,
around the blocks (``parallel/pipeline.pipeline_apply`` stages the
blocks between them).

Dropout (0.1 after ``proj`` and after the MLP) applies in training only.
Its keep-masks are inputs of the forward (``dropout_masks``), drawn by
``train_inputs`` from the train state's generator, so that a block
recomputed under ``remat`` (``torch.utils.checkpoint``, which restores
the global RNG streams but not an explicit generator) sees the masks its
forward saw.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

# flax's nn.Dropout with its keep-mask given (the pyramid's, shared)
from scat_tpu_torch.models.transformer import dropout as _dropout
from scat_tpu_torch.ops import widen
from scat_tpu_torch.ops.favor import favor_attention, favor_attention_fused
from scat_tpu_torch.parallel.mesh import all_reduce_sum
from scat_tpu_torch.parallel.sharding_rules import shard_tokens, token_mean

LN_EPS = 1e-6
Masks = Tuple[torch.Tensor, torch.Tensor]


class PerformerBlock(nn.Module):
    """Pre-LN Performer block (reference vision_performer.py:12-68)."""

    def __init__(self, emb_s: int, head: int, kernel_ratio: float = 0.5,
                 dp_ratio: float = 0.1, use_kernel: bool = False,
                 favor_precision: str = "highest"):
        super().__init__()
        emb = emb_s * head
        self.emb_s, self.head, self.dp_ratio = emb_s, head, dp_ratio
        self.use_kernel = use_kernel
        self.favor_precision = favor_precision
        self.ln1 = nn.LayerNorm(emb, eps=LN_EPS)
        self.kqv = nn.Linear(emb_s, 3 * emb_s)
        self.proj = nn.Linear(emb, emb)
        self.ln2 = nn.LayerNorm(emb, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(emb, 4 * emb), nn.GELU(),
                                 nn.Linear(4 * emb, emb))
        self.register_buffer(
            "w", torch.randn(int(emb_s * kernel_ratio), emb_s))
        self.sp = None   # a SeqParallel: the block sees its rank's tokens

    def forward(self, x: torch.Tensor,
                masks: Optional[Masks] = None) -> torch.Tensor:
        """``x`` float32 [B,T,emb]; ``masks``: the two dropout keep-masks
        [B,T,emb] (training), or None."""
        b, t, emb = x.shape
        y = self.ln1(x).view(b, t, self.head, self.emb_s)
        # [B,T,H,3e] -> k, q, v as strided [B,H,T,e] views, no copy
        kqv = self.kqv(y.to(self.kqv.weight.dtype)).permute(0, 2, 1, 3)
        k, q, v = kqv.split(self.emb_s, dim=-1)
        if self.sp is not None:
            # the fused kernels take every token; over a seq axis the
            # plain path sums its two moments there, as the JAX package
            # takes its einsum path (performer.py:129-135)
            group = self.sp.group
            attn = favor_attention(q, k, v, self.w, self.favor_precision,
                                   lambda t: all_reduce_sum(t, group))
        elif self.use_kernel:
            attn = favor_attention_fused(q, k, v, self.w)
        else:
            attn = favor_attention(q, k, v, self.w, self.favor_precision)
        attn = attn.transpose(1, 2).reshape(b, t, emb)
        attn = self.proj(attn.to(self.proj.weight.dtype))
        x = x + _dropout(attn, None if masks is None else masks[0],
                         self.dp_ratio)
        y = self.mlp(self.ln2(x).to(self.mlp[0].weight.dtype))
        return x + _dropout(y, None if masks is None else masks[1],
                            self.dp_ratio)


class ViP(nn.Module):
    """Performer regressor, ``--net ViP``."""

    def __init__(self, mean_params: torch.Tensor, out_dim: int = 66,
                 image_pix: int = 224, patch_pix: int = 4, emb_s: int = 128,
                 heads: int = 4, depth: int = 3, kernel_ratio: float = 0.5,
                 dropout: float = 0.1, iteration: int = 1,
                 use_kernel: bool = False, remat: bool = False,
                 favor_precision: str = "highest"):
        super().__init__()
        self.patch_pix, self.iteration = patch_pix, iteration
        self.dropout, self.remat = dropout, remat
        self.tokens = (image_pix // patch_pix) ** 2 + 1   # with cls_token
        self.emb = emb_s * heads
        self.compute_dtype = torch.float32
        self.patch_emb = nn.Linear(3 * patch_pix * patch_pix, self.emb)
        self.pos_emb = nn.Parameter(torch.zeros(1, self.tokens - 1,
                                                self.emb))
        self.cls_token = nn.Parameter(torch.rand(1, 1, self.emb))
        self.mains = nn.ModuleList([
            PerformerBlock(emb_s, heads, kernel_ratio, dropout, use_kernel,
                           favor_precision) for _ in range(depth)])
        self.head = nn.Linear(self.emb + out_dim, out_dim)
        self.register_buffer(
            "mean_params", torch.as_tensor(mean_params, dtype=torch.float32)
            .reshape(-1)[:out_dim].clone(), persistent=False)
        self.sp = None

    def set_seq_parallel(self, sp) -> "ViP":
        """Split the token stream over a ``seq`` axis
        (``parallel.sharding_rules.SeqParallel`` of size > 1; None for
        none): each rank runs its tokens through the blocks, whose
        FAVOR+ moments and the tokens' mean sum over the axis (JAX
        ``performer.py:129-140, 209``)."""
        self.sp = None if sp is None else sp.of_tokens(self.tokens)
        for block in self.mains:
            block.sp = self.sp
        return self

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init (performer.py:74-92, 116-119, 194-200):
        every Linear's weight and bias U(+-1/sqrt(fan_in)) (torch's
        Linear default; flax's lecun-normal drives the normalizer D to
        0/0 at emb_s 128), pos_emb zeros, cls_token U[0,1), each w
        N(0,1), LayerNorms ones and zeros."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    bound = 1.0 / math.sqrt(m.in_features)
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.uniform_(-bound, bound, generator=generator)
                elif isinstance(m, nn.LayerNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, PerformerBlock):
                    m.w.normal_(generator=generator)
            self.pos_emb.zero_()
            self.cls_token.uniform_(0.0, 1.0, generator=generator)

    def set_compute_dtype(self, dtype: torch.dtype) -> "ViP":
        """Compute the Linear layers (but the head) in ``dtype`` under
        autocast; the parameters stay float32 (training)."""
        self.compute_dtype = dtype
        return self

    def cast_compute(self, dtype: torch.dtype) -> "ViP":
        """Store the weights of the Linear layers (but the head) in
        ``dtype`` (serving); the LayerNorms, pos_emb, cls_token, the head
        and the frozen w stay float32."""
        for m in self.modules():
            if isinstance(m, nn.Linear) and m is not self.head:
                m.to(dtype)
        self.compute_dtype = dtype
        return self

    def _autocast(self, device_type: str):
        on = (self.compute_dtype != torch.float32 and
              self.patch_emb.weight.dtype == torch.float32)
        return torch.autocast(device_type, dtype=self.compute_dtype,
                              enabled=on)

    def train_inputs(self, batch_size: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> dict:
        """The random inputs of one training forward: each block's two
        dropout keep-masks [B,T,emb], drawn from ``generator`` (on its
        device, else on ``device``); nothing when dropout is 0."""
        if self.dropout <= 0:
            return {}
        if generator is not None:
            device = generator.device
        shape = (batch_size, self.tokens, self.emb)
        keep = 1.0 - self.dropout
        return {"dropout_masks": [
            tuple(torch.rand(shape, generator=generator, device=device)
                  < keep for _ in range(2)) for _ in self.mains]}

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW crops -> the token stream [B, T, emb] that enters the
        blocks (patches, their embedding, the position embedding, the cls
        token; under a ``seq`` axis, this rank's tokens).  Call it inside
        ``_autocast``, as ``forward`` does."""
        b, c, height, width = x.shape
        p = self.patch_pix
        patches = x.reshape(b, c, height // p, p, width // p, p).permute(
            0, 2, 4, 1, 3, 5).reshape(b, self.tokens - 1, c * p * p)
        tok = self.patch_emb(patches.to(self.patch_emb.weight.dtype))
        tok = tok + self.pos_emb
        tok = torch.cat([self.cls_token.expand(b, -1, -1), tok], dim=1)
        return shard_tokens(tok, self.sp)

    def readout(self, tok: torch.Tensor):
        """The blocks' output -> ``(pred [B,66], feat [B,emb])``: the
        tokens' mean and ``iteration`` refinements from the mean
        template."""
        feat = widen(token_mean(tok, self.sp, self.tokens))
        pred = self.mean_params.expand(tok.shape[0], -1)
        for _ in range(self.iteration):
            pred = pred + self.head(torch.cat([feat, pred], dim=1))
        return pred, feat

    def forward(self, x: torch.Tensor,
                dropout_masks: Optional[Sequence[Masks]] = None):
        """``x`` NCHW crops; ``dropout_masks``: per block, the two keep
        masks of ``train_inputs`` (drawn here from the global generator
        when omitted in training)."""
        b = x.shape[0]
        if self.training and self.dropout > 0 and dropout_masks is None:
            dropout_masks = self.train_inputs(
                b, device=x.device)["dropout_masks"]
        if not self.training:
            dropout_masks = None
        if self.sp is not None and dropout_masks is not None:
            # this rank's tokens of the masks drawn for all
            dropout_masks = [tuple(shard_tokens(m, self.sp) for m in pair)
                             for pair in dropout_masks]
        with self._autocast(x.device.type):
            tok = self.embed(x)
            for i, block in enumerate(self.mains):
                masks = None if dropout_masks is None else dropout_masks[i]
                if self.remat and torch.is_grad_enabled():
                    tok = checkpoint(block, tok, masks, use_reentrant=False)
                else:
                    tok = block(tok, masks)
        return self.readout(tok)
