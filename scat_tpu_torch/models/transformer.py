"""Token-pyramid transformer, the SCAT core regressor (port of
``scat_tpu/models/transformer.py:29-151,193-203``; reference
models/vision_transformer.py:13-101).

Each non-final layer is ``Residual(PreNorm(Attention))`` followed by a
non-residual ``PreNorm(FeedForward)`` that halves the token dim (hidden
``(dim*3)//4``); the final layer is ``Residual(PreNorm(Attention))`` then
a raw ``FeedForward`` to ``out_dim`` 3.  With dim 784 and depth 3 that
is 784 -> 392 -> 196 -> 3.  The module nesting is the reference's, so
the state_dict keys are ``layers.{i}.0.fn.norm``,
``layers.{i}.0.fn.fn.to_qkv``, ``layers.{i}.1.norm`` /
``layers.{i}.1.fn.net.{0,2}`` and, on the final layer,
``layers.{i}.1.net.{0,2}``.

As in the JAX package: LayerNorm eps is flax's 1e-6 (not torch's 1e-5)
and LayerNorm computes in float32 whatever the compute dtype (flax's
``nn.LayerNorm`` without a dtype promotes to float32), GELU is exact,
and the FFN hidden width is ``(dim*3)//4`` (the JAX package's ``mlp_dim``
is ignored there, so the port has none).  Dropout sits where the JAX
package has it, after each attention's ``to_out`` (0 in the reference's
runs; ``--vit_dropout`` for ``--net ViT``), and takes its keep-mask as
an input of the forward (``dropout_masks``), as ViP's does.

``Attention(scale_override=)`` scales the dots by a given factor
instead of ``dim_head**-0.5`` (the reference's models/vit.py scales by
``dim**-0.5``, ``YunqianTransformer``).

``PyramidTransformerAttn`` is the coarse head's variant
(``transformer.py:154-190``; reference vision_transformer_attn.py:88-113):
``x = LN(Attention(x)) + x``, post-norm on the branch, and it returns the
last layer's softmax matrix beside its output.  Its keys are
``layers.{i}.0.to_qkv`` (a bare Attention), ``layers.{i}.1.norm`` (the
post-norm) and ``layers.{i}.2`` as ``layers.{i}.1`` above.  Its attention
is the plain version on every device, as in the JAX package: it returns
P, which the kernels never materialise.  The residual stream after a
post-norm is float32, as flax's LayerNorm output promotes the sum; each
FeedForward rounds its input to its weights' dtype, as flax's Dense does.

``random_token_mask`` is the port of ``transformer.py:206-220``.

Under a mesh (``parallel/sharding_rules.py``): ``tp_group`` set on an
Attention or FeedForward makes it one rank's slice of a Megatron pair
(its heads, its hidden units; the row Linear's output summed over the
group before its bias), and ``sp`` set on an Attention gathers K and V
over the ``seq`` axis, so that its local queries attend to every token.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from scat_tpu_torch.ops import widen
# the plain version of the attention math; the JAX package calls it
# mha_reference (scat_tpu/models/transformer.py:29-46)
from scat_tpu_torch.ops.attention import attention_reference as mha_reference
from scat_tpu_torch.ops.attention import flash_attention
from scat_tpu_torch.parallel.sharding_rules import (gather_tokens, tp_copy,
                                                    tp_reduce)

LN_EPS = 1e-6


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
            rate: float) -> torch.Tensor:
    """flax's ``nn.Dropout`` with its keep-mask given: kept entries scaled
    by 1/(1-rate); no mask, no dropout."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(x, **kw) + x


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x, **kw):
        # LayerNorm in float32 (its parameters stay float32 under either
        # compute-dtype scheme); the output is rounded to the compute dtype
        # for the layer it feeds, as flax's bf16 Dense rounds its input
        return self.fn(self.norm(widen(x)).to(x.dtype), **kw)


class Attention(nn.Module):
    """Multi-head self-attention (reference vision_transformer.py:46-79).
    ``use_kernel`` routes the attention math through the CUDA kernel
    (``ops.attention.flash_attention``; the JAX package's ``use_pallas``),
    otherwise the plain version runs.  ``dropout`` applies to the output
    where ``forward`` is given its keep-mask."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 use_kernel: bool = False, dropout: float = 0.0,
                 scale_override: Optional[float] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.scale = (dim_head ** -0.5 if scale_override is None
                      else float(scale_override))
        self.dropout = dropout
        self.use_kernel = use_kernel
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        # a Sequential for the reference's key ``to_out.0``
        self.to_out = nn.Sequential(nn.Linear(inner, dim))
        self.tp_group = None    # parallel.sharding_rules.shard_transformer
        self.sp = None          # a SeqParallel: the token-split stream

    def forward(self, x: torch.Tensor, return_attn: bool = False,
                keep: Optional[torch.Tensor] = None):
        """``return_attn``: also return the softmax matrix [B,H,N,N],
        from the plain version (the coarse head's path); ``keep``: the
        output's dropout keep-mask [B,N,dim] (training)."""
        b, n, _ = x.shape
        # a float32 residual stream (ViT's first layer) is rounded to the
        # weights' dtype, as flax's Dense rounds its input
        x = x.to(self.to_qkv.weight.dtype)
        if self.tp_group is not None:
            x = tp_copy(x, self.tp_group)
        # [B,N,3,H,Dh] -> three [B,H,N,Dh] views, no copy
        q, k, v = self.to_qkv(x).view(
            b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        attn = None
        if self.sp is not None:
            k = gather_tokens(k, self.sp, self.sp.total)
            v = gather_tokens(v, self.sp, self.sp.total)
        if return_attn:
            out, attn = mha_reference(q, k, v, self.scale, return_attn=True)
        elif self.use_kernel and self.sp is None:
            out = flash_attention(q, k, v, self.scale)
        else:
            out = mha_reference(q, k, v, self.scale)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if self.tp_group is None:
            out = self.to_out(out)
        else:
            lin = self.to_out[0]
            out = tp_reduce(nn.functional.linear(out, lin.weight),
                            self.tp_group)
            out = out + lin.bias.to(out.dtype)
        out = dropout(out, keep, self.dropout)
        return (out, attn) if return_attn else out


class FeedForward(nn.Module):
    """Linear-GELU-Linear; out = dim//2 or ``out_dim`` (reference
    vision_transformer.py:28-44)."""

    def __init__(self, dim: int, hidden_dim: int,
                 out_dim: Optional[int] = None):
        super().__init__()
        out = dim // 2 if out_dim is None else out_dim
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim), nn.GELU(),
                                 nn.Linear(hidden_dim, out))
        self.tp_group = None    # parallel.sharding_rules.shard_transformer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a float32 residual stream (the coarse head's) is rounded to the
        # weights' dtype, as flax's Dense rounds its input
        x = x.to(self.net[0].weight.dtype)
        if self.tp_group is None:
            return self.net(x)
        h = self.net[1](self.net[0](tp_copy(x, self.tp_group)))
        second = self.net[2]
        y = tp_reduce(nn.functional.linear(h, second.weight), self.tp_group)
        return y + second.bias.to(y.dtype)


class PyramidTransformer(nn.Module):
    """The dim-halving pyramid (reference vision_transformer.py:81-101).
    ``dims`` lists each layer's token width; ``dropout`` is its
    attentions' (``forward``'s ``dropout_masks``: one keep-mask
    [B,N,dims[i]] a layer, in training)."""

    def __init__(self, dim: int, depth: int = 3, heads: int = 8,
                 dim_head: int = 64, use_kernel: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList()
        self.dims = []
        for i in range(depth):
            self.dims.append(dim)
            attn = Residual(PreNorm(dim, Attention(
                dim, heads=heads, dim_head=dim_head,
                use_kernel=use_kernel, dropout=dropout)))
            hidden = (dim * 3) // 4
            if i == depth - 1:
                ff = FeedForward(dim, hidden, out_dim=3)
            else:
                ff = PreNorm(dim, FeedForward(dim, hidden))
                dim //= 2
            self.layers.append(nn.ModuleList([attn, ff]))

    def forward(self, x: torch.Tensor,
                dropout_masks: Optional[list] = None) -> torch.Tensor:
        for i, (attn, ff) in enumerate(self.layers):
            keep = None if dropout_masks is None else dropout_masks[i]
            x = ff(attn(x, keep=keep))
        return x


class PostNorm(nn.Module):
    """The post-norm of the coarse head's branch (reference
    vision_transformer_attn.py's PreNormAttn, key ``.norm``): LayerNorm
    in float32, float32 out."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(widen(x))


class PyramidTransformerAttn(nn.Module):
    """The attention-returning pyramid (reference
    vision_transformer_attn.py:88-113): ``forward`` returns ``(x, attn of
    the last layer)``."""

    def __init__(self, dim: int, depth: int = 3, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(depth):
            attn = Attention(dim, heads=heads, dim_head=dim_head)
            hidden = (dim * 3) // 4
            if i == depth - 1:
                ff = FeedForward(dim, hidden, out_dim=3)
            else:
                ff = PreNorm(dim, FeedForward(dim, hidden))
            self.layers.append(nn.ModuleList([attn, PostNorm(dim), ff]))
            if i != depth - 1:
                dim //= 2

    def forward(self, x: torch.Tensor):
        attn = None
        for attention, post, ff in self.layers:
            y, attn = attention(x, return_attn=True)
            x = ff(post(y) + x)
        return x, attn


def random_token_mask(num_tokens: int, mask_rate: float,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """Bool [num_tokens] flags of the tokens to replace with the learned
    mask token: ``int(mask_rate * num_tokens)`` distinct tokens, uniformly
    drawn by ``torch.randperm`` (the JAX package draws them with
    ``jax.random.permutation``, the reference with python's
    ``random.shuffle``; the distributions agree, the bits do not).  Drawn
    on ``generator``'s device, else on ``device``."""
    if generator is not None:
        device = generator.device
    k = int(mask_rate * num_tokens)
    perm = torch.randperm(num_tokens, generator=generator, device=device)
    flags = torch.zeros(num_tokens, dtype=torch.bool, device=perm.device)
    return flags.index_fill_(0, perm[:k], True)


def sinusoidal_position_encoding(max_len: int, d_model: int,
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """[max_len, d_model] sin/cos table (reference hand_net.py:61-77),
    computed in float32 like the JAX package."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-torch.log(torch.tensor(10000.0)) / d_model))
    angles = position * div_term
    pe = torch.zeros(max_len, d_model, dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, : d_model // 2])
    return pe.to(dtype)
