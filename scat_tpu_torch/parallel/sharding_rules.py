"""Tensor and sequence parallelism (port of
``scat_tpu/parallel/sharding_rules.py``).

**Megatron pairs** over the ``model`` axis (JAX :9-20, 49-73): in each
attention the QKV projection ``to_qkv`` is column-parallel and ``to_out``
row-parallel; in each FeedForward the first Linear is column-parallel
and the second row-parallel.  A rank keeps its slice of each pair, the
activation between the two stays split, and one all-reduce a pair (the
row Linear's) rebuilds the replicated stream; the input's gradient is
summed in the backward (Megatron's f and g, ``tp_copy``/``tp_reduce``,
which differentiate twice, so ``--pl_reg`` composes).

``to_qkv``'s output is ``[3, H, Dh]``: a contiguous column split would
hand rank 0 all of Q and half of K, so the attention is split by head:
a rank holds the Q, K and V rows of its ``H/tp`` heads and runs the
attention (the kernels on CUDA) over those heads; ``to_out`` takes the
matching columns.  The FeedForward splits its hidden units.  A pair is
split when its first weight holds ``min_elems`` (1<<16) elements or
more and the heads (the hidden width) divide over the axis, else it stays
replicated, the counterpart of the JAX package's fall-backs.  The other
Linears and the convolutions stay replicated: the same result with more
memory a rank (ROADMAP.md lists it as a deviation: the JAX rules shard
their output dims).  Checkpoints gather the slices back to the global
reference layout (``gather_tp``), so a ``.pth`` saved under any mesh
loads anywhere.

**Sequence parallelism** over the ``seq`` axis (JAX :110-121): the
long-token models split their token stream over the axis
(``token_range``); FAVOR+'s two cross-token moments and the token mean
are summed over the axis (``all_reduce_sum``), and softmax attention
gathers K and V (``gather_tokens``).  ``seq_parallel(mesh)`` is the
axis as a model takes it (``ViP.set_seq_parallel``,
``ViT.set_seq_parallel``); ``seq_axis_size`` and ``shard_tokens`` read
it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from scat_tpu_torch.parallel.mesh import (MODEL_AXIS, SEQ_AXIS, Mesh,
                                          all_reduce_sum)

TP_MIN_ELEMS = 1 << 16


# ---------------------------------------------------------------------
# Megatron's f and g
# ---------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward, sum over the group backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Sum over the group forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


# ---------------------------------------------------------------------
# the shards
# ---------------------------------------------------------------------

def _head_rows(heads: int, dim_head: int, rank: int, size: int
               ) -> torch.Tensor:
    """The rows of ``to_qkv`` that hold the Q, K and V of the heads of
    ``rank``: [q heads, k heads, v heads] of its ``heads/size``."""
    hl = heads // size
    inner = heads * dim_head
    own = torch.arange(rank * hl * dim_head, (rank + 1) * hl * dim_head)
    return torch.cat([part * inner + own for part in range(3)])


def _slice(param: nn.Parameter, dim: int, idx: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(param.detach().index_select(
        dim, idx.to(param.device)).contiguous(),
        requires_grad=param.requires_grad)


def shard_transformer(model: nn.Module, mesh: Mesh,
                      min_elems: int = TP_MIN_ELEMS) -> int:
    """Split every attention and FeedForward pair of ``model`` over the
    ``model`` axis of ``mesh`` in place (see the module docstring);
    returns how many pairs split.  Each split parameter's global
    indices on every rank are kept in ``model._tp_shards`` (name ->
    (dim, [indices of rank r]) ) for ``gather_tp``."""
    from scat_tpu_torch.models.transformer import Attention, FeedForward
    size, rank = mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS)
    group = mesh.group(MODEL_AXIS)
    if group is None:
        return 0
    shards: Dict[str, Tuple[int, List[torch.Tensor]]] = {}
    names = {m: n for n, m in model.named_modules()}
    n = 0
    for m in list(model.modules()):
        prefix = names[m]
        if isinstance(m, Attention):
            if m.to_qkv.weight.numel() < min_elems or m.heads % size:
                continue
            rows = [_head_rows(m.heads, m.dim_head, r, size)
                    for r in range(size)]
            hl = m.heads // size
            cols = [torch.arange(r * hl * m.dim_head,
                                 (r + 1) * hl * m.dim_head)
                    for r in range(size)]
            m.to_qkv.weight = _slice(m.to_qkv.weight, 0, rows[rank])
            m.to_out[0].weight = _slice(m.to_out[0].weight, 1, cols[rank])
            shards[f"{prefix}.to_qkv.weight"] = (0, rows)
            shards[f"{prefix}.to_out.0.weight"] = (1, cols)
            m.heads = hl
        elif isinstance(m, FeedForward):
            first, second = m.net[0], m.net[2]
            hidden = first.out_features
            if first.weight.numel() < min_elems or hidden % size:
                continue
            hl = hidden // size
            idx = [torch.arange(r * hl, (r + 1) * hl) for r in range(size)]
            first.weight = _slice(first.weight, 0, idx[rank])
            first.bias = _slice(first.bias, 0, idx[rank])
            second.weight = _slice(second.weight, 1, idx[rank])
            shards[f"{prefix}.net.0.weight"] = (0, idx)
            shards[f"{prefix}.net.0.bias"] = (0, idx)
            shards[f"{prefix}.net.2.weight"] = (1, idx)
        else:
            continue
        m.tp_group = group
        n += 1
    model._tp_shards = shards
    model._tp_group = group
    model._tp_rank = rank
    return n


def gather_tp(model: nn.Module, sd: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """The tensor-parallel entries of ``sd`` (``model``'s state_dict)
    reassembled in the global layout; {} for a model that is not
    split.  Every rank of the ``model`` axis takes part."""
    shards = getattr(model, "_tp_shards", {})
    return {name: gather_shard(model, name, sd[name]) for name in shards}


def gather_shard(model: nn.Module, name: str, local: torch.Tensor
                 ) -> torch.Tensor:
    """The global tensor of parameter ``name``'s slices (the parameter
    or an Adam moment of it) on the ranks of the ``model`` axis; the
    tensor itself where ``name`` is not split."""
    shards = getattr(model, "_tp_shards", {})
    if name not in shards:
        return local
    dim, idx = shards[name]
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in idx]
    dist.all_gather(parts, local, group=model._tp_group)
    shape = list(local.shape)
    shape[dim] = sum(len(i) for i in idx)
    full = local.new_empty(shape)
    full.index_copy_(dim, torch.cat(idx).to(local.device),
                     torch.cat(parts, dim=dim))
    return full


def shard_like(full: torch.Tensor, model: nn.Module, name: str,
               rank: int) -> torch.Tensor:
    """This rank's slice of ``full`` when ``name`` is split (an Adam
    moment restored in the global layout), else ``full``."""
    shards = getattr(model, "_tp_shards", {})
    if name not in shards:
        return full
    dim, idx = shards[name]
    return full.index_select(dim, idx[rank].to(full.device)).contiguous()


# ---------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------

class SeqParallel:
    """The ``seq`` axis as a model sees it: its group, this rank's index,
    the axis size and the model's token count ``total``;
    ``token_range(T)`` is this rank's slice of T tokens
    (``torch.tensor_split``'s, so T need not divide)."""

    def __init__(self, group, rank: int, size: int, total: int = 0):
        self.group, self.rank, self.size = group, rank, size
        self.total = total

    def of_tokens(self, total: int) -> "SeqParallel":
        return SeqParallel(self.group, self.rank, self.size, total)

    def token_range(self, t: int) -> slice:
        bounds = [len(c) for c in torch.arange(t).tensor_split(self.size)]
        start = sum(bounds[:self.rank])
        return slice(start, start + bounds[self.rank])

    def sizes(self, t: int) -> List[int]:
        return [len(c) for c in torch.arange(t).tensor_split(self.size)]


def seq_parallel(mesh: Optional[Mesh]) -> Optional[SeqParallel]:
    """The ``seq`` axis of ``mesh`` when it is larger than 1, else None."""
    if mesh is None or mesh.size(SEQ_AXIS) <= 1:
        return None
    return SeqParallel(mesh.group(SEQ_AXIS), mesh.coord(SEQ_AXIS),
                       mesh.size(SEQ_AXIS))


def seq_axis_size(sp: Optional[SeqParallel]) -> int:
    """Size of the ``seq`` axis (1 without one)."""
    return 1 if sp is None else sp.size


def shard_tokens(x: torch.Tensor, sp: Optional[SeqParallel],
                 token_axis: int = 1) -> torch.Tensor:
    """This rank's tokens of ``x`` (identity without a ``seq`` axis)."""
    if sp is None:
        return x
    r = sp.token_range(x.shape[token_axis])
    return x.narrow(token_axis, r.start, r.stop - r.start)


def token_mean(x: torch.Tensor, sp: Optional[SeqParallel], total: int
               ) -> torch.Tensor:
    """The mean over all ``total`` tokens of a token-split [B, t, C]."""
    if sp is None:
        return x.mean(dim=1)
    return all_reduce_sum(x.sum(dim=1), sp.group) / total


class _GatherTokens(torch.autograd.Function):
    """All ranks' token slices of [B, H, t_r, D] concatenated on the token
    axis; the backward sums the gradient over the group and keeps this
    rank's slice (an all-reduce, which gloo also has)."""

    @staticmethod
    def forward(ctx, x, group, rank, sizes):
        ctx.group, ctx.rank, ctx.sizes = group, rank, sizes
        most = max(sizes)
        pad = x.new_zeros(x.shape[:2] + (most,) + x.shape[3:])
        pad[:, :, :x.shape[2]] = x
        parts = [torch.empty_like(pad) for _ in sizes]
        dist.all_gather(parts, pad.contiguous(), group=group)
        return torch.cat([p[:, :, :n] for p, n in zip(parts, sizes)], dim=2)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        start = sum(ctx.sizes[:ctx.rank])
        return g[:, :, start:start + ctx.sizes[ctx.rank]], None, None, None


def gather_tokens(x: torch.Tensor, sp: SeqParallel, total: int
                  ) -> torch.Tensor:
    """Every rank's tokens of a token-split [B, H, t, D] (softmax
    attention's K and V under sequence parallelism)."""
    return _GatherTokens.apply(x, sp.group, sp.rank, sp.sizes(total))
