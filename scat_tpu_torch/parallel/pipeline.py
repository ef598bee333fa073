"""Pipeline parallelism over homogeneous blocks (port of
``scat_tpu/parallel/pipeline.py``): GPipe, M microbatches over the S
stages of the ``pipe`` axis.

Each rank of the axis holds a contiguous stage of ``depth/S`` blocks.
The forward runs every microbatch through the stage in turn, receiving
its input from the previous stage and sending its output to the next
(``isend``/``irecv``; the last stage's outputs are broadcast over the
axis, so every rank returns the replicated result, as the JAX
``shard_map`` does).  The backward runs the microbatches in reverse: the
last stage starts from the output's gradient, each stage sends its
input's gradient back, and the first stage's input gradient is broadcast
over the axis.  ``pipeline_apply`` is one autograd function, so the
schedule is differentiable end to end with respect to the input and the
stage's parameters, as the JAX package's is (not twice: the stage's
backward is ``torch.autograd.grad`` of its own forward).

Stacks whose blocks change dims are refused (JAX :17-19): a stage's
input and output must have one shape to be handed on.  Bubble: the
schedule keeps a stage busy M of M + S - 1 ticks.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
from torch import nn

from scat_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh


def stack_layer_vars(blocks: Sequence[nn.Module]) -> List[nn.Module]:
    """The blocks of a stack as the pipeline stages them (JAX
    ``stack_layer_vars`` :46 stacks their variables on a leading layer
    axis; here the stages keep their modules).  Raises unless every block
    is of one type with parameters of one shape: a pipeline rotates one
    activation shape."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("no block to stage")
    shapes = [(type(b), [tuple(p.shape) for p in b.parameters()])
              for b in blocks]
    if any(s != shapes[0] for s in shapes):
        raise ValueError(
            "pipeline stages must be shape-homogeneous: blocks whose dims "
            "change (the pyramid halves its token dim a layer) are refused")
    return blocks


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, layer_fn, blocks, group, stage, stages, ranks, m, x,
                *params):
        xs = x.chunk(m)
        saved, outs, sends = [], [], []
        with torch.enable_grad():
            for j in range(m):
                if stage == 0:
                    inp = xs[j].detach().requires_grad_()
                else:
                    inp = torch.empty_like(xs[j])
                    dist.recv(inp, src=ranks[stage - 1], group=group)
                    inp.requires_grad_()
                out = inp
                for block in blocks:
                    out = layer_fn(block, out)
                if out.shape != inp.shape or out.dtype != inp.dtype:
                    raise ValueError(
                        f"a stage maps {tuple(inp.shape)} {inp.dtype} to "
                        f"{tuple(out.shape)} {out.dtype}: stages must keep "
                        "the activation's shape and dtype")
                if stage < stages - 1:
                    sends.append(dist.isend(out.detach().contiguous(),
                                            dst=ranks[stage + 1],
                                            group=group))
                outs.append(out.detach())
                saved.append((inp, out))
        for w in sends:
            w.wait()
        y = torch.cat(outs) if stage == stages - 1 else torch.empty_like(x)
        dist.broadcast(y, src=ranks[-1], group=group)
        ctx.saved = saved
        ctx.meta = (group, stage, stages, ranks, m, len(params))
        ctx.params = params
        return y

    @staticmethod
    def backward(ctx, gy):
        group, stage, stages, ranks, m, n_params = ctx.meta
        params = ctx.params
        gys = gy.contiguous().chunk(m)
        grads = [None] * n_params
        gxs, sends = [None] * m, []
        for j in reversed(range(m)):
            inp, out = ctx.saved[j]
            if stage == stages - 1:
                g = gys[j]
            else:
                g = torch.empty_like(out)
                dist.recv(g, src=ranks[stage + 1], group=group)
            got = torch.autograd.grad(out, (inp,) + tuple(params), g,
                                      allow_unused=True)
            if stage > 0:
                sends.append(dist.isend(got[0].contiguous(),
                                        dst=ranks[stage - 1], group=group))
            gxs[j] = got[0]
            for i, gp in enumerate(got[1:]):
                if gp is not None:
                    grads[i] = gp if grads[i] is None else grads[i] + gp
        for w in sends:
            w.wait()
        gx = torch.cat(gxs) if stage == 0 else torch.empty_like(gy)
        dist.broadcast(gx, src=ranks[0], group=group)
        ctx.saved = None
        return (None,) * 7 + (gx,) + tuple(grads)


def stage_blocks(blocks: Sequence[nn.Module], mesh: Mesh) -> List[nn.Module]:
    """This rank's contiguous stage of ``blocks`` over the ``pipe`` axis."""
    s, stages = mesh.coord(PIPE_AXIS), mesh.size(PIPE_AXIS)
    if len(blocks) % stages:
        raise ValueError(f"depth {len(blocks)} must divide over "
                         f"pipe={stages}")
    per = len(blocks) // stages
    return list(blocks)[s * per:(s + 1) * per]


def pipeline_apply(layer_fn: Callable[[nn.Module, torch.Tensor],
                                      torch.Tensor],
                   blocks: Sequence[nn.Module], x: torch.Tensor, mesh: Mesh,
                   num_microbatches: int) -> torch.Tensor:
    """Run the ``depth`` blocks of ``stack_layer_vars(blocks)`` over ``x``
    pipelined across the ``pipe`` axis of ``mesh`` (JAX
    ``pipeline_apply`` :65): ``layer_fn(block, x) -> x`` applies one
    block; ``x`` [B, ...] (this rank's rows when the mesh has a ``data``
    axis) splits into ``num_microbatches`` along axis 0.  Every rank of
    the axis passes the same ``x`` and gets the same result; the
    gradients reach ``x`` and this rank's stage only."""
    if PIPE_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.shape} has no '{PIPE_AXIS}' axis")
    blocks = stack_layer_vars(blocks)
    mine = stage_blocks(blocks, mesh)
    m = num_microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} must divide into {m} "
                         "microbatches")
    params = [p for b in mine for p in b.parameters() if p.requires_grad]
    ranks = mesh.group_ranks((PIPE_AXIS,))
    return _Pipeline.apply(layer_fn, mine, mesh.group(PIPE_AXIS),
                           mesh.coord(PIPE_AXIS), mesh.size(PIPE_AXIS),
                           ranks, m, x, *params)
