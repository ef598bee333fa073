"""Fused softmax attention on [B,H,N,D], forward and backward: the
hand-written CUDA kernels and their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``scat_tpu/ops/pallas_attention.py``:
``_fwd_kernel`` :49-60 (launched by ``_flash_fwd_impl`` :111-129) and
``_bwd_kernel`` :63-86 (launched by ``_flash_bwd`` :136-161), tied
together by the ``_flash_core`` custom VJP :106-164, and its wrapper
``flash_attention`` :167-176.  The kernels are ``csrc/attention_fwd.cu``
and ``csrc/attention_bwd.cu``; the custom VJP is ``_FlashAttention``, a
``torch.autograd.Function``.

What bounds both on the H100 is bytes, not flops: the forward reads Q,
K, V and writes O (4*B*H*N*D elements), the backward reads Q, K, V, dO
and writes dQ, dK, dV (7*B*H*N*D), against 4 and 10 flops per element
times N.  The kernels keep the [N,N] scores, probabilities and their
gradients on chip (one block per batch*head, rows in shared memory) and
read the projection's strided Q/K/V views in place, so the one
device-memory round trip is all they move.  On float32 operands, the
parity type, both compute on CUDA cores (softmax by warp shuffles; the
backward recomputes P in a second pass).  On bf16 operands, the
flagship's serving and training paths, CUDA cores made both limited by
instruction count, not bytes, so both run their products on the tensor
cores (``mma.sync``, bf16 in, float32 accumulation), a warp per 16 query
rows, with the softmax (and the backward's delta and dS) in the
accumulator registers.  As the Pallas kernels keep P and dS in float32,
the kernels split each into a bf16 high part and a bf16 low part and
run both products into one float32 accumulator: the forward takes P's
parts straight from the registers as the A operands of P V; the backward
keeps P's and dS's parts in shared memory for its second products (no
recompute pass).  Their bf16 results lie within 2 bf16 ulps
(``bf16_ulps``) of ``attention_reference`` and ``attention_bwd_reference``
in float32, rounded to bf16; the design notes are in
``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``, their shared
tiles in ``csrc/attention.cuh``.  Their 16-byte copies need 16-byte
aligned rows: an operand whose rows are not is copied first.

Both kernels are ``torch.library`` custom ops, ``scat_tpu_torch::
attention_fwd`` and ``scat_tpu_torch::attention_bwd``: a CUDA
implementation (the launch, its alignment copy and its counter), a CPU
implementation (the plain version) and a fake that gives the outputs'
shapes and strides without touching storage, so ``torch.export`` records
them as nodes and a CUDA graph captures their launches.
``flash_attention`` calls the forward op, through ``_FlashAttention``
where autograd records; CUDA tensors launch the kernels or raise, it
never falls back.  CPU tensors take ``attention_reference``: through
the op where no gradient is recorded (serving, eval, export), by
autograd through it where one is; ``attention_bwd_reference`` is the
plain version of the backward kernel.
The backward kernel is ``once_differentiable``: a second backward through
it (the ``pl_reg`` path-length probe) raises, and the model factory
routes ``pl_reg`` to the plain path as the JAX package does.  It takes
no mask: no model of the port passes one (the JAX package's masked path
is unused by its shipped models), and the kernels have none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from scat_tpu_torch.kernels import abi, build

HEAD_DIM = 64
MAX_SEQ = 128
# below this share of a tensor's largest magnitude, bf16_ulps counts in
# the ulps of that floor: float32 sums that cancel to near zero carry
# rounding of the size of their terms, not of their result
ULP_FLOOR = 2.0 ** -8


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              floor: float = ULP_FLOOR) -> torch.Tensor:
    """How far each element of the bf16 result ``got`` lies from
    ``want`` (float32) rounded to bf16, in bf16 ulps (2^(e-7) for
    |x| in [2^e, 2^(e+1))) of the larger of |want| and ``floor`` times
    the largest |want|."""
    w = want.float().bfloat16().float()
    mag = torch.maximum(w.abs(), floor * w.abs().max()).clamp(
        min=torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (got.float() - w).abs() / ulp


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, mask: Optional[torch.Tensor] = None,
                        return_attn: bool = False):
    """Softmax attention on [B,H,N,D] in the inputs' dtype (reference
    vision_transformer.py:59-79).  ``mask`` is a boolean [B,N] keep-mask;
    masked pairs get -finfo.max, like the reference's masked_fill_.
    ``return_attn`` also returns the softmax matrix [B,H,N,N] (the coarse
    head's output, which no kernel materialises)."""
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    if mask is not None:
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        dots = dots.masked_fill(~pair, -torch.finfo(dots.dtype).max)
    attn = dots.softmax(dim=-1)
    out = torch.einsum("bhij,bhjd->bhid", attn, v)
    return (out, attn) if return_attn else out


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor, scale: float
                            ) -> Tuple[torch.Tensor, ...]:
    """(dQ, dK, dV) of softmax attention for the output gradient ``do``,
    computed as ``_bwd_kernel`` does: P recomputed in float32, results
    cast to the inputs' dtype."""
    dtype = q.dtype
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = (torch.einsum("bhid,bhjd->bhij", q, k) * scale).softmax(dim=-1)
    dv = torch.einsum("bhij,bhid->bhjd", p, do)
    dp = torch.einsum("bhid,bhjd->bhij", do, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhij,bhjd->bhid", ds, k) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, q) * scale
    return tuple(t.to(dtype) for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    n_ptr = {"attention_fwd": 4, "attention_bwd": 7}[name]
    fn = getattr(lib, f"scat_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = getattr(lib, f"scat_{name}_occupancy")
    occ.argtypes = [ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    lib.scat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.scat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def occupancy(name: str, n: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(blocks an SM holds at once, dynamic shared memory of a block in
    bytes) of the kernel that ``name`` ("attention_fwd" or
    "attention_bwd") launches at sequence length ``n`` for ``dtype``,
    from the CUDA occupancy API on the current device.  A query: nothing
    is launched."""
    lib = _library(name)
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, f"scat_{name}_occupancy")(
        n, abi.DTYPE_CODES[dtype], ctypes.byref(blocks), ctypes.byref(smem))
    abi.raise_on(rc, lib, f"{name} occupancy")
    return blocks.value, smem.value


def _check(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"attention operands must share one [B,H,N,D] "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in abi.DTYPE_CODES:
        raise TypeError(f"the attention kernels take float32 or bfloat16 "
                        f"inputs of one dtype, got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("attention operands must be on one device")
    _, _, n, d = q.shape
    if d != HEAD_DIM or not 1 <= n <= MAX_SEQ:
        raise ValueError(f"the attention kernels take head dim {HEAD_DIM} "
                         f"and 1 <= N <= {MAX_SEQ}, got N={n}, D={d}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("the head dimension of q, k, v must be contiguous")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of a [B,H,N,D] operand starts on 16 bytes (the bf16
    kernels' copies)."""
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % step == 0 for s in t.stride()[:3]))


def _operands(*ts: torch.Tensor):
    """Pointers and the (batch, head, row) strides of [B,H,N,D] operands,
    as the kernels' C interfaces take them."""
    return [t.data_ptr() for t in ts], abi.strides(*ts)


def _aligned(*ts: torch.Tensor):
    """The operands as the bf16 kernels take them: bf16 ones whose rows
    are not 16-byte aligned copied; float32 ones as they are."""
    if ts[0].dtype != torch.bfloat16:
        return ts
    return tuple(t if _rows_aligned(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in ts)


def _heads_last(o: torch.Tensor) -> torch.Tensor:
    """``o`` [B,H,N,D] copied into the layout the forward kernel writes:
    [B,N,H,D] storage seen as [B,H,N,D]."""
    return o.transpose(1, 2).contiguous().transpose(1, 2)


@torch.library.custom_op("scat_tpu_torch::attention_fwd", mutates_args=(),
                         device_types="cuda")
def _attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The forward kernel on CUDA tensors (counted)."""
    _check(q, k, v)
    q, k, v = _aligned(q, k, v)
    b, h, n, d = q.shape
    # O is stored [B,N,H,D] and returned as its [B,H,N,D] view, so that
    # the caller's merge of heads back to [B,N,H*D] needs no copy
    o = torch.empty((b, n, h, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    ptrs, strides = _operands(q, k, v, o)
    lib = _library("attention_fwd")
    with torch.cuda.device(q.device):
        rc = lib.scat_attention_fwd(
            *ptrs, b, h, n, d, strides, float(scale), abi.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    abi.raise_on(rc, lib, "attention_fwd")
    flash_attention.launches += 1
    return o


@_attention_fwd.register_kernel("cpu")
def _(q, k, v, scale):
    return _heads_last(attention_reference(q, k, v, scale))


@_attention_fwd.register_fake
def _(q, k, v, scale):
    b, h, n, d = q.shape
    return q.new_empty((b, n, h, d)).permute(0, 2, 1, 3)


@torch.library.custom_op("scat_tpu_torch::attention_bwd", mutates_args=(),
                         device_types="cuda")
def _attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel on CUDA tensors (counted)."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check(q, k, v, do)
    q, k, v, do = _aligned(q, k, v, do)
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    b, h, n, d = q.shape
    ptrs, strides = _operands(q, k, v, do, *grads)
    lib = _library("attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.scat_attention_bwd(
            *ptrs, b, h, n, d, strides, float(scale), abi.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    abi.raise_on(rc, lib, "attention_bwd")
    attention_bwd.launches += 1
    return grads


@_attention_bwd.register_kernel("cpu")
def _(q, k, v, do, scale):
    return tuple(g.contiguous() for g in
                 attention_bwd_reference(q, k, v, do, scale))


@_attention_bwd.register_fake
def _(q, k, v, do, scale):
    return tuple(q.new_empty(q.shape) for _ in range(3))


def _on_cuda_or_cpu(name: str, q: torch.Tensor) -> None:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, "
                         f"got {q.device}")


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, scale: float
                  ) -> Tuple[torch.Tensor, ...]:
    """(dQ, dK, dV) for the output gradient ``do``: the backward kernel
    on CUDA tensors, the plain version on CPU tensors."""
    _on_cuda_or_cpu("attention_bwd", q)
    return _attention_bwd(q, k, v, do, scale)


class _FlashAttention(torch.autograd.Function):
    """The ``_flash_core`` custom VJP: the forward op, and the backward
    op recomputing P from the saved Q, K, V."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _attention_fwd(q, k, v, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_bwd(q, k, v, do, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Softmax attention on [B,H,N,D], differentiable; the kernels on
    CUDA tensors, the plain version on CPU tensors."""
    _on_cuda_or_cpu("flash_attention", q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cpu":
            return attention_reference(q, k, v, scale)
        return _FlashAttention.apply(q, k, v, scale)
    return _attention_fwd(q, k, v, scale)


flash_attention.launches = 0
attention_bwd.launches = 0
