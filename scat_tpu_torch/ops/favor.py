"""FAVOR+ linear attention (the Performer's, ``--net ViP``): the plain
PyTorch versions, the precision ladder, and the hand-written CUDA stats
and apply kernels behind one ``torch.autograd.Function``.

The plain math is the port of ``scat_tpu/models/performer.py:26-71``
(``favor_precisions``, ``favor_features``, ``favor_attention``).  The
kernels replace the two Pallas TPU kernels of
``scat_tpu/ops/pallas_favor.py``, both launched by ``_favor_impl``
:105-147: the stats pass ``_favor_stats_kernel`` :63-87 (call :128) and
the apply pass ``_favor_apply_kernel`` :90-102 (call :139), with the
feature map ``_prm`` :54-60; the custom VJP :150-175 becomes
``_FavorAttention`` and ``favor_attention_fused`` :178-189 keeps its name.
Both kernels are ``csrc/favor.cu``; what bounds them and how they are
laid out is written there.  On bf16 operands (ViP's path) both passes run
on the tensor cores with the float32 factors split into three bf16 parts
each ("bf16x3"), to float32's accuracy.  The stats pass (``mma.sync``)
splits w and phi(k).  The apply pass (``wgmma``, w's and kptv's parts
read by the tensor cores from shared memory) splits w for the features
of its bf16 q, and phi(q) and kptv for the contraction, of whose nine
cross products it keeps the six with part indices summing to at most 2;
its ‖q‖², exp and D = phi(q) . ksum stay IEEE float32 on CUDA cores.  On
float32 operands, the parity type, both passes run IEEE float32 FMAs on
CUDA cores.

The kernels' formula, which ``favor_stats_reference`` and
``favor_apply_reference`` repeat in plain PyTorch:
``phi(x) = exp(w x^T - |x|^2/2) * (1/sqrt(m))``, ``ksum = sum_t
phi(k_t)``, ``kptv = phi(k)^T v``, ``y = phi(q) kptv / (phi(q) . ksum)``,
in float32 (bf16 operands are read as their exact float32 values, as
the JAX model casts them; the plain versions are IEEE float32, or
float64 for float64 operands, the precision the bf16 kernels' split
products are held to on the card), no max-subtraction stabiliser.

Both kernels are ``torch.library`` custom ops, ``scat_tpu_torch::
favor_stats`` and ``scat_tpu_torch::favor_apply``: a CUDA implementation
(the launch, the stats' split-T work buffer, the counter), a CPU
implementation (the plain version) and a fake giving the outputs' shapes
and strides, so ``torch.export`` records them as nodes and a CUDA graph
captures their launches.  ``favor_attention_fused`` (and the wrappers
``favor_stats`` and ``favor_apply``) call the ops: CUDA tensors launch
the kernels or raise, never falling back; CPU tensors take the plain
versions.  The
backward recomputes by autograd through ``favor_attention`` at HIGHEST
in float32, as the JAX package's ``_favor_bwd`` does; ``w`` gets no
gradient.  The launch counters are ``favor_stats.launches`` and
``favor_apply.launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch
from scat_tpu_torch.ops import widen
from torch.autograd.function import once_differentiable

from scat_tpu_torch.kernels import abi, build

# the kernels' limits (csrc/favor.cu kE, kM)
MAX_HEAD_DIM = 128
MAX_FEATURES = 64
# the float32 kernels' row chunk (kRows) and blocks resident on one SM
# (__launch_bounds__; 76 KB and 94 KB of shared memory a block)
CHUNK_ROWS = 32
BLOCKS_PER_SM = 2
# the bf16 stats kernel's (favor_stats_bf16_kernel: kTcRows, one 208 KB
# block an SM)
TC_CHUNK_ROWS = 64
TC_BLOCKS_PER_SM = 1
# the bf16 q apply kernel's (favor_apply_bf16_kernel: kApRows, the rows
# its three warpgroups take at a time, 64 each; one 177 KB block an SM)
TC_APPLY_CHUNK_ROWS = 192
TC_APPLY_BLOCKS_PER_SM = 1
MAX_TILES = 64

# (feature-dot, contraction-dot) precision of each rung
# (scat_tpu/models/performer.py:26-42): the feature dot feeds exp, so
# "mixed" keeps it exact and runs the averaging contractions fast
PRECISIONS = {
    "highest": ("highest", "highest"),
    "high": ("high", "high"),
    "default": ("default", "default"),
    "mixed": ("highest", "default"),
    "mixed_high": ("high", "default"),
}


def favor_precisions(name: str) -> Tuple[str, str]:
    """(feature-dot, contraction-dot) precision of the rung ``name``;
    an unknown name raises KeyError, as in the JAX package.  On CUDA,
    "highest" is IEEE float32 (TF32 off), "high" TF32 and "default"
    bf16 operands; on the CPU every rung computes in float32, as XLA's
    CPU backend ignores the precision."""
    return PRECISIONS[name]


@contextlib.contextmanager
def _tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _dot(eq: str, a: torch.Tensor, b: torch.Tensor,
         precision: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` with both operands promoted to one dtype, as
    ``jnp.einsum`` promotes them, at ``precision`` (see
    ``favor_precisions``)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    if a.device.type != "cuda" or dtype != torch.float32:
        return torch.einsum(eq, a, b)
    if precision == "default":
        return torch.einsum(eq, a.bfloat16(), b.bfloat16()).float()
    with _tf32(precision == "high"):
        return torch.einsum(eq, a, b)


def favor_features(x: torch.Tensor, w: torch.Tensor,
                   precision: str = "highest") -> torch.Tensor:
    """Positive random features of ``x`` [..., T, d] for the frozen
    Gaussian ``w`` [m, d]: exp(w x - |x|^2/2)/sqrt(m) [..., T, m].  The
    squared norm is taken in x's dtype, the exponent in the promoted one
    (float32 for bf16 x and float32 w, as in the JAX package)."""
    with torch.autocast(x.device.type, enabled=False):
        xd = (x * x).sum(dim=-1, keepdim=True) / 2.0
        wtx = _dot("...td,md->...tm", x, w, precision)
        return torch.exp(wtx - xd) / math.sqrt(w.shape[0])


def favor_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, precision: str = "highest",
                    moment_sum: Optional[Callable] = None) -> torch.Tensor:
    """Linear-time attention over [..., T, d]: qp (kp^T v) / (qp sum_t kp)
    (reference vision_performer.py:45-53), in the inputs' promoted dtype
    with autocast off.  ``moment_sum``: applied to the two cross-token
    moments, sum_t kp and kp^T v (sequence parallelism: their sum over
    the ``seq`` axis, JAX ``performer.py:129-135``)."""
    feat_p, con_p = favor_precisions(precision)
    keep = (lambda t: t) if moment_sum is None else moment_sum
    with torch.autocast(q.device.type, enabled=False):
        qp = favor_features(q, w, feat_p)
        kp = favor_features(k, w, feat_p)
        d = _dot("...tm,...m->...t", qp, keep(kp.sum(dim=-2)),
                 con_p)[..., None]
        kptv = keep(_dot("...tn,...tm->...nm", v, kp, con_p))
        y = _dot("...tm,...nm->...tn", qp, kptv, con_p)
        return y / d


def _prm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' feature map in x's dtype: exp(w x^T - 0.5 |x|^2)
    times 1/sqrt(m) (``_prm``)."""
    wtx = _dot("...te,me->...tm", x, w, "highest")
    xd = 0.5 * (x * x).sum(dim=-1, keepdim=True)
    return torch.exp(wtx - xd) * (1.0 / math.sqrt(w.shape[0]))


def favor_stats_reference(k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stats kernel's plain version: (sum_t phi(k) [..., m], phi(k)^T
    v [..., m, e]) in float32 (float64 for float64 operands) for k, v
    [..., T, e]."""
    with torch.autocast(k.device.type, enabled=False):
        kp = _prm(widen(k), widen(w))
        return kp.sum(dim=-2), _dot("...tm,...te->...me", kp, widen(v),
                                    "highest")


def favor_apply_reference(q: torch.Tensor, ksum: torch.Tensor,
                          kptv: torch.Tensor, w: torch.Tensor
                          ) -> torch.Tensor:
    """The apply kernel's plain version: phi(q) kptv / (phi(q) . ksum),
    float32 (float64 for float64 operands) [..., T, e]."""
    with torch.autocast(q.device.type, enabled=False):
        qp = _prm(widen(q), widen(w))
        d = _dot("...tm,...m->...t", qp, ksum, "highest")[..., None]
        return _dot("...tm,...me->...te", qp, kptv, "highest") / d


def t_tiles(bh: int, t: int, sms: int, chunk_rows: int = CHUNK_ROWS,
            blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """How many T-tiles of whole ``chunk_rows`` chunks each (batch, head)
    is split into, for ``bh`` of them on a card of ``sms`` SMs and a
    kernel with ``blocks_per_sm`` blocks resident on an SM: the fewest
    whose waves of ``blocks_per_sm * sms`` blocks take within 5% of the
    least time any count up to ``MAX_TILES`` (tiles of at least two
    chunks) would, every tile non-empty.  Blocks run in parallel, so T is
    split only as far as filling the SMs needs.  The defaults are the
    float32 kernels'; ``stats_tiling`` and ``apply_tiling`` give each
    kernel's for its operands' dtype."""
    slots = blocks_per_sm * sms
    most = max(1, min(-(-t // (2 * chunk_rows)), MAX_TILES))

    def cost(n):  # time in units of one tile of t/n rows
        return -(-bh * n // slots) / n

    best = min(cost(n) for n in range(1, most + 1))
    n = next(n for n in range(1, most + 1) if cost(n) <= 1.05 * best)
    rows = -(-(-(-t // n)) // chunk_rows) * chunk_rows
    return -(-t // rows)


def stats_tiling(dtype: torch.dtype) -> Tuple[int, int]:
    """(chunk rows, blocks an SM) of the stats kernel that ``dtype``
    operands launch: the tensor-core kernel for bf16, the CUDA-core one
    for float32."""
    if dtype == torch.bfloat16:
        return TC_CHUNK_ROWS, TC_BLOCKS_PER_SM
    return CHUNK_ROWS, BLOCKS_PER_SM


def apply_tiling(dtype: torch.dtype) -> Tuple[int, int]:
    """(chunk rows, blocks an SM) of the apply kernel that a ``dtype`` q
    launches: the tensor-core kernel for bf16, the CUDA-core one for
    float32."""
    if dtype == torch.bfloat16:
        return TC_APPLY_CHUNK_ROWS, TC_APPLY_BLOCKS_PER_SM
    return CHUNK_ROWS, BLOCKS_PER_SM


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("favor")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.POINTER(ctypes.c_longlong), i32, ctypes.c_float, i32,
            ptr]
    lib.scat_favor_stats.argtypes = [ptr] * 6 + [i32] * 5 + tail
    lib.scat_favor_apply.argtypes = [ptr] * 5 + [i32] * 5 + tail
    lib.scat_favor_stats.restype = lib.scat_favor_apply.restype = i32
    lib.scat_cuda_error_string.argtypes = [i32]
    lib.scat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_cuda(name: str, *ts: torch.Tensor) -> None:
    if any(t.device.type != "cuda" or t.device != ts[0].device
           for t in ts):
        raise ValueError(f"{name} runs on cuda or cpu tensors of one "
                         f"device, got {[str(t.device) for t in ts]}")


def _on_cuda_or_cpu(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x.device}")


def _check(ts, w: torch.Tensor) -> None:
    """Operands [B,H,T,e] of one shape and dtype (float32 or bfloat16),
    the head dimension contiguous; w float32 [m, e]; e <= 128, m <= 64."""
    x = ts[0]
    if x.dim() != 4 or any(t.shape != x.shape for t in ts):
        raise ValueError(f"FAVOR+ operands must share one [B,H,T,e] "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != x.dtype for t in ts) or x.dtype not in abi.DTYPE_CODES:
        raise TypeError(f"the FAVOR+ kernels take float32 or bfloat16 "
                        f"operands of one dtype, got {[t.dtype for t in ts]}")
    if w.dtype != torch.float32 or w.dim() != 2 or w.shape[1] != x.shape[3]:
        raise TypeError(f"w must be float32 [m, e={x.shape[3]}], got "
                        f"{w.dtype} {tuple(w.shape)}")
    b, h, t, e = x.shape
    m = w.shape[0]
    if not (1 <= e <= MAX_HEAD_DIM and 1 <= m <= MAX_FEATURES and t >= 1
            and b * h >= 1):
        raise ValueError(f"the FAVOR+ kernels take e <= {MAX_HEAD_DIM}, "
                         f"m <= {MAX_FEATURES} and T >= 1, got e={e}, "
                         f"m={m}, T={t}, B*H={b * h}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("the head dimension of the FAVOR+ operands must "
                         "be contiguous")


def _heads_last(y: torch.Tensor) -> torch.Tensor:
    """``y`` [B,H,T,e] copied into the layout the apply kernel writes:
    [B,T,H,e] storage seen as [B,H,T,e]."""
    return y.transpose(1, 2).contiguous().transpose(1, 2)


@torch.library.custom_op("scat_tpu_torch::favor_stats", mutates_args=(),
                         device_types="cuda")
def _favor_stats(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stats kernel on CUDA tensors (counted)."""
    _on_cuda("favor_stats", k, v, w)
    _check((k, v), w)
    b, h, t, e = k.shape
    m = w.shape[0]
    tiles = t_tiles(b * h, t, _sm_count(k.device.index),
                    *stats_tiling(k.dtype))
    ksum = torch.empty((b, h, m), dtype=torch.float32, device=k.device)
    kptv = torch.empty((b, h, m, e), dtype=torch.float32, device=k.device)
    # per-tile partials, summed in tile order by the kernel's second pass
    work = (torch.empty(b * h * tiles * (m * e + m), dtype=torch.float32,
                        device=k.device) if tiles > 1 else None)
    with torch.cuda.device(k.device):
        rc = _library().scat_favor_stats(
            k.data_ptr(), v.data_ptr(), w.data_ptr(), ksum.data_ptr(),
            kptv.data_ptr(), None if work is None else work.data_ptr(),
            b, h, t, e, m, abi.strides(k, v), tiles, 1.0 / math.sqrt(m),
            abi.DTYPE_CODES[k.dtype],
            torch.cuda.current_stream(k.device).cuda_stream)
    abi.raise_on(rc, _library(), "favor_stats")
    favor_stats.launches += 1
    return ksum, kptv


@_favor_stats.register_kernel("cpu")
def _(k, v, w):
    return tuple(s.contiguous() for s in favor_stats_reference(k, v, w))


@_favor_stats.register_fake
def _(k, v, w):
    b, h, _, e = k.shape
    m = w.shape[0]
    dtype = torch.promote_types(k.dtype, torch.float32)
    return (k.new_empty((b, h, m), dtype=dtype),
            k.new_empty((b, h, m, e), dtype=dtype))


@torch.library.custom_op("scat_tpu_torch::favor_apply", mutates_args=(),
                         device_types="cuda")
def _favor_apply(q: torch.Tensor, ksum: torch.Tensor, kptv: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """The apply kernel on CUDA tensors (counted)."""
    _on_cuda("favor_apply", q, ksum, kptv, w)
    _check((q,), w)
    b, h, t, e = q.shape
    m = w.shape[0]
    if (ksum.shape != (b, h, m) or kptv.shape != (b, h, m, e)
            or ksum.dtype != torch.float32 or kptv.dtype != torch.float32
            or not ksum.is_contiguous() or not kptv.is_contiguous()):
        raise ValueError("favor_apply takes favor_stats' contiguous float32 "
                         f"outputs [B,H,m] and [B,H,m,e], got "
                         f"{tuple(ksum.shape)} and {tuple(kptv.shape)}")
    # y is stored [B,T,H,e] and returned as its [B,H,T,e] view, so that
    # the caller's merge of heads back to [B,T,H*e] needs no copy
    y = torch.empty((b, t, h, e), dtype=torch.float32,
                    device=q.device).permute(0, 2, 1, 3)
    with torch.cuda.device(q.device):
        rc = _library().scat_favor_apply(
            q.data_ptr(), w.data_ptr(), ksum.data_ptr(), kptv.data_ptr(),
            y.data_ptr(), b, h, t, e, m, abi.strides(q, y),
            t_tiles(b * h, t, _sm_count(q.device.index),
                    *apply_tiling(q.dtype)),
            1.0 / math.sqrt(m), abi.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    abi.raise_on(rc, _library(), "favor_apply")
    favor_apply.launches += 1
    return y


@_favor_apply.register_kernel("cpu")
def _(q, ksum, kptv, w):
    return _heads_last(favor_apply_reference(q, ksum, kptv, w))


@_favor_apply.register_fake
def _(q, ksum, kptv, w):
    b, h, t, e = q.shape
    dtype = torch.promote_types(q.dtype, torch.float32)
    return q.new_empty((b, t, h, e), dtype=dtype).permute(0, 2, 1, 3)


def favor_stats(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_t phi(k) [B,H,m], phi(k)^T v [B,H,m,e]) float32 for k, v
    [B,H,T,e]: the stats kernel on CUDA tensors, the plain version on CPU
    tensors."""
    _on_cuda_or_cpu("favor_stats", k)
    return _favor_stats(k, v, w)


def favor_apply(q: torch.Tensor, ksum: torch.Tensor, kptv: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """phi(q) kptv / (phi(q) . ksum), float32 [B,H,T,e], for q [B,H,T,e]
    and favor_stats' outputs: the apply kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _on_cuda_or_cpu("favor_apply", q)
    return _favor_apply(q, ksum, kptv, w)


class _FavorAttention(torch.autograd.Function):
    """The ``_favor_core`` custom VJP: the stats and apply kernels
    forward; the backward recomputes by autograd through
    ``favor_attention`` on the float32 operands at HIGHEST."""

    @staticmethod
    def forward(ctx, q, k, v, w):
        ctx.save_for_backward(q, k, v, w)
        return favor_apply(q, *favor_stats(k, v, w), w)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        q, k, v, w = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(True)
                      for t in (q, k, v)]
            y = favor_attention(*leaves, w.float())
            grads = torch.autograd.grad(y, leaves, dy)
        return (*(g.to(t.dtype) for g, t in zip(grads, (q, k, v))), None)


def favor_attention_fused(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """FAVOR+ attention through the kernels on [B,H,T,e] operands (or
    [B,T,e], treated as H = 1), float32 or bf16 (read as their float32
    values); returns float32 in q's shape, differentiable in q, k, v.
    CUDA tensors launch the kernels or raise, CPU tensors take the plain
    versions; other devices raise."""
    _on_cuda_or_cpu("favor_attention_fused", q)
    if q.dim() == 3:
        return favor_attention_fused(q[:, None], k[:, None], v[:, None],
                                     w)[:, 0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FavorAttention.apply(q, k, v, w)
    return favor_apply(q, *favor_stats(k, v, w), w)


favor_stats.launches = 0
favor_apply.launches = 0
