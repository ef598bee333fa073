"""Fused softmax attention on [B,H,N,D]: the hand-written CUDA kernel and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``scat_tpu/ops/pallas_attention.py``
(``_fwd_kernel`` :49-60, launched by ``_flash_fwd_impl`` :111-129) and
its wrapper ``flash_attention`` :167-176.  The kernel is
``csrc/attention_fwd.cu``.

What bounds it on the H100 is bytes, not flops: Q, K and V read once and
O written once, 4*B*H*N*D elements, ~5.5 MB per call in bf16 at the
flagship's largest bucket [64,8,21,64], against 4*B*H*N*N*D flops, about
21 per element at N=21.  The kernel keeps the [N,N] scores and
probabilities on chip (one block per batch*head, rows in shared memory,
softmax by warp shuffles) and reads the projection's strided Q/K/V views
in place, so the one device-memory round trip is all it moves.

``flash_attention`` launches the kernel for CUDA tensors and raises if
it cannot; it never falls back.  CPU tensors take
``attention_reference``, the plain version of the same math.  It takes
no mask: no model of the port passes one (the JAX package's masked path
is unused by its shipped models), and the kernel has none.  The
backward kernel comes with the training slice, so a CUDA input that
requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from scat_tpu_torch.kernels import build

HEAD_DIM = 64
MAX_SEQ = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Softmax attention on [B,H,N,D] in the inputs' dtype (reference
    vision_transformer.py:59-79).  ``mask`` is a boolean [B,N] keep-mask;
    masked pairs get -finfo.max, like the reference's masked_fill_."""
    dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    if mask is not None:
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        dots = dots.masked_fill(~pair, -torch.finfo(dots.dtype).max)
    attn = dots.softmax(dim=-1)
    return torch.einsum("bhij,bhjd->bhid", attn, v)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("attention_fwd")
    lib.scat_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])
    lib.scat_attention_fwd.restype = ctypes.c_int
    lib.scat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.scat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B,H,N,D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16 "
                        f"inputs of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    _, _, n, d = q.shape
    if d != HEAD_DIM or not 1 <= n <= MAX_SEQ:
        raise ValueError(f"the attention kernel takes head dim {HEAD_DIM} "
                         f"and 1 <= N <= {MAX_SEQ}, got N={n}, D={d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k, v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Softmax attention on [B,H,N,D]; the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the attention backward kernel comes with the training slice "
            "of the port (ROADMAP.md queue 2, pallas_attention._bwd_kernel)"
            "; run the forward under torch.no_grad or inference_mode")
    _check(q, k, v)
    b, h, n, d = q.shape
    # O is stored [B,N,H,D] and returned as its [B,H,N,D] view, so that
    # the caller's merge of heads back to [B,N,H*D] needs no copy
    o = torch.empty((b, n, h, d), dtype=q.dtype,
                    device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.scat_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, n, d, strides, float(scale), _DTYPE_CODES[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(
            "attention_fwd launch failed: "
            + lib.scat_cuda_error_string(rc).decode())
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
