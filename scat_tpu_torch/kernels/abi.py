"""What the kernel wrappers share about the plain C interface of the
libraries under ``csrc/``: the dtype codes, the (batch, head, row)
element strides of [B,H,N,D] operands, and the error check after a
launch (every library exports ``scat_cuda_error_string``)."""

from __future__ import annotations

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def strides(*ts: torch.Tensor):
    """The (batch, head, row) element strides of [B,H,N,D] operands, in
    order, as a C array of long long."""
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(s for t in ts for s in t.stride()[:3]))


def raise_on(rc: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise with the CUDA error's text if a launch returned ``rc`` != 0."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.scat_cuda_error_string(rc).decode())
