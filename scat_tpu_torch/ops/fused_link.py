"""The 1x1-convolution link of a bottleneck, fused: the previous
BatchNorm's apply and ReLU, the 1x1 convolution as a product, and this
BatchNorm's column statistics, in one kernel.

The port of the Pallas TPU kernel ``_link_kernel``
(``benchmarks/probe_fused_link.py:31-52``), launched by ``fused_link``
:55-82 (``pl.pallas_call`` :66).  The JAX package probed it as a
replacement for the decomposed chain and kept the chain; no model path
calls it there, and none calls it here.  For x [M, K] bf16 (an NHWC
activation seen as rows: the [M, K] view of a channels_last map is
contiguous and is taken as it is), w [K, N] bf16 and scale, shift [K]
float32:

    xn  = bf16(relu(x * scale + shift))     (float32, then rounded)
    acc = xn @ w                            (float32 accumulation)
    y   = bf16(acc)                         [M, N]
    s   = sum over rows of acc,  ss = sum over rows of acc^2   [N] float32

The statistics come from the float32 accumulator before y is rounded,
as in the TPU kernel; the probe's ``xla_link`` takes them from the
rounded y, which is not the kernel's function.  ``fused_link_reference``
is the plain version.  The kernel is ``csrc/fused_link.cu``; what bounds
it and how it is laid out is written there.  ``link_plan`` chooses its
tiles, ring and grid for each (M, K, N).  Where the JAX function takes M
in whole tiles of 128 rows or more (and refuses other M), the port takes
every M >= 1: rows past M are masked.  K is at most 12,480 (17,600 where
N <= 64): a block holds scale and shift in shared memory beside its ring,
and ``link_plan`` refuses a larger K (ResNet-50's largest is 2048).

The kernel is a ``torch.library`` custom op, ``scat_tpu_torch::
fused_link``: a CUDA implementation (the launch, the workspace of the
blocks' partial statistics, the counter), a CPU implementation (the
plain version) and a fake giving the outputs' shapes.  ``fused_link``
calls the op: CUDA tensors launch the kernel or raise, never falling
back; CPU tensors take the plain version.  Forward only, as the TPU
kernel.  The launch counter is ``fused_link.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from scat_tpu_torch.kernels import abi, build
from scat_tpu_torch.ops import counted

# the kernel's tiles and shared memory (csrc/fused_link.cu): M-tiles of 64
# rows, k slices of 64, a ring stage of one x box (8 KB) for each consumer
# warpgroup (2 or 3) and, where w streams, the slice's w; 3 to 8 stages; a
# staging tile of 16 rows for each consumer warp; what a block of an H100
# may take
TILE_ROWS = SLICE = 64
BOX_BYTES = TILE_ROWS * SLICE * 2
MIN_STAGES, MAX_STAGES = 3, 8
SMEM_LIMIT = 232448
# a third consumer warpgroup where a tile's products are many against its
# bytes: K * bn / (K + bn) flop for each bf16 of x read and y written at
# or above this (on an H100 at 700 W it helped at 64 and above and cost at
# 51 and below: PERF.md §6)
DENSE_TILE = 60
# what the kernel is held to against the plain version (float32 sums in
# another order): y within 1 bf16 ulp at max|y|; s within 1e-5 of the
# column's sum of |y|, ss within 2e-5 of itself, each plus one row's
# float32 rounding, 1e-6 of the largest sum of |xn w| over k a row takes
# (a column's s at M = 1 is one dot product, which cancellation can leave
# far smaller than its terms)
Y_ULPS, S_TOL, SS_RTOL, ROW_TOL = 1.0, 1e-5, 2e-5, 1e-6


def fused_link_reference(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The kernel's plain version: (y [M, N] bf16, s [N], ss [N]
    float32) with xn = bf16(relu(x * scale + shift)) in float32, the
    product in float32 from the bf16 operands (IEEE float32 on the card
    where TF32 is off), and s, ss the column sums of the float32 product
    and of its square."""
    with torch.autocast(x.device.type, enabled=False):
        xn = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
        acc = xn.float() @ w.float()
        return acc.to(torch.bfloat16), acc.sum(dim=0), (acc * acc).sum(dim=0)


def link_gaps(got, want, x: torch.Tensor, w: torch.Tensor,
              scale: torch.Tensor, shift: torch.Tensor) -> dict:
    """How far the link's outputs ``got`` = (y, s, ss) lie from ``want``,
    each as its largest share of its bound (at most 1 passes): y against
    ``Y_ULPS`` bf16 ulps at max|want y|, s and ss column by column against
    ``S_TOL`` and ``SS_RTOL`` plus one row's rounding (``ROW_TOL``),
    computed in float64 from the inputs x, w, scale and shift."""
    y, s, ss = (t.double() for t in got)
    wy, ws, wss = (t.double() for t in want)
    with torch.autocast(x.device.type, enabled=False):
        xn = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
        row = (xn.double().abs() @ w.double().abs()).amax(dim=0)
    tiny = torch.finfo(torch.float64).tiny
    ulp = torch.exp2(torch.floor(torch.log2(wy.abs().max().clamp(min=tiny)))
                     - 7)
    s_bound = S_TOL * wy.abs().sum(dim=0) + ROW_TOL * row
    ss_bound = SS_RTOL * wss + 2 * ROW_TOL * row * wy.abs().amax(dim=0)
    return {"y": ((y - wy).abs().max() / (Y_ULPS * ulp)).item(),
            "s": ((s - ws).abs() / s_bound.clamp(min=tiny)).max().item(),
            "ss": ((ss - wss).abs() / ss_bound.clamp(min=tiny)).max().item()}


def smem_bytes(k: int, bn: int, groups: int, resident: bool,
               stages: int) -> int:
    """The kernel's dynamic shared memory for a plan (csrc/fused_link.cu
    ``smem_bytes``): 1 KB of alignment slack, the ring, w's resident [K
    x bn] slice, the consumer warps' staging tiles, scale and shift, and
    the barriers."""
    k_pad = -(-k // SLICE) * SLICE
    stage = groups * BOX_BYTES + (0 if resident else SLICE * bn * 2)
    return (1024 + stages * stage + (k_pad * bn * 2 if resident else 0)
            + 4 * groups * 16 * bn * 2 + 8 * k_pad + 8 * (2 * stages + 1))


class LinkPlan(NamedTuple):
    """How the kernel cuts (M, K, N): tiles of 64 rows x ``bn`` columns,
    one each for ``groups`` consumer warpgroups at a time; w's [K x bn]
    slice ``resident`` in shared memory (else streamed through the ring);
    ``stages`` ring stages; ``ranges`` N-ranges of ``per_range`` blocks
    each (the grid), each block walking the 64-row M-tiles q, q +
    per_range, ...; ``rounds`` the M-tiles of the busiest block; ``fill``
    the share of the SMs' block slots that do work over all rounds;
    ``smem`` the kernel's dynamic shared memory."""
    bn: int
    groups: int
    resident: bool
    stages: int
    ranges: int
    per_range: int
    m_tiles: int
    rounds: int
    fill: float
    smem: int

    @property
    def grid(self) -> int:
        return self.ranges * self.per_range

    def workspace(self, n: int) -> int:
        """float32 elements of the partial statistics: one row of s
        and one of ss a block of a range."""
        return 2 * self.per_range * n


def link_plan(m: int, k: int, n: int, sms: int = 132) -> LinkPlan:
    """The kernel's plan for x [m, k] and w [k, n] on a card of ``sms``
    SMs: N-tiles of 128 columns (64 where n <= 64: the widest whose
    accumulators stay in a thread's registers, so x is read and its
    prologue applied once an N-range); w resident where its slice fits
    beside a ring of 3 stages for 2 consumer warpgroups; 3 warpgroups
    where the tile is dense (``DENSE_TILE``: a warpgroup's slices run one
    after another, so a third keeps more products in flight) and they
    still fit, else 2 and a deeper ring; the deepest ring that fits (at
    most 8); blocks split evenly over the N-ranges, at most one an SM and
    one an M-tile."""
    bn = 64 if n <= 64 else 128
    resident = smem_bytes(k, bn, 2, True, MIN_STAGES) <= SMEM_LIMIT
    dense = k * bn >= DENSE_TILE * (k + bn)
    groups = 3 if dense and smem_bytes(k, bn, 3, resident,
                                       MIN_STAGES) <= SMEM_LIMIT else 2
    fits = [st for st in range(MIN_STAGES, MAX_STAGES + 1)
            if smem_bytes(k, bn, groups, resident, st) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"fused_link: no plan fits K={k} in a block's "
                         f"shared memory")
    ranges = -(-n // bn)
    m_tiles = -(-m // TILE_ROWS)
    per_range = max(1, min(sms // ranges, m_tiles))
    rounds = -(-m_tiles // per_range)
    fill = m_tiles * ranges / (rounds * max(sms, ranges * per_range))
    return LinkPlan(bn, groups, resident, fits[-1], ranges, per_range,
                    m_tiles, rounds, fill,
                    smem_bytes(k, bn, groups, resident, fits[-1]))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("fused_link")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scat_fused_link.argtypes = ([ptr] * 8 + [i32] * 3 + [i64] * 2
                                    + [i32] * 5 + [ptr])
    lib.scat_fused_link.restype = i32
    lib.scat_fused_link_reduce.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.scat_fused_link_reduce.restype = i32
    lib.scat_fused_link_smem.argtypes = [i32] * 5
    lib.scat_fused_link_smem.restype = i64
    lib.scat_cuda_error_string.argtypes = [i32]
    lib.scat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
           shift: torch.Tensor) -> None:
    """x [M, K] and w [K, N] bf16, scale and shift [K] float32 and
    contiguous, on one device; M >= 1; K and N multiples of 8, so that
    every row is whole 16-byte chunks; x's and w's rows contiguous and
    starting on 16 bytes."""
    ts = (x, w, scale, shift)
    if len({t.device for t in ts}) != 1 or x.device.type not in ("cuda",
                                                                 "cpu"):
        raise ValueError(f"fused_link runs on cuda or cpu tensors of one "
                         f"device, got {[str(t.device) for t in ts]}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"fused_link takes bf16 x and w, got {x.dtype} and "
                        f"{w.dtype}")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError(f"fused_link takes float32 scale and shift, got "
                        f"{scale.dtype} and {shift.dtype}")
    if (x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]
            or scale.shape != (x.shape[1],) or shift.shape != scale.shape):
        raise ValueError(f"fused_link takes x [M, K], w [K, N], scale and "
                         f"shift [K], got {tuple(x.shape)}, {tuple(w.shape)},"
                         f" {tuple(scale.shape)} and {tuple(shift.shape)}")
    (m, k), n = x.shape, w.shape[1]
    if m < 1 or k < 8 or n < 8 or k % 8 or n % 8:
        raise ValueError(f"fused_link takes M >= 1 and K, N multiples of 8 "
                         f"(16-byte rows), got M={m}, K={k}, N={n}")
    for name, t in (("x", x), ("w", w)):
        if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(
                f"fused_link's {name} rows must be contiguous and start on "
                f"16 bytes: got strides {t.stride()} at address "
                f"{t.data_ptr()} (a row stride not a multiple of 8 "
                f"elements is not 16-byte aligned)")
    if scale.stride(0) != 1 or shift.stride(0) != 1:
        raise ValueError("fused_link's scale and shift must be contiguous")


@torch.library.custom_op("scat_tpu_torch::fused_link", mutates_args=(),
                         device_types="cuda")
def _fused_link(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors (counted), by ``link_plan``'s plan.
    Rows that overlap (a row stride below K or N: a broadcast) are copied
    first: the tensor maps take no such stride."""
    _check(x, w, scale, shift)
    (m, k), n = x.shape, w.shape[1]
    if m > 1 and x.stride(0) < k:
        x = x.contiguous()
    if w.stride(0) < n:
        w = w.contiguous()
    plan = link_plan(m, k, n, _sms(x.device.index))
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    s = torch.empty(n, dtype=torch.float32, device=x.device)
    ss = torch.empty(n, dtype=torch.float32, device=x.device)
    # each block's partial s and ss, summed by the second launch
    work = torch.empty(plan.workspace(n), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().scat_fused_link(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), s.data_ptr(), ss.data_ptr(), work.data_ptr(), m,
            k, n, x.stride(0), w.stride(0), plan.bn, plan.groups,
            int(plan.resident), plan.stages, plan.per_range,
            torch.cuda.current_stream(x.device).cuda_stream)
    abi.raise_on(rc, _library(), "fused_link")
    fused_link.launches += 1
    return y, s, ss


@_fused_link.register_kernel("cpu")
def _(x, w, scale, shift):
    return fused_link_reference(x, w, scale, shift)


@_fused_link.register_fake
def _(x, w, scale, shift):
    m, n = x.shape[0], w.shape[1]
    return (x.new_empty((m, n)), scale.new_empty((n,)),
            scale.new_empty((n,)))


def fused_link(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [M, N] bf16, s [N], ss [N] float32) of the link for x [M, K]
    and w [K, N] bf16 and scale, shift [K] float32: the kernel on CUDA
    tensors, the plain version on CPU tensors; other devices, and what
    ``_check`` refuses, raise."""
    _check(x, w, scale, shift)
    return _fused_link(x, w, scale, shift)


counted(fused_link)
