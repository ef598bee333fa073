"""The port's attention (scat_tpu_torch.ops.attention) against the JAX
package's Pallas kernels in interpret mode, on the CPU.

On CPU tensors ``flash_attention`` and ``attention_bwd`` take their plain
versions, so these tests hold the plain math, the wrapper's routing and
the autograd.Function's wiring; the CUDA kernels themselves are held
against the plain versions on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.ops.pallas_attention as pa
from scat_tpu_torch.kernels import build
from scat_tpu_torch.ops import attention as ta

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pa, "_INTERPRET", True)


def _qkv(rng, b, h, n, d):
    return [rng.randn(b, h, n, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("fn", ["flash_attention", "attention_reference"])
@pytest.mark.parametrize("b,h,n,d", [(2, 8, 21, 64), (1, 4, 128, 64),
                                     (3, 2, 21, 64)])
def test_matches_pallas_forward(rng, fn, b, h, n, d):
    q, k, v = _qkv(rng, b, h, n, d)
    scale = d ** -0.5
    want = pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), scale)
    before = ta.flash_attention.launches
    got = getattr(ta, fn)(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # CPU tensors never launch the kernel
    assert ta.flash_attention.launches == before


BWD_SHAPES = [(2, 2, 21, 64), (1, 3, 128, 64)]
# the persistent wgmma backward's range (64 < N <= 128) at N that are not a
# multiple of 8 or 16
WGMMA_BWD_SHAPES = [(1, 2, 97, 64), (1, 2, 65, 64)]


def _strided(a):
    """[B,H,N,D] numpy -> the same values as a strided [B,H,N,D] view of
    a [B,N,H,D] tensor, as the projection and autograd pass them."""
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3))).permute(0, 2, 1, 3)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("b,h,n,d", BWD_SHAPES + WGMMA_BWD_SHAPES)
def test_bwd_reference_matches_pallas_bwd(rng, b, h, n, d, strided):
    q, k, v, do = [rng.randn(b, h, n, d).astype(np.float32)
                   for _ in range(4)]
    scale = d ** -0.5
    want = pa._flash_bwd(scale, tuple(map(jnp.asarray, (q, k, v))),
                         jnp.asarray(do))
    conv = _strided if strided else torch.from_numpy
    before = ta.attention_bwd.launches
    for fn in (ta.attention_bwd_reference, ta.attention_bwd):
        got = fn(*map(conv, (q, k, v, do)), scale)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL,
                                       err_msg=name)
    assert ta.attention_bwd.launches == before


@pytest.mark.parametrize("b,h,n,d", BWD_SHAPES)
def test_autograd_matches_jax_grad(rng, b, h, n, d):
    """flash_attention's gradients (autograd) against jax.grad through
    the Pallas custom VJP, for a random output cotangent."""
    q, k, v, w = [rng.randn(b, h, n, d).astype(np.float32)
                  for _ in range(4)]
    scale = d ** -0.5
    want = jax.grad(lambda q, k, v: jnp.sum(
        pa._flash_core(q, k, v, scale) * w), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ta.flash_attention(tq, tk, tv, scale)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for name, a, g in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), atol=ATOL,
                                   err_msg=name)


def test_autograd_function_wiring(rng, monkeypatch):
    """The CUDA path's autograd.Function, with the forward launch
    replaced by the plain version (the backward takes it on CPU
    tensors): its gradients are autograd's through the plain forward,
    and a second backward through it raises (once_differentiable)."""
    monkeypatch.setattr(ta, "_attention_fwd", ta.attention_reference)
    b, h, n, d = 2, 2, 21, 64
    q, k, v, w = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
                  for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ta._FlashAttention.apply(*leaves, 0.125)
    got = torch.autograd.grad((out * w).sum(), leaves)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        (ta.attention_reference(*ref, 0.125) * w).sum(), ref)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, atol=ATOL, rtol=0)
    w.requires_grad_(True)
    out = ta._FlashAttention.apply(*leaves, 0.125)
    (dq,) = torch.autograd.grad((out * w).sum(), leaves[0],
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_mask_matches_pallas_fallback(rng):
    """The masked math of the plain version; the kernel and its wrapper
    take no mask, as no model of the port passes one."""
    b, h, n, d = 2, 2, 21, 64
    q, k, v = _qkv(rng, b, h, n, d)
    mask = rng.rand(b, n) > 0.3
    want = pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), d ** -0.5,
                              mask=jnp.asarray(mask))
    got = ta.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), d ** -0.5,
                                 mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_strided_views_match_contiguous(rng):
    """The transformer passes q, k, v as views of the [B,N,3,H,D]
    projection; the result must not depend on the strides."""
    b, n, h, d = 2, 21, 4, 64
    qkv = torch.from_numpy(rng.randn(b, n, 3, h, d).astype(np.float32))
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    got = ta.flash_attention(q, k, v, 0.125)
    want = ta.attention_reference(q.contiguous(), k.contiguous(),
                                  v.contiguous(), 0.125)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def _bf16(a):
    """numpy float32 -> the nearest bf16 values, as float32 numpy."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _split(x):
    """A float32 tensor as its bf16 high part and the bf16 of what that
    leaves (mma.cuh split_bf16), both as float32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _split_product(eq, x, y):
    """The kernels' product of a split float32 operand ``x`` with the bf16
    operand ``y``: the high and the low part's products, summed in
    float32."""
    hi, lo = _split(x)
    return torch.einsum(eq, hi, y) + torch.einsum(eq, lo, y)


def _tensor_core_bwd(q, k, v, do, scale):
    """The arithmetic of the bf16 backward kernel on the CPU: products of
    bf16 values summed in float32, softmax, delta and dS in float32, and
    P and dS split into bf16 high and low parts for the second products
    (dV, dQ, dK); outputs rounded to bf16."""
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    s = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    p = s.softmax(dim=-1)
    dp = torch.einsum("bhid,bhjd->bhij", do, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dv = _split_product("bhij,bhid->bhjd", p, do)
    dq = _split_product("bhij,bhjd->bhid", ds, k) * scale
    dk = _split_product("bhij,bhid->bhjd", ds, q) * scale
    return tuple(t.bfloat16().float().numpy() for t in (dq, dk, dv))


@pytest.mark.parametrize("b,h,n,d", BWD_SHAPES + WGMMA_BWD_SHAPES)
def test_tensor_core_rounding_matches_pallas_bwd(rng, b, h, n, d):
    """bf16 operands through the bf16 kernel's arithmetic (P and dS split
    into bf16 parts for the second products) against the Pallas backward
    in interpret mode at the bf16 tolerance of the card's checks."""
    q, k, v, do = (_bf16(rng.randn(b, h, n, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    want = pa._flash_bwd(scale, tuple(map(jnp.asarray, (q, k, v))),
                         jnp.asarray(do))
    got = _tensor_core_bwd(q, k, v, do, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-2, rtol=1e-2,
                                   err_msg=name)


def _key_major_bwd(q, k, v, do, scale, keys=16):
    """The arithmetic of the persistent wgmma backward on the CPU: S^T and
    dP^T key-major, each warp's ``keys`` keys giving a column max, the
    column sums of e = exp2(s c - max c) and of e dP (c = scale log2 e);
    the warps' partials combined in warp order into the factor
    exp2(max_w c - max c) / sum that turns e into P, and delta = sum(P dP);
    then P and dS split into bf16 parts for dV, dK and dQ, outputs rounded
    to bf16.  Warps past N (all keys masked) hold max -inf and add
    nothing."""
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    c = scale * 1.4426950408889634
    s = torch.einsum("bhjd,bhid->bhji", k, q)  # [keys, queries]
    dp = torch.einsum("bhjd,bhid->bhji", v, do)
    n = s.shape[-2]
    groups = [slice(w, min(w + keys, n)) for w in range(0, 128, keys)]
    mx = [s[..., g, :].amax(dim=-2) if g.start < n
          else torch.full(s[..., 0, :].shape, -float("inf"))
          for g in groups]
    e = [torch.exp2(s[..., g, :] * c - (m * c)[..., None, :])
         for g, m in zip(groups, mx) if g.start < n]
    parts = [(m * c, x.sum(dim=-2), (x * dp[..., g, :]).sum(dim=-2))
             for g, m, x in zip(groups, mx, e)]
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    f = [torch.exp2(m - top) for m, _, _ in parts]
    total = sum(lw * fw for (_, lw, _), fw in zip(parts, f))
    dsum = sum(dw * fw for (_, _, dw), fw in zip(parts, f))
    p = torch.cat([x * (fw / total)[..., None, :]
                   for x, fw in zip(e, f)], dim=-2)
    ds = p * (dp - (dsum / total)[..., None, :])
    dv = _split_product("bhji,bhid->bhjd", p, do)
    dk = _split_product("bhji,bhid->bhjd", ds, q) * scale
    dq = _split_product("bhji,bhjd->bhid", ds, k) * scale
    return tuple(t.bfloat16().float().numpy() for t in (dq, dk, dv))


@pytest.mark.parametrize("b,h,n,d", [(1, 3, 128, 64)] + WGMMA_BWD_SHAPES)
def test_key_major_statistics_match_pallas_bwd(rng, b, h, n, d):
    """The wgmma backward's column statistics (per-warp partials rescaled
    and combined, warps past N masked) emulated on bf16 operands: against
    the Pallas backward in interpret mode at the bf16 tolerance of the
    card's checks, and within 2 bf16 ulps of the float32 plain version."""
    q, k, v, do = (_bf16(rng.randn(b, h, n, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    want = pa._flash_bwd(scale, tuple(map(jnp.asarray, (q, k, v))),
                         jnp.asarray(do))
    got = _key_major_bwd(q, k, v, do, scale)
    plain = ta.attention_bwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v, do)), scale)
    for name, a, w, r in zip(("dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-2, rtol=1e-2,
                                   err_msg=name)
        assert ta.bf16_ulps(torch.from_numpy(a), r).max() <= 2, name


def _tensor_core_fwd(q, k, v, scale):
    """The arithmetic of the bf16 forward kernel on the CPU: products of
    bf16 values summed in float32, softmax in float32, P split into bf16
    high and low parts for P V, O rounded to bf16."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    p = (torch.einsum("bhid,bhjd->bhij", q, k) * scale).softmax(dim=-1)
    o = _split_product("bhij,bhjd->bhid", p, v)
    return o.bfloat16().float().numpy()


@pytest.mark.parametrize("b,h,n,d", BWD_SHAPES)
def test_tensor_core_rounding_matches_pallas_fwd(rng, b, h, n, d):
    """bf16 operands through the bf16 forward kernel's arithmetic (P split
    into bf16 parts for P V) against the Pallas forward in interpret mode
    at the bf16 tolerance of the card's checks."""
    q, k, v = (_bf16(rng.randn(b, h, n, d).astype(np.float32))
               for _ in range(3))
    scale = d ** -0.5
    want = pa._flash_fwd_impl(*map(jnp.asarray, (q, k, v)), scale)
    got = _tensor_core_fwd(q, k, v, scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("b,h,n,d", BWD_SHAPES)
def test_split_p_within_two_bf16_ulps(rng, b, h, n, d):
    """The kernels' split-P arithmetic (emulated above) holds the card's
    bar: within 2 bf16 ulps (``bf16_ulps``) of the float32 plain versions
    rounded to bf16, forward and backward; P rounded to bf16 once, the
    design before, does not, so the bar tells the two apart."""
    q, k, v, do = (_bf16(rng.randn(b, h, n, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    want = [ta.attention_reference(*t[:3], scale),
            *ta.attention_bwd_reference(*t, scale)]
    got = [_tensor_core_fwd(q, k, v, scale),
           *_tensor_core_bwd(q, k, v, do, scale)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert ta.bf16_ulps(torch.from_numpy(g), w).max() <= 2, name
    p = (t[0] @ t[1].transpose(-1, -2) * scale).softmax(-1)
    rounded = (p.bfloat16().float() @ t[2]).bfloat16()
    assert ta.bf16_ulps(rounded, want[0]).max() > 2


def test_unaligned_bf16_rows_are_copied(rng):
    """The bf16 kernels take 16-byte aligned rows: a bf16 operand whose
    rows are not is copied (same values, contiguous), aligned ones and
    float32 ones are passed as they are."""
    even = torch.from_numpy(rng.randn(2, 3, 5, 64).astype(np.float32))
    even = even.bfloat16()
    odd = torch.zeros(even.numel() + 3, dtype=torch.bfloat16)[3:]
    odd = odd.view(2, 3, 5, 64).copy_(even)
    assert not ta._rows_aligned(odd) and ta._rows_aligned(even)
    got = ta._aligned(odd, even)
    assert ta._rows_aligned(got[0]) and torch.equal(got[0], odd)
    assert got[1] is even
    f32 = odd.float()
    assert ta._aligned(f32)[0] is f32


@pytest.mark.parametrize("n", [1, 21, 64, 65, 80, 100, 127, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_plan_designs(n, dtype):
    """The forward kernel each (N, dtype) takes: float32 the CUDA-core
    kernel and bf16 N <= 64 the mma.sync one, a block a (batch, head)
    pair; bf16 N from 65 to 128 the persistent wgmma kernel."""
    design, grid = ta.forward_plan(n, dtype, 768, 132)
    if dtype == torch.float32:
        assert (design, grid) == ("f32", 768)
    elif n <= 64:
        assert (design, grid) == ("bf16_tiles", 768)
    else:
        assert design == "bf16_wgmma" and grid == 132
    with pytest.raises(ValueError):
        ta.forward_plan(129, dtype, 768, 132)


@pytest.mark.parametrize("pairs", [1, 7 * 8, 64 * 8, 96 * 8, 133, 265])
def test_persistent_grid_visits_every_pair_once(pairs):
    """The persistent forward on 132 SMs: one block an SM, never more
    blocks than pairs; block i takes pairs i, i + grid, ...: every pair
    once, and no block more than one pair more than another."""
    design, grid = ta.forward_plan(128, torch.bfloat16, pairs, 132)
    assert design == "bf16_wgmma"
    assert grid == min(pairs, 132 * ta.WGMMA_BLOCKS_PER_SM)
    # the kernel's walk: block i takes pairs i, i + grid, ...
    walks = [list(range(b, pairs, grid)) for b in range(grid)]
    visited = sorted(p for walk in walks for p in walk)
    assert visited == list(range(pairs))
    counts = [len(walk) for walk in walks]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    assert max(counts) == -(-pairs // grid)


@pytest.mark.parametrize("n", [1, 21, 64, 65, 80, 97, 100, 127, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plan_designs(n, dtype):
    """The backward kernel each (N, dtype) takes: float32 the CUDA-core
    kernel and bf16 N <= 64 the mma.sync one, a block a (batch, head)
    pair; bf16 N from 65 to 128 the persistent key-major wgmma kernel."""
    design, grid = ta.backward_plan(n, dtype, 768, 132)
    if dtype == torch.float32:
        assert (design, grid) == ("f32", 768)
    elif n <= 64:
        assert (design, grid) == ("bf16_tiles", 768)
    else:
        assert design == "bf16_wgmma" and grid == 132
    assert (design, grid) == ta.forward_plan(n, dtype, 768, 132)
    with pytest.raises(ValueError, match="backward"):
        ta.backward_plan(129, dtype, 768, 132)


@pytest.mark.parametrize("pairs", [1, 7 * 8, 64 * 8, 96 * 8, 133, 265])
def test_persistent_backward_grid_visits_every_pair_once(pairs):
    """The persistent backward on 132 SMs walks the pairs as the forward
    does: one block an SM, never more blocks than pairs, block i taking
    pairs i, i + grid, ...: every pair once, no block more than one pair
    more than another."""
    design, grid = ta.backward_plan(128, torch.bfloat16, pairs, 132)
    assert design == "bf16_wgmma"
    assert grid == min(pairs, 132 * ta.WGMMA_BLOCKS_PER_SM)
    walks = [list(range(b, pairs, grid)) for b in range(grid)]
    assert sorted(p for walk in walks for p in walk) == list(range(pairs))
    counts = [len(walk) for walk in walks]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


def test_other_devices_raise():
    q = torch.empty(1, 8, 21, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ta.flash_attention(q, q, q, 0.125)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ta.attention_bwd(q, q, q, q, 0.125)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_library_path_keyed_by_source(monkeypatch, tmp_path):
    """An edited source or shared header (csrc/*.cuh) gets a new library
    path (a rebuild), an unchanged one the same path."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    header = tmp_path / "shared.cuh"
    header.write_text("// helpers")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    first = build.library_path("k")
    assert build.library_path("k") == first
    src.write_text("// two")
    second = build.library_path("k")
    assert second != first
    header.write_text("// helpers, edited")
    assert build.library_path("k") not in (first, second)
    assert first.startswith(build.BUILD_DIR) and first.endswith(".so")


# the shared headers each source includes: mma.cuh in every one;
# attention.cuh in the two attention kernels'; tma.cuh in those with a
# TMA-fed kernel (the persistent forward and backward, the bf16 stats,
# the fused link; not the FAVOR+ backward's, which reads its rows into
# registers)
SOURCE_HEADERS = {
    "attention_fwd": ("mma.cuh", "attention.cuh", "tma.cuh"),
    "attention_bwd": ("mma.cuh", "attention.cuh", "tma.cuh"),
    "favor": ("mma.cuh", "tma.cuh"),
    "favor_bwd": ("mma.cuh",),
    "fused_link": ("mma.cuh", "tma.cuh"),
}


def test_sources_have_their_headers():
    """Every source the build compiles exists and includes the shared
    headers of SOURCE_HEADERS and no other, each one that the library
    path hashes."""
    assert set(build.SOURCES) == set(SOURCE_HEADERS)
    for name in build.SOURCES:
        assert os.path.exists(os.path.join(build.CSRC_DIR, f"{name}.cu"))
    for name, wanted in SOURCE_HEADERS.items():
        with open(os.path.join(build.CSRC_DIR, f"{name}.cu")) as f:
            src = f.read()
        for header in ("mma.cuh", "attention.cuh", "tma.cuh"):
            assert (f'#include "{header}"' in src) == (header in wanted), \
                (name, header)
    for header in ("mma.cuh", "attention.cuh", "tma.cuh"):
        assert os.path.exists(os.path.join(build.CSRC_DIR, header))
        assert os.path.join(build.CSRC_DIR, header) in build.headers()
