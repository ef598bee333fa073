"""The port's CUDA kernels (the fused link's too) and their custom ops,
and its loaders, stage-2 mix, Evaluator, demo, GroupNorm flagship,
coarse head, 128-token heads, ViT, MANO decode, adversarial step and a
served artifact's CUDA graphs, on the card (marker ``cuda``; skipped
without a CUDA device).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's stack.  There the repository's
conftest (which sets JAX up) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.data import stb
from scat_tpu_torch.data.multi import concat_dataset
from scat_tpu_torch.data.synthetic import SyntheticDataset
from scat_tpu_torch.evaluation import demo
from scat_tpu_torch.evaluation.evaluator import Evaluator
from scat_tpu_torch.models import build_model, mano
from scat_tpu_torch.models.discriminator import MotionDiscriminator
from scat_tpu_torch.models.hand_net import (
    EncoderTransformer, EncoderTransformerCoarse, EncoderTransformerHRNet,
    EncoderTransformerInception, H3DWEncoder, H3DWJointsEncoder)
from scat_tpu_torch.ops import favor
from scat_tpu_torch.ops import fused_link as fl
from scat_tpu_torch.ops.attention import (attention_bwd,
                                          attention_bwd_reference,
                                          attention_reference, bf16_ulps,
                                          flash_attention)
from scat_tpu_torch.training import adversarial, schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.utils import checkpoint
from dataset_trees import (write_frei_tree, write_ho3d_tree, write_mhp_tree,
                           write_rhd_tree)
from stb_tree import TRAIN_SEQS, _smooth, write_stb_tree

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    """q, k, v as the strided views the transformer passes."""
    b, h, n, d = shape
    g = np.random.RandomState(seed)
    qkv = torch.from_numpy(g.randn(b, n, 3, h, d).astype(np.float32))
    return qkv.to(device, dtype).permute(2, 0, 3, 1, 4)


@pytest.mark.parametrize("shape", [(1, 8, 21, 64), (64, 8, 21, 64),
                                   (2, 4, 128, 64), (3, 2, 21, 64),
                                   (96, 8, 128, 64)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
def test_kernel_matches_plain(cuda, shape, dtype, atol):
    q, k, v = _qkv(shape, dtype, cuda)
    before = flash_attention.launches
    with torch.no_grad():
        got = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), 0.125)
    assert got.dtype == dtype and got.shape == shape
    torch.testing.assert_close(got.float(), want, atol=atol,
                               rtol=atol if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("shape", [(1, 8, 21, 64), (96, 8, 21, 64),
                                   (2, 4, 128, 64), (3, 2, 21, 64),
                                   (96, 8, 128, 64)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
def test_backward_kernel_matches_plain(cuda, shape, dtype, atol):
    q, k, v = _qkv(shape, dtype, cuda)
    g = np.random.RandomState(1)
    # dO as autograd delivers it after the merge of heads: [B,N,H,D]
    # storage seen as [B,H,N,D]
    do = torch.from_numpy(g.randn(shape[0], shape[2], shape[1],
                                  shape[3]).astype(np.float32))
    do = do.to(cuda, dtype).permute(0, 2, 1, 3)
    before = attention_bwd.launches
    got = attention_bwd(q, k, v, do, 0.125)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    want = attention_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == shape, name
        torch.testing.assert_close(
            a.float(), b, atol=atol,
            rtol=atol if dtype == torch.bfloat16 else 0, msg=name)


@pytest.mark.parametrize("n", [1, 16, 17, 21, 32, 33, 64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
def test_backward_kernel_sequence_lengths(cuda, n, dtype, atol):
    """N at and around the bf16 kernel's 16-row tiles (one to eight warps
    a head), against the plain version on the float32 values."""
    shape = (3, 2, n, 64)
    q, k, v = _qkv(shape, dtype, cuda, seed=n)
    g = np.random.RandomState(100 + n)
    do = torch.from_numpy(g.randn(3, n, 2, 64).astype(np.float32))
    do = do.to(cuda, dtype).permute(0, 2, 1, 3)
    got = attention_bwd(q, k, v, do, 0.125)
    torch.cuda.synchronize()
    want = attention_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == shape, name
        torch.testing.assert_close(
            a.float(), b, atol=atol,
            rtol=atol if dtype == torch.bfloat16 else 0, msg=name)


@pytest.mark.parametrize("n", [1, 16, 17, 21, 32, 33, 64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
def test_forward_kernel_sequence_lengths(cuda, n, dtype, atol):
    """N at and around the bf16 forward kernel's 16-row tiles (one to
    eight warps a head), against the plain version on the float32
    values."""
    shape = (3, 2, n, 64)
    q, k, v = _qkv(shape, dtype, cuda, seed=n)
    with torch.no_grad():
        got = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    want = attention_reference(q.float(), k.float(), v.float(), 0.125)
    assert got.dtype == dtype and got.shape == shape
    torch.testing.assert_close(got.float(), want, atol=atol,
                               rtol=atol if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("shape", [(96, 8, 21, 64), (2, 4, 128, 64),
                                   (3, 2, 1, 64), (3, 2, 17, 64),
                                   (3, 2, 33, 64), (96, 8, 128, 64)])
def test_bf16_kernels_within_two_ulps(cuda, shape):
    """P (and in the backward dS) split into bf16 high and low parts: the
    bf16 forward and backward lie within 2 bf16 ulps (``bf16_ulps``) of
    the float32 plain versions on the same bf16 inputs, rounded to
    bf16."""
    q, k, v = _qkv(shape, torch.bfloat16, cuda, seed=sum(shape))
    g = np.random.RandomState(2)
    do = torch.from_numpy(g.randn(shape[0], shape[2], shape[1],
                                  shape[3]).astype(np.float32))
    do = do.to(cuda, torch.bfloat16).permute(0, 2, 1, 3)
    with torch.no_grad():
        out = flash_attention(q, k, v, 0.125)
    grads = attention_bwd(q, k, v, do, 0.125)
    torch.cuda.synchronize()
    want = [attention_reference(q.float(), k.float(), v.float(), 0.125),
            *attention_bwd_reference(q.float(), k.float(), v.float(),
                                     do.float(), 0.125)]
    for name, got, w in zip(("o", "dq", "dk", "dv"), (out, *grads), want):
        assert bf16_ulps(got, w).max().item() <= 2, name


# the persistent wgmma forward's sequence lengths (64 < N <= 128)
WGMMA_SEQS = [65, 80, 100, 127, 128]


@pytest.mark.parametrize("n", WGMMA_SEQS)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
def test_wgmma_forward_sequence_lengths(cuda, n, dtype, atol):
    """N across the persistent forward's range, against the plain version
    on the float32 values; bf16 within 2 bf16 ulps of it (float32 takes
    the CUDA-core kernel)."""
    shape = (5, 8, n, 64)
    q, k, v = _qkv(shape, dtype, cuda, seed=300 + n)
    with torch.no_grad():
        got = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    want = attention_reference(q.float(), k.float(), v.float(), 0.125)
    assert got.dtype == dtype and got.shape == shape
    torch.testing.assert_close(got.float(), want, atol=atol,
                               rtol=atol if dtype == torch.bfloat16 else 0)
    if dtype == torch.bfloat16:
        assert bf16_ulps(got, want).max().item() <= 2


@pytest.mark.parametrize("b,h", [(1, 1), (7, 8), (133, 1), (265, 1),
                                 (67, 4), (96, 8)])
def test_wgmma_forward_pair_counts(cuda, b, h):
    """B*H pairs that are not a multiple of the persistent grid (132 on an
    H100): every pair computed once, each equal to its own launch."""
    from scat_tpu_torch.ops.attention import forward_plan, kernel_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernel_plan(128, torch.bfloat16, b * h, sms) == forward_plan(
        128, torch.bfloat16, b * h, sms)
    q, k, v = _qkv((b, h, 100, 64), torch.bfloat16, cuda, seed=b * h)
    with torch.no_grad():
        got = flash_attention(q, k, v, 0.125)
        one = flash_attention(q[:1], k[:1], v[:1], 0.125)
    torch.cuda.synchronize()
    want = attention_reference(q.float(), k.float(), v.float(), 0.125)
    assert bf16_ulps(got, want).max().item() <= 2
    assert torch.equal(got[:1], one)


def test_forward_plans_match_the_library(cuda):
    """forward_plan (the CPU tests hold it) is what the library's host
    code computes, for every design."""
    from scat_tpu_torch.ops.attention import forward_plan, kernel_plan
    for n in (1, 21, 64, 65, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for pairs, sms in ((1, 132), (768, 132), (265, 132), (50, 8)):
                assert kernel_plan(n, dtype, pairs, sms) == forward_plan(
                    n, dtype, pairs, sms), (n, dtype, pairs, sms)


# the persistent wgmma backward's sequence lengths (64 < N <= 128)
WGMMA_BWD_SEQS = sorted(set(WGMMA_SEQS) | {97})


def _grad_out(b, h, n, dtype, device, seed):
    """dO as autograd delivers it after the merge of heads: [B,N,H,D]
    storage seen as [B,H,N,D]."""
    g = np.random.RandomState(seed)
    do = torch.from_numpy(g.randn(b, n, h, 64).astype(np.float32))
    return do.to(device, dtype).permute(0, 2, 1, 3)


@pytest.mark.parametrize("n", WGMMA_BWD_SEQS)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
def test_wgmma_backward_sequence_lengths(cuda, n, dtype, atol):
    """N across the persistent backward's range, against the plain version
    on the float32 values; bf16 within 2 bf16 ulps of it (float32 takes
    the CUDA-core kernel)."""
    shape = (5, 8, n, 64)
    q, k, v = _qkv(shape, dtype, cuda, seed=400 + n)
    do = _grad_out(5, 8, n, dtype, cuda, seed=500 + n)
    got = attention_bwd(q, k, v, do, 0.125)
    torch.cuda.synchronize()
    want = attention_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), 0.125)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == shape, name
        torch.testing.assert_close(
            a.float(), w, atol=atol,
            rtol=atol if dtype == torch.bfloat16 else 0, msg=name)
        if dtype == torch.bfloat16:
            assert bf16_ulps(a, w).max().item() <= 2, name


@pytest.mark.parametrize("b,h", [(1, 1), (7, 8), (133, 1), (265, 1),
                                 (67, 4)])
def test_wgmma_backward_pair_counts(cuda, b, h):
    """B*H pairs that are not a multiple of the persistent grid: every
    pair computed once, within 2 bf16 ulps, each equal to its own launch;
    the launch plan is backward_plan's."""
    from scat_tpu_torch.ops.attention import backward_plan, kernel_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernel_plan(128, torch.bfloat16, b * h, sms,
                       name="attention_bwd") == backward_plan(
        128, torch.bfloat16, b * h, sms)
    q, k, v = _qkv((b, h, 100, 64), torch.bfloat16, cuda, seed=b * h)
    do = _grad_out(b, h, 100, torch.bfloat16, cuda, seed=b + h)
    got = attention_bwd(q, k, v, do, 0.125)
    one = attention_bwd(q[:1], k[:1], v[:1], do[:1], 0.125)
    torch.cuda.synchronize()
    want = attention_bwd_reference(q.float(), k.float(), v.float(),
                                   do.float(), 0.125)
    for name, a, w, o in zip(("dq", "dk", "dv"), got, want, one):
        assert bf16_ulps(a, w).max().item() <= 2, name
        assert torch.equal(a[:1], o), name


def test_backward_plans_match_the_library(cuda):
    """backward_plan (the CPU tests hold it) is what the library's host
    code computes, for every design."""
    from scat_tpu_torch.ops.attention import backward_plan, kernel_plan
    for n in (1, 21, 64, 65, 97, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for pairs, sms in ((1, 132), (768, 132), (265, 132), (50, 8)):
                assert kernel_plan(n, dtype, pairs, sms,
                                   name="attention_bwd") == backward_plan(
                    n, dtype, pairs, sms), (n, dtype, pairs, sms)


@pytest.mark.parametrize("shape", [(96, 8, 128, 64), (5, 8, 97, 64)])
def test_wgmma_backward_bit_deterministic(cuda, shape):
    """No atomics and a fixed order of every sum (the column statistics
    combined in warp order): two launches agree bit for bit."""
    b, h, n, _ = shape
    q, k, v = _qkv(shape, torch.bfloat16, cuda, seed=n)
    do = _grad_out(b, h, n, torch.bfloat16, cuda, seed=n + 1)
    first = attention_bwd(q, k, v, do, 0.125)
    again = attention_bwd(q, k, v, do, 0.125)
    assert all(torch.equal(a, c) for a, c in zip(first, again))


def _unaligned(x):
    """x's values in a [B,H,N,D] tensor whose rows start 6 bytes past
    16-byte boundaries."""
    flat = torch.zeros(x.numel() + 3, device=x.device, dtype=x.dtype)
    odd = flat[3:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 != 0
    return odd


def test_forward_kernel_copies_unaligned_rows(cuda):
    """bf16 rows that do not start on 16 bytes are copied before the
    forward kernel's 16-byte loads; the result is the aligned operands'."""
    q, k, v = _qkv((2, 2, 21, 64), torch.bfloat16, cuda)
    with torch.no_grad():
        got = flash_attention(_unaligned(q), k, _unaligned(v), 0.125)
        want = flash_attention(q.contiguous(), k, v.contiguous(), 0.125)
    assert torch.equal(got, want)


def test_wgmma_forward_copies_unaligned_rows(cuda):
    """At N = 128 (the persistent kernel's TMA copies) bf16 rows that do
    not start on 16 bytes are copied first; the result is the aligned
    operands'."""
    q, k, v = _qkv((3, 8, 128, 64), torch.bfloat16, cuda, seed=5)
    with torch.no_grad():
        got = flash_attention(_unaligned(q), _unaligned(k), v, 0.125)
        want = flash_attention(q.contiguous(), k.contiguous(), v, 0.125)
    assert torch.equal(got, want)


def test_backward_kernel_copies_unaligned_rows(cuda):
    """bf16 rows that do not start on 16 bytes are copied before the
    kernel's 16-byte loads; the result is the aligned operands'."""
    q, k, v = _qkv((2, 2, 21, 64), torch.bfloat16, cuda)
    flat = torch.zeros(2 * 2 * 21 * 64 + 3, device=cuda,
                       dtype=torch.bfloat16)
    odd = flat[3:].view(2, 2, 21, 64)
    odd.copy_(q)
    assert odd.data_ptr() % 16 != 0
    do = torch.randn(2, 2, 21, 64, device=cuda).bfloat16()
    got = attention_bwd(odd, k, v, do, 0.125)
    want = attention_bwd(q.contiguous(), k, v, do, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wgmma_backward_copies_unaligned_rows(cuda):
    """At N = 128 (the persistent backward's TMA copies) bf16 rows that do
    not start on 16 bytes are copied first; the result is the aligned
    operands'."""
    q, k, v = _qkv((3, 8, 128, 64), torch.bfloat16, cuda, seed=6)
    do = _grad_out(3, 8, 128, torch.bfloat16, cuda, seed=7)
    got = attention_bwd(_unaligned(q), k, _unaligned(v), _unaligned(do),
                        0.125)
    want = attention_bwd(q.contiguous(), k, v.contiguous(), do.contiguous(),
                         0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_autograd_through_kernels(cuda):
    """flash_attention's gradients against autograd through the plain
    version (float32, TF32 off); a second backward raises."""
    q, k, v = (t.detach().clone().requires_grad_(True)
               for t in _qkv((4, 8, 21, 64), torch.float32, cuda))
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    out = flash_attention(q, k, v, 0.125)
    w = torch.randn_like(out)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    assert flash_attention.launches == fwd + 1
    assert attention_bwd.launches == bwd + 1
    want = torch.autograd.grad(
        (attention_reference(q, k, v, 0.125) * w).sum(), (q, k, v))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    # dO depends on a tensor that requires grad, as in the pl_reg probe
    w.requires_grad_(True)
    out = flash_attention(q, k, v, 0.125)
    (dq,) = torch.autograd.grad((out * w).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 21, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), 0.125)
    wide = torch.zeros(1, 2, 129, 64, device=cuda)
    with pytest.raises(ValueError, match="N <="):
        flash_attention(wide, wide, wide, 0.125)
    with pytest.raises(TypeError):
        attention_bwd(q, k, v, q.bfloat16(), 0.125)


def _favor_operands(b, h, t, e, m, dtype, device, seed=0):
    """k, q, v as the Performer block passes them (strided [B,H,T,e]
    views of one [B,T,H,3e] kqv output, k and q at ViP's scale of about
    0.5) and w N(0,1) [m, e] float32."""
    g = np.random.RandomState(seed)
    kqv = g.randn(b, t, h, 3 * e).astype(np.float32)
    kqv[..., :2 * e] *= 0.5
    kqv = torch.from_numpy(kqv).to(device, dtype)
    k, q, v = kqv.permute(0, 2, 1, 3).split(e, dim=-1)
    w = torch.from_numpy(g.randn(m, e).astype(np.float32)).to(device)
    return q, k, v, w


# [B, H, T, e, m]: ViP's BH 4 (serving bucket 1), 28 (bucket 7), 256
# (bucket 64) and 384 (training, bs 96) at T = 3137, e = 128, m = 64; T at
# and around chunk and tile edges; one e = 64 / m = 32 shape
FAVOR_SHAPES = [(1, 4, 3137, 128, 64), (7, 4, 3137, 128, 64),
                (64, 4, 3137, 128, 64), (96, 4, 3137, 128, 64),
                (2, 2, 1, 128, 64), (1, 4, 33, 128, 64),
                (3, 1, 1048, 128, 64), (1, 3, 1049, 128, 64),
                (2, 3, 257, 64, 32)]
# the bf16 stats kernel's 64-row chunk (T = chunk - 1, chunk, chunk + 1),
# its tile edges at BH 4 (T = 1280: ten tiles of 128 rows; 1281: an
# eleventh tile of one row), and e = 36 (rows not 16-byte aligned: plain
# loads in place of cp.async)
FAVOR_SHAPES += [(1, 4, 63, 128, 64), (1, 4, 64, 128, 64),
                 (1, 4, 65, 128, 64), (1, 4, 1280, 128, 64),
                 (1, 4, 1281, 128, 64), (2, 2, 100, 36, 16)]
# float32 on both sides (TF32 off): rtol 1e-4; the stats' atol scales with
# their largest magnitude (sums over T of exp features), y's is 1e-5
FAVOR_RTOL, FAVOR_ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("shape", FAVOR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_kernels_match_plain(cuda, shape, dtype):
    b, h, t, e, m = shape
    q, k, v, w = _favor_operands(b, h, t, e, m, dtype, cuda)
    before = (favor.favor_stats.launches, favor.favor_apply.launches)
    ksum, kptv = favor.favor_stats(k, v, w)
    y = favor.favor_apply(q, ksum, kptv, w)
    torch.cuda.synchronize()
    assert (favor.favor_stats.launches, favor.favor_apply.launches) == (
        before[0] + 1, before[1] + 1)
    # the stats against the plain version on the float32 values of the
    # same operands
    wks, wkv = favor.favor_stats_reference(k.float(), v.float(), w)
    for got, want in ((ksum, wks), (kptv, wkv)):
        torch.testing.assert_close(
            got, want, rtol=FAVOR_RTOL,
            atol=FAVOR_ATOL * want.abs().max().item())
    # the apply on the kernel's stats, and the chain (plain stats, then
    # plain apply), against the plain versions at the precision the
    # kernels are held to: float32 for float32 operands (the same float32
    # arithmetic), float64 for the bf16 tensor-core kernels (their bf16x3
    # split products are closer to float64 than float32 is)
    wide = torch.float32 if dtype == torch.float32 else torch.float64
    qw, ww = q.to(wide), w.to(wide)
    assert y.shape == (b, h, t, e) and y.dtype == torch.float32
    want = favor.favor_apply_reference(qw, ksum.to(wide), kptv.to(wide), ww)
    torch.testing.assert_close(y, want.float(), rtol=FAVOR_RTOL,
                               atol=FAVOR_ATOL)
    chain = favor.favor_apply_reference(
        qw, *favor.favor_stats_reference(k.to(wide), v.to(wide), ww), ww)
    torch.testing.assert_close(y, chain.float(), rtol=FAVOR_RTOL,
                               atol=FAVOR_ATOL)
    # no float atomics: a second run agrees bit for bit
    again = favor.favor_stats(k, v, w)
    assert torch.equal(again[1], kptv) and torch.equal(again[0], ksum)
    assert torch.equal(favor.favor_apply(q, ksum, kptv, w), y)


@pytest.mark.parametrize("shape", [(1, 4, 300, 128, 64),
                                   (2, 2, 100, 36, 16)])
def test_favor_apply_unaligned_rows(cuda, shape):
    """bf16 q rows that do not start on 16 bytes (and, at e = 36, rows of
    e % 8 != 0) are staged by plain loads in place of cp.async: the same
    result, bit for bit, as the aligned rows'."""
    b, h, t, e, m = shape
    q, k, v, w = _favor_operands(b, h, t, e, m, torch.bfloat16, cuda,
                                 seed=4)
    ksum, kptv = favor.favor_stats(k, v, w)
    got = favor.favor_apply(_unaligned(q), ksum, kptv, w)
    want = favor.favor_apply(q.contiguous(), ksum, kptv, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["stats", "apply"])
@pytest.mark.parametrize("shape", [(96, 4, 3137, 128, 64),
                                   (1, 4, 1281, 128, 64)])
def test_favor_kernels_bit_deterministic(cuda, kernel, shape):
    """No float atomics and a fixed order of every sum: three runs of a
    bf16 kernel, at the training shape and at a T split into tiles,
    agree bit for bit."""
    b, h, t, e, m = shape
    q, k, v, w = _favor_operands(b, h, t, e, m, torch.bfloat16, cuda,
                                 seed=8)
    stats = favor.favor_stats(k, v, w)
    if kernel == "stats":
        run = lambda: favor.favor_stats(k, v, w)  # noqa: E731
    else:
        run = lambda: (favor.favor_apply(q, *stats, w),)  # noqa: E731
    first = run()
    for _ in range(2):
        assert all(torch.equal(a, f) for a, f in zip(run(), first))


@pytest.mark.parametrize("t", [1, 63, 64, 65, 1100, 3137])
@pytest.mark.parametrize("e", [64, 96, 128])
@pytest.mark.parametrize("m", [32, 64])
def test_favor_stats_shapes(cuda, t, e, m):
    """The bf16 stats kernel across T (slab and round edges, T-tiles),
    e and m, on the Performer block's strided views: against the plain
    version on the float32 values at the smoke's tolerance, and bit for
    bit the same on a second run."""
    q, k, v, w = _favor_operands(1, 4, t, e, m, torch.bfloat16, cuda,
                                 seed=t + e + m)
    ksum, kptv = favor.favor_stats(k, v, w)
    torch.cuda.synchronize()
    wks, wkv = favor.favor_stats_reference(k.float(), v.float(), w)
    for got, want in ((ksum, wks), (kptv, wkv)):
        torch.testing.assert_close(
            got, want, rtol=FAVOR_RTOL,
            atol=FAVOR_ATOL * want.abs().max().item())
    again = favor.favor_stats(k, v, w)
    assert torch.equal(again[0], ksum) and torch.equal(again[1], kptv)


def test_graph_replay_equals_eager_kernels(cuda):
    """The persistent attention forward (N = 128, bf16) and the bf16 stats
    kernel captured in a CUDA graph (their TMA maps baked into the
    launches) and replayed on new inputs copied into the captured ones:
    bit for bit the eager launches' results."""
    q, k, v = (t.contiguous() for t in _qkv((6, 8, 128, 64),
                                            torch.bfloat16, cuda, seed=9))
    fq, fk, fv, w = (t.contiguous() if t.dim() == 4 else t
                     for t in _favor_operands(2, 4, 1100, 128, 64,
                                              torch.bfloat16, cuda, seed=9))
    with torch.no_grad():
        flash_attention(q, k, v, 0.125)  # built and warmed up
        favor.favor_stats(fk, fv, w)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            o = flash_attention(q, k, v, 0.125)
            ksum, kptv = favor.favor_stats(fk, fv, w)
        for seed in (10, 11):
            for dst, src in zip((q, k, v), _qkv((6, 8, 128, 64),
                                                torch.bfloat16, cuda,
                                                seed=seed)):
                dst.copy_(src)
            new = _favor_operands(2, 4, 1100, 128, 64, torch.bfloat16,
                                  cuda, seed=seed)
            fk.copy_(new[1])
            fv.copy_(new[2])
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(o, flash_attention(q, k, v, 0.125))
            eager = favor.favor_stats(fk, fv, w)
            assert torch.equal(ksum, eager[0]) and torch.equal(kptv, eager[1])


def test_graph_replay_equals_eager_backward(cuda):
    """The persistent attention backward (N = 128, bf16) captured in a CUDA
    graph (its seven TMA maps baked into the launch) and replayed on new
    inputs copied into the captured ones: bit for bit the eager
    launch's result."""
    q, k, v = (t.contiguous() for t in _qkv((6, 8, 128, 64),
                                            torch.bfloat16, cuda, seed=12))
    do = _grad_out(6, 8, 128, torch.bfloat16, cuda, seed=13)
    attention_bwd(q, k, v, do, 0.125)  # built and warmed up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        grads = attention_bwd(q, k, v, do, 0.125)
    for seed in (14, 15):
        for dst, src in zip((q, k, v), _qkv((6, 8, 128, 64),
                                            torch.bfloat16, cuda, seed=seed)):
            dst.copy_(src)
        do.copy_(_grad_out(6, 8, 128, torch.bfloat16, cuda, seed=seed + 10))
        graph.replay()
        torch.cuda.synchronize()
        eager = attention_bwd(q, k, v, do, 0.125)
        assert all(torch.equal(a, e) for a, e in zip(grads, eager))


def _bwd_excess(got, want):
    """How far ``got`` lies from the float64 ``want`` past FAVOR_RTOL of
    each element and past half an ulp of ``got``'s dtype (a bf16 output's
    rounding), in units of ``want``'s largest magnitude: the forward
    kernels' tolerance, FAVOR_ATOL, holds a float32-accurate result; a
    bf16-level one lies 1e-3 and more past it."""
    slack = FAVOR_RTOL * want.abs()
    if got.dtype == torch.bfloat16:
        _, ex = torch.frexp(want)
        slack = slack + torch.ldexp(torch.ones_like(want), ex - 9)
    return (((got.double() - want).abs() - slack).clamp_min(0).max()
            / want.abs().max()).item()


def test_favor_autograd_and_no_plain_on_cuda(cuda, monkeypatch):
    """favor_attention_fused on CUDA tensors launches the forward and
    backward kernels (the plain versions, patched to raise, are never
    reached); its output equals favor_attention's (float32) and its
    gradients (float32) lie within the kernels' tolerance of autograd's
    through favor_attention in float64."""
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")

    q, k, v, w = _favor_operands(2, 4, 300, 128, 64, torch.float32, cuda)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    for name in ("favor_stats_reference", "favor_apply_reference",
                 "favor_bwd_q_reference", "favor_bwd_kv_reference"):
        monkeypatch.setattr(favor, name, refuse)
    before = (favor.favor_stats.launches, favor.favor_bwd_q.launches,
              favor.favor_bwd_kv.launches)
    out = favor.favor_attention_fused(*leaves, w)
    g = torch.randn_like(out)
    grads = torch.autograd.grad((out * g).sum(), leaves)
    assert (favor.favor_stats.launches, favor.favor_bwd_q.launches,
            favor.favor_bwd_kv.launches) == tuple(n + 1 for n in before)
    monkeypatch.undo()
    with torch.no_grad():
        want_out = favor.favor_attention(q, k, v, w)
    torch.testing.assert_close(out, want_out, rtol=FAVOR_RTOL,
                               atol=FAVOR_ATOL)
    ref = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        (favor.favor_attention(*ref, w.double()) * g.double()).sum(), ref)
    for a, b in zip(grads, want):
        assert a.dtype == torch.float32
        assert _bwd_excess(a, b) <= FAVOR_ATOL


# [B, H, T, e, m]: ViP's training shape; T off the bf16 kernels' 64-row
# slabs and 128-row rounds with e 72, m 16; e 36 (rows that the slabs'
# 16-byte copies cannot take: plain loads)
FAVOR_BWD_SHAPES = [(96, 4, 3137, 128, 64), (1, 3, 1049, 72, 16),
                    (2, 2, 65, 128, 64), (2, 2, 100, 36, 16)]


@pytest.mark.parametrize("shape", FAVOR_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_backward_kernels_match_float64(cuda, shape, dtype):
    """favor_bwd_q and favor_bwd_kv on the Performer block's strided views
    and a dy in the apply kernel's layout, against the closed form in
    float64: dq, dk and dv within the forward kernels' tolerance past
    their dtype's rounding, the moments' gradients at rtol / atol times
    their largest magnitude; one launch each, counted; bit for bit alike
    on a second run."""
    b, h, t, e, m = shape
    q, k, v, w = _favor_operands(b, h, t, e, m, dtype, cuda, seed=21)
    dy = torch.from_numpy(np.random.RandomState(22).randn(
        b, t, h, e).astype(np.float32)).to(cuda).permute(0, 2, 1, 3)
    ksum, kptv = favor.favor_stats(k, v, w)
    before = (favor.favor_bwd_q.launches, favor.favor_bwd_kv.launches)
    dq, dkptv, dksum = favor.favor_bwd_q(q, dy, ksum, kptv, w)
    dk, dv = favor.favor_bwd_kv(k, v, dkptv, dksum, w)
    torch.cuda.synchronize()
    assert (favor.favor_bwd_q.launches, favor.favor_bwd_kv.launches) == (
        before[0] + 1, before[1] + 1)
    wq, wk, wv, wdy, ww = (x.double() for x in (q, k, v, dy, w))
    ks64, kv64 = favor.favor_stats_reference(wk, wv, ww)
    want = favor.favor_backward_reference(wq, wk, wv, wdy, ks64, kv64, ww)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == (b, h, t, e)
        assert _bwd_excess(got, ref) <= FAVOR_ATOL
    del want
    moments = favor.favor_bwd_q_reference(wq, wdy, ks64, kv64, ww)[1:]
    for got, ref in zip((dkptv, dksum), moments):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), ref, rtol=FAVOR_RTOL,
                                   atol=FAVOR_ATOL * ref.abs().max().item())
    again = favor.favor_bwd_q(q, dy, ksum, kptv, w)
    assert torch.equal(again[0], dq) and torch.equal(again[1], dkptv)
    again = favor.favor_bwd_kv(k, v, dkptv, dksum, w)
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_favor_backward_in_a_vip_block(cuda, dtype, monkeypatch):
    """One ViP block (3137 tokens x 512, 4 heads, m 64) at bs 2, float32
    or under bf16 autocast as ViP trains: the parameters' gradients on the
    kernel path against the plain path's, whose FAVOR+ is favor_attention
    on the operands' float32 values (the kernels' formula) under autograd,
    float32 at HIGHEST."""
    import copy

    from scat_tpu_torch.models import performer
    torch.manual_seed(0)
    block = performer.PerformerBlock(128, 4, use_kernel=True).to(cuda)
    plain = copy.deepcopy(block)
    plain.use_kernel = False
    x = torch.randn(2, 3137, 512, device=cuda)
    g = torch.randn(2, 3137, 512, device=cuda)
    upcast = performer.favor_attention
    monkeypatch.setattr(performer, "favor_attention",
                        lambda q, k, v, w, p: upcast(q.float(), k.float(),
                                                     v.float(), w, p))
    grads = []
    for blk in (block, plain):
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            out = blk(x)
        (out.float() * g).sum().backward()
        grads.append({n: p.grad for n, p in blk.named_parameters()})
    bound = FAVOR_BWD_BLOCK_REL[dtype]
    for name, want in grads[1].items():
        gap = ((grads[0][name] - want).abs().max()
               / want.abs().max()).item()
        assert gap <= bound, (name, gap)


# the block's parameter gradients, kernel against plain path, as a share of
# each one's largest magnitude: float32 arithmetic on both sides; under bf16
# autocast both round dq, dk and dv to bf16 and differ where a float32-level
# gap flips a rounding (about 1% of dq's elements)
FAVOR_BWD_BLOCK_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def test_favor_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, w = _favor_operands(1, 2, 40, 128, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        favor.favor_stats(k.half(), v.half(), w)
    with pytest.raises(TypeError):
        favor.favor_stats(k, v, w.bfloat16())
    wide = torch.zeros(1, 2, 40, 129, device=cuda)
    with pytest.raises(ValueError, match="e <= 128"):
        favor.favor_stats(wide, wide, torch.zeros(64, 129, device=cuda))
    with pytest.raises(ValueError, match="m <= 64"):
        favor.favor_stats(k, v, torch.zeros(65, 128, device=cuda))
    with pytest.raises(ValueError, match="cuda or cpu"):
        favor.favor_stats(k, v, w.cpu())
    ksum, kptv = favor.favor_stats(k, v, w)
    with pytest.raises(ValueError, match="favor_stats' contiguous"):
        favor.favor_apply(q, ksum, kptv.transpose(-1, -2), w)


def _link_operands(m, k, n, device, seed=0):
    """x [M, K] (about 0.5) and w [K, N] (fan-in scaled) bf16, a folded
    BatchNorm's scale (about 1) and shift (about 0) [K] float32."""
    g = np.random.RandomState(seed)
    x = torch.from_numpy((g.randn(m, k) * 0.5).astype(np.float32))
    w = torch.from_numpy((g.randn(k, n) / np.sqrt(k)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.2 * g.randn(k)).astype(np.float32))
    shift = torch.from_numpy((0.1 * g.randn(k)).astype(np.float32))
    return (x.to(device, torch.bfloat16), w.to(device, torch.bfloat16),
            scale.to(device), shift.to(device))


# (M, K, N): the probe's five shapes (ResNet-50's bottleneck links at bs
# 96), M not whole 128-row tiles (1, 129, bs 1's 3136, layer4's 4704),
# N = 1024 and N not whole 128-column tiles
LINK_SHAPES = [(301056, 256, 64), (301056, 64, 256), (75264, 512, 128),
               (75264, 128, 512), (18816, 1024, 256), (1, 256, 64),
               (129, 64, 256), (3136, 64, 256), (4704, 2048, 512),
               (4704, 512, 2048), (18816, 256, 1024), (200, 72, 200)]


@pytest.mark.parametrize("shape", LINK_SHAPES)
def test_fused_link_matches_plain(cuda, shape):
    """The kernel against its plain version run in float32 on the same
    bf16 inputs, at fused_link's bounds (link_gaps: y within 1 bf16 ulp at
    max|y|, s and ss within 1e-5 and 2e-5 plus one row's rounding)."""
    args = _link_operands(*shape, cuda, seed=sum(shape))
    before = fl.fused_link.launches
    got = fl.fused_link(*args)
    torch.cuda.synchronize()
    assert fl.fused_link.launches == before + 1
    m, _, n = shape
    y, s, ss = got
    assert y.shape == (m, n) and y.dtype == torch.bfloat16 and y.is_cuda
    assert s.shape == ss.shape == (n,) and s.dtype == torch.float32
    gaps = fl.link_gaps(got, fl.fused_link_reference(*args), *args)
    assert max(gaps.values()) <= 1, gaps


@pytest.mark.parametrize("shape", [(301056, 64, 256), (4704, 512, 2048)])
def test_fused_link_bit_deterministic(cuda, shape):
    """No float atomics and a fixed order of every sum: three launches
    agree bit for bit."""
    args = _link_operands(*shape, cuda, seed=5)
    first = fl.fused_link(*args)
    for _ in range(2):
        assert all(torch.equal(a, f) for a, f in zip(fl.fused_link(*args),
                                                      first))


def test_fused_link_refuses_unaligned_rows(cuda):
    """Rows that are not 16-byte aligned (a row stride not a multiple of 8
    elements, or a start off 16 bytes) and operands on two devices raise,
    with no launch."""
    x, w, scale, shift = _link_operands(256, 64, 128, cuda)
    before = fl.fused_link.launches
    wide = torch.zeros(256, 68, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.fused_link(wide[:, :64], w, scale, shift)
    with pytest.raises(ValueError, match="start on 16 bytes"):
        fl.fused_link(wide.view(-1)[4:4 + 256 * 64].view(256, 64), w, scale,
                      shift)
    with pytest.raises(ValueError, match="one device"):
        fl.fused_link(x, w, scale.cpu(), shift)
    with pytest.raises(TypeError, match="bf16 x"):
        fl.fused_link(x.float(), w, scale, shift)
    assert fl.fused_link.launches == before


def test_fused_link_graph_replay_equals_eager(cuda):
    """The link's two launches captured in a CUDA graph and replayed on
    new inputs copied into the captured ones: bit for bit the eager
    launch's result."""
    args = _link_operands(4704, 512, 2048, cuda, seed=20)
    fl.fused_link(*args)  # built and warmed up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fl.fused_link(*args)
    for seed in (21, 22):
        for dst, src in zip(args, _link_operands(4704, 512, 2048, cuda,
                                                 seed=seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(out,
                                                     fl.fused_link(*args)))


def test_fused_link_graph_replays_and_two_streams(cuda):
    """Two graph replays in a row, then two graphs replayed at once on two
    streams with inputs and outputs of their own, and two eager launches
    at once on two streams: each bit for bit the eager launch on its own
    (the partials' sum is a dependent launch; no state lives between
    calls)."""
    shape = (18816, 1024, 256)
    args = [_link_operands(*shape, cuda, seed=30 + i) for i in range(2)]
    want = [fl.fused_link(*a) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    outs = []
    for a, g, st in zip(args, graphs, streams):
        with torch.cuda.graph(g, stream=st):
            outs.append(fl.fused_link(*a))

    def same(got, exp):
        return all(torch.equal(x, y) for x, y in zip(got, exp))
    for _ in range(2):
        graphs[0].replay()
        torch.cuda.synchronize()
        assert same(outs[0], want[0])
    for g, st in zip(graphs, streams):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            g.replay()
    torch.cuda.synchronize()
    assert same(outs[0], want[0]) and same(outs[1], want[1])
    eager = []
    for a, st in zip(args, streams):
        with torch.cuda.stream(st):
            eager.append(fl.fused_link(*a))
    torch.cuda.synchronize()
    assert same(eager[0], want[0]) and same(eager[1], want[1])


@pytest.mark.parametrize("shape", LINK_SHAPES)
def test_fused_link_reads_strided_x(cuda, shape):
    """x as a view of wider rows (row stride K + 8, read in place by the
    tensor map): within fused_link's bounds of the plain version, and bit
    for bit the contiguous x's result."""
    m, k, n = shape
    x, w, scale, shift = _link_operands(m, k, n, cuda, seed=sum(shape) + 1)
    wide = torch.zeros(m, k + 8, dtype=torch.bfloat16, device=cuda)
    wide[:, :k] = x
    view = wide[:, :k]
    assert view.stride(0) == k + 8
    got = fl.fused_link(view, w, scale, shift)
    gaps = fl.link_gaps(got, fl.fused_link_reference(x, w, scale, shift), x,
                        w, scale, shift)
    assert max(gaps.values()) <= 1, gaps
    assert all(torch.equal(a, b)
               for a, b in zip(got, fl.fused_link(x, w, scale, shift)))


def test_fused_link_plan_matches_the_kernel(cuda):
    """link_plan's shared memory is the kernel's own count for the plans
    of every link shape."""
    lib = fl._library()
    for m, k, n in LINK_SHAPES:
        plan = fl.link_plan(m, k, n)
        assert lib.scat_fused_link_smem(k, plan.bn, plan.groups,
                                        int(plan.resident),
                                        plan.stages) == plan.smem


@pytest.mark.parametrize("augment", [False, True])
def test_stb_batch_on_card_equals_cpu(cuda, tmp_path, augment):
    """The PIL path's batch made on the card (upload, blur, warp, labels)
    equals the CPU's from the same tree and seed, within 1e-4."""
    data_dir = write_stb_tree(tmp_path, TRAIN_SEQS, n=2)
    kw = dict(rotation=augment, motion_blur=augment, shuffle=True, seed=4,
              use_native=False)
    got = next(iter(stb.STBDataset("STB_train", data_dir, 4, device=cuda,
                                   **kw)))
    want = next(iter(stb.STBDataset("STB_train", data_dir, 4, device="cpu",
                                    **kw)))
    for key in ("image", "label", "valid"):
        assert got[key].is_cuda
        torch.testing.assert_close(got[key].cpu(), want[key], atol=1e-4,
                                   rtol=1e-5, msg=key)


def test_evaluator_on_card_matches_cpu(cuda, tmp_path):
    """The Evaluator in float32 on the card against the CPU, same weights
    (seed 0) and synthetic batches: MPJPE within 1e-3 relative, AUC and
    the PCK within one joint of a batch."""
    opt = Options(net="reg_transformer", vit_heads=2, iteration=3,
                  batch_size=4, compute_dtype="float32",
                  checkpoint_path_eval="", result_dir=str(tmp_path / "gpu"))
    data = list(SyntheticDataset(4, num_batches=2, image_size=64))
    got = Evaluator(opt, image_size=64, dataset=data, device=cuda).eval()
    cpu = dataclasses.replace(opt, result_dir=str(tmp_path / "cpu"))
    want = Evaluator(cpu, image_size=64, dataset=data, device="cpu").eval()
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-3)
    np.testing.assert_allclose(got["pck"], want["pck"],
                               atol=100 / (4 * 21) + 1e-6)
    np.testing.assert_allclose(got["auc"], want["auc"],
                               atol=100 / (4 * 21) + 1e-6)


def _stage2_trees(root):
    write_stb_tree(root / "STB", TRAIN_SEQS, n=4)
    write_frei_tree(root, n=8)
    write_ho3d_tree(root, frames=4)
    write_mhp_tree(root, frames=4)
    write_rhd_tree(root, n=4)
    return Options(stage=2, data_dir=str(root / "STB"), seed=3)


def test_stage2_batches_on_card_equal_cpu(cuda, tmp_path):
    """The first tuple of the stage-2 mix (FreiHAND with its jitter,
    HO-3D, STB, MHP, RHD) made on the card equals the CPU's from the same
    trees and seed, within 1e-4."""
    opt = _stage2_trees(tmp_path)
    got = next(iter(concat_dataset(2, opt, device=cuda)))
    want = next(iter(concat_dataset(2, opt, device="cpu")))
    assert [b["label"].shape[1] for b in got] == [166, 166, 105, 105, 105]
    for g, w in zip(got, want):
        for key in ("image", "label", "valid"):
            assert g[key].is_cuda
            torch.testing.assert_close(g[key].cpu(), w[key], atol=1e-4,
                                       rtol=1e-5, msg=key)


def test_stage2_train_steps_on_card(cuda, tmp_path):
    """One bf16 train step per member of a stage-2 tuple on the card
    (a resnet18 flagship at 224): 3 + 3 attention launches a step, finite
    losses, both label widths through the same step."""
    opt = _stage2_trees(tmp_path)
    model = EncoderTransformer(
        mean_params=torch.from_numpy(assets.load_mean_params()),
        iteration=3, heads=8, backbone="resnet18", mask_rate=0.2,
        use_kernel=True)
    checkpoint.init_weights(model, seed=0)
    model = model.to(cuda, memory_format=torch.channels_last)
    model.set_compute_dtype(torch.bfloat16)
    optimizer, scheduler = schedule.make_optimizer(model, 5e-4, 2)
    state = TrainState.create(model, optimizer, scheduler, seed=0)
    step = steps.make_train_step(1e5, 10.0)
    batches = next(iter(concat_dataset(2, opt, device=cuda)))
    for batch in batches:
        fwd, bwd = flash_attention.launches, attention_bwd.launches
        loss = float(step(state, batch)["loss"])
        assert np.isfinite(loss), batch["label"].shape
        assert flash_attention.launches - fwd == 3
        assert attention_bwd.launches - bwd == 3
    assert state.step == 5


def _group_model(device, dtype=torch.float32):
    model = EncoderTransformer(
        mean_params=torch.from_numpy(assets.load_mean_params()),
        iteration=3, heads=2, token_dim=64, backbone="resnet18",
        norm_layer="group", use_kernel=True)
    checkpoint.init_weights(model, seed=0)
    model = model.to(device, memory_format=torch.channels_last)
    return model.cast_compute(dtype).eval()


def test_group_norm_forward_on_card(cuda):
    """The GroupNorm flagship's eval forward on the card: float32 against
    the CPU within 1e-3, bf16 (GroupNorm statistics in float32, bf16 out)
    against float32 within 2% of the largest magnitude, 3 attention
    launches a forward."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 64, 64)
                         .astype(np.float32) * 0.5)
    with torch.no_grad():
        want = _group_model("cpu")(x)[0]
        got = _group_model(cuda)(x.to(cuda))[0].cpu()
        before = flash_attention.launches
        bf16 = _group_model(cuda, torch.bfloat16)(x.to(cuda))[0].cpu()
    assert flash_attention.launches - before == 3
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    assert bf16.dtype == torch.float32
    torch.testing.assert_close(bf16, want, rtol=0,
                               atol=2e-2 * want.abs().max().item())


def test_demo_on_card_matches_cpu(cuda, tmp_path):
    """The demo in float32 on the card against the CPU, the same weights
    (seed 0) and 18 frames: MPJPE, ACC and AUC within 1e-3 relative, 3
    attention launches a frame."""
    rng = np.random.RandomState(0)
    j2d = np.stack([rng.uniform(40, 90, (18, 21)),
                    rng.uniform(30, 66, (18, 21))], -1).astype(np.float32)
    j3d = (rng.randn(18, 21, 3) * 0.03).astype(np.float32)
    loader = demo.SequenceLoader(
        np.stack([_smooth(96, 128, t) for t in range(18)]), j2d, j3d)
    opt = Options(net="reg_transformer", vit_heads=2, iteration=3,
                  compute_dtype="float32", checkpoint_path_eval="",
                  result_dir=str(tmp_path / "gpu"))
    before = flash_attention.launches
    got = demo.DemoRunner(opt, loader=loader, image_size=64,
                          device=cuda).demo()
    assert flash_attention.launches - before == 3 * 18
    cpu = dataclasses.replace(opt, result_dir=str(tmp_path / "cpu"))
    want = demo.DemoRunner(cpu, loader=loader, image_size=64,
                           device="cpu").demo()
    for k in ("mpjpe_mm", "acc", "auc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-9,
                                   err_msg=k)


def test_coarse_head_on_card_matches_cpu(cuda):
    """The coarse head's eval forward in float32 on the card against the
    CPU, the same weights (seed 0): pred and attention within 1e-3, and no
    attention kernel launch (its attention is the plain version)."""
    def model(device):
        m = EncoderTransformerCoarse(
            torch.from_numpy(assets.load_mean_params()), heads=2,
            token_dim=64, backbone="resnet18")
        checkpoint.init_weights(m, seed=0)
        return m.to(device).eval()

    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 64, 64)
                         .astype(np.float32) * 0.5)
    with torch.no_grad():
        want = model("cpu")(x)
        before = flash_attention.launches
        got = model(cuda)(x.to(cuda))
    assert flash_attention.launches == before
    for name, a, b in zip(("pred", "feat_visual", "attn"), got, want):
        torch.testing.assert_close(a.cpu(), b, atol=1e-3, rtol=0, msg=name)


@pytest.mark.parametrize("cls", [EncoderTransformerHRNet,
                                 EncoderTransformerInception])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_head_kernel_path_matches_plain(cuda, cls, dtype):
    """A 128-token head at 224 px on the card, the kernel path
    (use_kernel=True: 3 attention_fwd launches at N = 128 a forward)
    against the plain path on the same weights: the regressed part (the
    prediction less the mean it starts from) within 1e-3 in float32, 2%
    of its largest magnitude in bf16."""
    mean = torch.from_numpy(assets.load_mean_mano_pose())
    outs = []
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 3, 224, 224)
                         .astype(np.float32) * 0.5).to(cuda)
    for use_kernel in (True, False):
        m = cls(mean, heads=8, use_kernel=use_kernel)
        checkpoint.init_weights(m, seed=0)
        m = m.to(cuda, memory_format=torch.channels_last).eval()
        m.cast_compute(dtype)
        before = flash_attention.launches
        with torch.no_grad():
            outs.append(m(x).cpu())
        assert flash_attention.launches - before == (3 if use_kernel else 0)
    got, want = (o - mean for o in outs)
    assert got.shape == (4, 61) and torch.isfinite(got).all()
    atol = 1e-3 if dtype == torch.float32 else \
        2e-2 * want.abs().max().item()
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


def test_mano_decode_on_card_matches_cpu(cuda):
    """``rot_pose_beta_to_mesh`` on the card in float32 (TF32 off, bf16
    inputs decoded in float32) against the CPU: joints and vertices
    within 1e-5."""
    rng = np.random.RandomState(2)
    args = [rng.randn(96, n).astype(np.float32) * s
            for n, s in ((3, 0.5), (45, 0.3), (10, 1.0))]
    args[0][0] = 0.0
    cpu = mano.ManoModel.from_data()
    want = mano.rot_pose_beta_to_mesh(cpu, *map(torch.from_numpy, args))
    got = mano.rot_pose_beta_to_mesh(
        cpu.to(cuda), *(torch.from_numpy(a).to(cuda) for a in args))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("net", ["ViT", "frankmocap"])
def test_vit_and_h3dw_on_card_match_cpu(cuda, net):
    """``--net ViT`` (224 px, 197 tokens x 256) and the frankmocap keypoint
    head (H3DWJointsEncoder, resnet18 at 64 px) in float32 on the card
    against the CPU on the same weights: the 66-dim prediction within
    1e-4; ViT launches no attention kernel."""
    size = 224 if net == "ViT" else 64

    def model(device):
        if net == "ViT":
            m, _ = build_model(Options(net=net), size)
        else:
            m = H3DWJointsEncoder(
                torch.from_numpy(assets.load_mean_mano_pose()),
                backbone="resnet18")
        checkpoint.init_weights(m, seed=0)
        return m.to(device).eval()

    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (4, 3, size, size)).astype(np.float32))
    with torch.no_grad():
        want = model("cpu")(x)[0]
        before = flash_attention.launches
        got = model(cuda)(x.to(cuda))[0]
    assert flash_attention.launches == before
    assert got.shape == (4, 66)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_adversarial_step_on_card(cuda):
    """One adversarial step on the card (resnet18 H3DW, GRU 64 x 2 through
    cuDNN, its backward in training mode): finite losses, both sides
    updated, the discriminator untouched by the generator's update."""
    enc = H3DWEncoder(torch.from_numpy(assets.load_mean_mano_pose()),
                      backbone="resnet18")
    checkpoint.init_weights(enc, seed=0)
    disc = MotionDiscriminator(64, 48, 2, feature_pool="attention",
                               attention_size=64)
    disc.init_weights(torch.Generator().manual_seed(1))
    state = adversarial.AdversarialTrainState.create(
        enc.to(cuda), disc.to(cuda), 1e-4, 1e-5)
    rng = np.random.RandomState(4)
    batch = {"image": rng.uniform(-1, 1, (2, 8, 64, 64, 3)),
             "label": rng.randn(2, 8, 166) * 0.05,
             "real_theta": rng.randn(2, 8, 61) * 0.05}
    batch = {k: torch.from_numpy(v.astype(np.float32)).to(cuda)
             for k, v in batch.items()}
    mano_model = mano.ManoModel.from_data(device=cuda)
    before = [p.detach().clone() for p in disc.parameters()]
    fake, stats = adversarial.generator_step(state, batch, mano_model)
    for p, b in zip(disc.parameters(), before):
        assert torch.equal(p, b) and p.grad is None
    stats.update(adversarial.discriminator_step(state, fake,
                                                batch["real_theta"]))
    for k, v in stats.items():
        assert torch.isfinite(v).all(), k
    assert any(not torch.equal(p, b)
               for p, b in zip(disc.parameters(), before))


def _op_operands(name, device):
    """Operands of one custom op at the serving paths' widths (float32):
    attention [4, 8, 21, 64] as strided views, FAVOR+ [2, 4, 300, 128],
    m 64, as the Performer block passes them."""
    if name.startswith("attention"):
        q, k, v = _qkv((4, 8, 21, 64), torch.float32, device)
        do = torch.from_numpy(np.random.RandomState(5).randn(
            4, 21, 8, 64).astype(np.float32)).to(device).permute(0, 2, 1, 3)
        return (q, k, v, 0.125) if name == "attention_fwd" else \
            (q, k, v, do, 0.125)
    q, k, v, w = _favor_operands(2, 4, 300, 128, 64, torch.float32, device)
    if name == "favor_stats":
        return k, v, w
    ksum, kptv = favor.favor_stats(k, v, w)
    if name == "favor_apply":
        return q, ksum, kptv, w
    dy = torch.from_numpy(np.random.RandomState(6).randn(
        2, 300, 4, 128).astype(np.float32)).to(device).permute(0, 2, 1, 3)
    if name == "favor_bwd_q":
        return q, dy, ksum, kptv, w
    return (k, v, *favor.favor_bwd_q(q, dy, ksum, kptv, w)[1:], w)


@pytest.mark.parametrize("name", ["attention_fwd", "attention_bwd",
                                  "favor_stats", "favor_apply",
                                  "favor_bwd_q", "favor_bwd_kv"])
def test_custom_op_cuda_matches_its_cpu_implementation(cuda, name):
    """torch.ops.scat_tpu_torch.<name> on CUDA tensors (the kernel)
    against the same op on the tensors' CPU copies (the plain version),
    in the same output layout, float32, TF32 off."""
    op = getattr(torch.ops.scat_tpu_torch, name)
    args = _op_operands(name, cuda)
    got = op(*args)
    want = op(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    got, want = (tuple(x) if isinstance(x, (tuple, list)) else (x,)
                 for x in (got, want))
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape and g.stride() == w.stride()
        if name.startswith("attention"):
            torch.testing.assert_close(g.cpu(), w, atol=2e-5, rtol=0)
        else:
            torch.testing.assert_close(
                g.cpu(), w, rtol=FAVOR_RTOL,
                atol=FAVOR_ATOL * max(1.0, float(w.abs().max())))


def test_graph_replay_matches_eager(cuda):
    """A small flagship (resnet18, 64 px, float32) served from its
    artifact through one CUDA graph per bucket equals the live predictor;
    the attention op is captured (3 launches counted a capture, none a
    replay) and the runner's tally counts 3 a replay, as many as the
    live predictor's eager forward; check_graph_consistency holds on the
    card."""
    import tempfile

    from scat_tpu_torch.export import ExportedPredictor, export_predictor
    from scat_tpu_torch.serving import HandPosePredictor, serving_forward
    from scat_tpu_torch.utils.debugging import check_graph_consistency

    model = EncoderTransformer(torch.from_numpy(assets.load_mean_params()),
                               iteration=1, heads=2, token_dim=64,
                               backbone="resnet18", use_kernel=True)
    checkpoint.init_weights(model, seed=0)
    live = HandPosePredictor(model=model, image_size=64, max_batch=8,
                             device=cuda)
    x = np.random.RandomState(6).randint(0, 256, (13, 64, 64, 3)).astype(
        np.uint8)
    with tempfile.TemporaryDirectory() as path:
        export_predictor(live, path)
        art = ExportedPredictor(path)
        runner = art._forwards["uint8"]
        before = flash_attention.launches
        got = art.predict(x)
        # 13 crops are two chunks of bucket 8: one graph (bucket 8,
        # uint8), its eager warm-up run and its capture counted
        assert flash_attention.launches == before + 6
        assert runner.replayed["flash_attention"] == 6
        again = art.predict(x)
        assert flash_attention.launches == before + 6
        assert runner.replayed["flash_attention"] == 12
    before = flash_attention.launches
    want = live.predict(x)
    assert flash_attention.launches - before == 6
    for k in want:
        np.testing.assert_array_equal(got[k], again[k])
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    images = torch.from_numpy(x[:8]).to(cuda)
    check_graph_consistency(lambda t: serving_forward(live.model, t), images)
