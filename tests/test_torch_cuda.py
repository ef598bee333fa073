"""The port's CUDA kernels on the card (marker ``cuda``; skipped without
a CUDA device).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's stack.  There the repository's
conftest (which sets JAX up) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from scat_tpu_torch.ops import favor
from scat_tpu_torch.ops.attention import (attention_bwd,
                                          attention_bwd_reference,
                                          attention_reference,
                                          flash_attention)

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
                                   (2, 4, 128, 64), (3, 2, 21, 64)])
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
                                   (2, 4, 128, 64), (3, 2, 21, 64)])
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
    # the plain versions on the float32 values of the same operands
    wks, wkv = favor.favor_stats_reference(k.float(), v.float(), w)
    for got, want in ((ksum, wks), (kptv, wkv)):
        torch.testing.assert_close(
            got, want, rtol=FAVOR_RTOL,
            atol=FAVOR_ATOL * want.abs().max().item())
    want = favor.favor_apply_reference(q.float(), wks, wkv, w)
    assert y.shape == (b, h, t, e) and y.dtype == torch.float32
    torch.testing.assert_close(y, want, rtol=FAVOR_RTOL, atol=FAVOR_ATOL)
    # no float atomics: a second run agrees bit for bit
    again = favor.favor_stats(k, v, w)
    assert torch.equal(again[1], kptv) and torch.equal(again[0], ksum)
    assert torch.equal(favor.favor_apply(q, ksum, kptv, w), y)


def test_favor_autograd_and_no_plain_on_cuda(cuda, monkeypatch):
    """favor_attention_fused on CUDA tensors launches the kernels (the
    plain versions, patched to raise, are never reached) and its
    gradients equal autograd's through favor_attention (float32)."""
    def refuse(*_):
        raise AssertionError("a CUDA tensor reached the plain version")

    q, k, v, w = _favor_operands(2, 4, 300, 128, 64, torch.float32, cuda)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    monkeypatch.setattr(favor, "favor_stats_reference", refuse)
    monkeypatch.setattr(favor, "favor_apply_reference", refuse)
    before = favor.favor_stats.launches
    out = favor.favor_attention_fused(*leaves, w)
    g = torch.randn_like(out)
    grads = torch.autograd.grad((out * g).sum(), leaves)
    assert favor.favor_stats.launches == before + 1
    monkeypatch.undo()
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want_out = favor.favor_attention(*ref, w)
    want = torch.autograd.grad((want_out * g).sum(), ref)
    torch.testing.assert_close(out, want_out, rtol=FAVOR_RTOL,
                               atol=FAVOR_ATOL)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


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
