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
