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

from scat_tpu_torch.ops.attention import attention_reference, flash_attention

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


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 21, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), 0.125)
    wide = torch.zeros(1, 2, 129, 64, device=cuda)
    with pytest.raises(ValueError, match="N <="):
        flash_attention(wide, wide, wide, 0.125)
    leaf = q.detach().clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(leaf, k, v, 0.125)
