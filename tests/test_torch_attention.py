"""The port's attention (scat_tpu_torch.ops.attention) against the JAX
package's Pallas kernel in interpret mode, on the CPU.

On CPU tensors ``flash_attention`` takes its plain version, so these
tests hold the plain math and the wrapper's routing; the CUDA kernel
itself is held against the plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import numpy as np
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


def test_other_devices_raise():
    q = torch.empty(1, 8, 21, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ta.flash_attention(q, q, q, 0.125)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_library_path_keyed_by_source(monkeypatch, tmp_path):
    """An edited source gets a new library path (a rebuild), an
    unchanged one the same path."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    first = build.library_path("k")
    assert build.library_path("k") == first
    src.write_text("// two")
    assert build.library_path("k") != first
    assert first.startswith(build.BUILD_DIR) and first.endswith(".so")
