"""The port's FAVOR+ (scat_tpu_torch.ops.favor) against the JAX package's
on the CPU: the plain math of scat_tpu/models/performer.py, and the
Pallas stats and apply kernels of scat_tpu/ops/pallas_favor.py in
interpret mode.

On CPU tensors ``favor_attention_fused`` and its two kernel wrappers take
the plain versions, so these tests hold the plain math, the wrappers'
routing, the autograd.Function's wiring and the host-side tiling; the
CUDA kernels themselves are held against the plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.ops.pallas_favor as pf
from scat_tpu.models import performer as jperf
from scat_tpu_torch.ops import favor as tf

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pf, "_INTERPRET", True)


def _qkvw(rng, shape, m, scale=0.3):
    """q, k at ``scale`` (ViP's kqv outputs are about 0.5), v, and w
    N(0,1), float32 numpy."""
    q = (rng.randn(*shape) * scale).astype(np.float32)
    k = (rng.randn(*shape) * scale).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    w = rng.randn(m, shape[-1]).astype(np.float32)
    return q, k, v, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape,m", [((2, 4, 33, 128), 64),
                                     ((3, 10, 64), 32)])
def test_features_and_attention_match_jax(rng, shape, m):
    q, k, v, w = _qkvw(rng, shape, m)
    np.testing.assert_allclose(
        tf.favor_features(*_t(q, w)).numpy(),
        np.asarray(jperf.favor_features(jnp.asarray(q), jnp.asarray(w))),
        rtol=1e-5, atol=1e-7)
    want = jperf.favor_attention(*map(jnp.asarray, (q, k, v, w)))
    got = tf.favor_attention(*_t(q, k, v, w))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_operands_promote_as_in_jax(rng):
    """bf16 q, k, v with float32 w: the squared norm in bf16, the rest
    promoted to float32, in both packages."""
    q, k, v, w = _qkvw(rng, (2, 2, 17, 32), 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jperf.favor_attention(jq, jk, jv, jnp.asarray(w))
    tq, tk, tv = (t.bfloat16() for t in _t(q, k, v))
    got = tf.favor_attention(tq, tk, tv, torch.from_numpy(w))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name", sorted(tf.PRECISIONS))
def test_precision_ladder(rng, name):
    """Every rung resolves to the JAX package's pair, and on the CPU
    every rung computes the same float32 result."""
    P = jax.lax.Precision
    names = {P.HIGHEST: "highest", P.HIGH: "high", P.DEFAULT: "default"}
    assert tf.favor_precisions(name) == tuple(
        names[p] for p in jperf.favor_precisions(name))
    q, k, v, w = _t(*_qkvw(rng, (1, 2, 9, 32), 16))
    torch.testing.assert_close(tf.favor_attention(q, k, v, w, name),
                               tf.favor_attention(q, k, v, w), rtol=0,
                               atol=0)
    with pytest.raises(KeyError):
        tf.favor_precisions("bogus")


def test_fused_matches_pallas(rng):
    """The port's favor_attention_fused on CPU tensors against the
    Pallas kernels in interpret mode at [2,4,33,128], m 64: within 1e-5
    (JAX holds its kernel to its own XLA path at 3e-4 / 1e-3)."""
    q, k, v, w = _qkvw(rng, (2, 4, 33, 128), 64)
    want = pf.favor_attention_fused(*map(jnp.asarray, (q, k, v, w)))
    before = (tf.favor_stats.launches, tf.favor_apply.launches)
    got = tf.favor_attention_fused(*_t(q, k, v, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5)
    # CPU tensors never launch the kernels
    assert (tf.favor_stats.launches, tf.favor_apply.launches) == before


def test_fused_3d_input(rng):
    q, k, v, w = _qkvw(rng, (3, 10, 64), 32)
    want = pf.favor_attention_fused(*map(jnp.asarray, (q, k, v, w)))
    got = tf.favor_attention_fused(*_t(q, k, v, w))
    assert got.shape == (3, 10, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kernel_references_match_pallas_kernels(rng, monkeypatch):
    """favor_stats_reference and favor_apply_reference against the
    outputs of the two pallas_calls of _favor_impl (captured as they
    return), at T = 1100: two T-tiles of 1048 and padded rows."""
    calls = []
    real = pf.pl.pallas_call

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run(*operands):
            calls.append(fn(*operands))
            return calls[-1]
        return run

    monkeypatch.setattr(pf.pl, "pallas_call", spy)
    bh, t, e, m = 3, 1100, 64, 32
    q, k, v, w = _qkvw(rng, (bh, t, e), m)
    pf._favor_impl(*map(jnp.asarray, (q, k, v, w)))
    (jksum, jkptv), jy = calls
    ksum, kptv = tf.favor_stats_reference(*_t(k, v, w))
    assert ksum.shape == (bh, m) and kptv.shape == (bh, m, e)
    np.testing.assert_allclose(ksum.numpy(), np.asarray(jksum)[:, 0],
                               rtol=1e-5)
    np.testing.assert_allclose(kptv.numpy(), np.asarray(jkptv), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jkptv).max()))
    y = tf.favor_apply_reference(*_t(q), ksum, kptv, *_t(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :t], atol=ATOL)
    # the wrappers on CPU tensors are the plain versions
    got = tf.favor_stats(*_t(k, v, w))
    torch.testing.assert_close(got[0], ksum, rtol=0, atol=0)
    torch.testing.assert_close(got[1], kptv, rtol=0, atol=0)
    torch.testing.assert_close(tf.favor_apply(*_t(q), *got, *_t(w)), y,
                               rtol=0, atol=0)


def test_gradients_match_jax_grad(rng):
    """favor_attention_fused's gradients (autograd through the
    recomputing backward) against jax.grad through favor_attention, and
    through the Pallas custom VJP; w gets none."""
    q, k, v, w = _qkvw(rng, (1, 2, 9, 32), 16, scale=0.2)
    g = rng.randn(1, 2, 9, 32).astype(np.float32)

    def jloss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v, jnp.asarray(w)) * g)

    args = tuple(map(jnp.asarray, (q, k, v)))
    want = jax.grad(jloss(jperf.favor_attention), argnums=(0, 1, 2))(*args)
    want_pf = jax.grad(jloss(pf.favor_attention_fused),
                       argnums=(0, 1, 2))(*args)
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tf.favor_attention_fused(*leaves, tw)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, a, b, c in zip("qkv", got, want, want_pf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name} (pallas)")
    assert tw.grad is None


def test_bf16_operands_take_float32_gradients_rounded(rng):
    """bf16 operands (the model's kqv views): the forward reads their
    float32 values, the gradients come back in bf16."""
    q, k, v, w = _qkvw(rng, (2, 2, 17, 32), 16)
    leaves = [t.bfloat16().requires_grad_(True) for t in _t(q, k, v)]
    out = tf.favor_attention_fused(*leaves, torch.from_numpy(w))
    assert out.dtype == torch.float32
    want = tf.favor_attention_fused(*(t.float() for t in leaves),
                                    torch.from_numpy(w))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    grads = torch.autograd.grad(out.sum(), leaves)
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_strided_views_match_contiguous(rng):
    """The block passes k, q, v as views of the [B,T,H,3e] kqv output."""
    b, t, h, e, m = 2, 21, 4, 32, 16
    kqv = torch.from_numpy(
        (rng.randn(b, t, h, 3 * e) * 0.3).astype(np.float32))
    w = torch.from_numpy(rng.randn(m, e).astype(np.float32))
    k, q, v = kqv.permute(0, 2, 1, 3).split(e, dim=-1)
    assert not q.is_contiguous()
    got = tf.favor_attention_fused(q, k, v, w)
    want = tf.favor_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), w)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("bh,t,sms", [(384, 3137, 132), (256, 3137, 132),
                                      (4, 3137, 132), (28, 3137, 132),
                                      (1, 1, 132), (4, 33, 132),
                                      (2, 1049, 132), (7, 1048, 8)])
def test_t_tiles(bh, t, sms):
    """Whole chunks per tile (the kernels' tile_rows_of), no empty tile,
    at most MAX_TILES; a batch that fills the card alone splits T at
    most in two, to even the waves."""
    n = tf.t_tiles(bh, t, sms)
    rows = -(-(-(-t // n)) // tf.CHUNK_ROWS) * tf.CHUNK_ROWS
    assert 1 <= n <= tf.MAX_TILES and -(-t // rows) == n
    assert (n - 1) * rows < t <= n * rows
    if bh >= tf.BLOCKS_PER_SM * sms:
        assert n <= 2


def test_ops_tiling_at_vip_shapes():
    # train (bs 96 x 4 heads): two tiles, 768 blocks in ~3 waves of 264
    assert tf.t_tiles(384, 3137, 132) == 2
    # serving bucket 64: one wave of 256 blocks, no partials
    assert tf.t_tiles(256, 3137, 132) == 1
    # serving bucket 1 (4 heads): T split so the 132 SMs have work
    assert tf.t_tiles(4, 3137, 132) * 4 >= 132


def test_other_devices_raise():
    x = torch.empty(1, 1, 4, 8, device="meta")
    w = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tf.favor_attention_fused(x, x, x, w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tf.favor_stats(x, x, w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tf.favor_apply(x, torch.empty(1, 1, 2, device="meta"),
                       torch.empty(1, 1, 2, 8, device="meta"), w)
