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


def test_plain_versions_keep_float64(rng):
    """The plain versions compute in float32 for float32 and bf16
    operands and keep float64 ones in float64 (the precision the bf16
    kernels are held to on the card), where they agree with the float32
    results to float32's accuracy."""
    q, k, v, w = _t(*_qkvw(rng, (2, 3, 40, 32), 16, scale=0.5))
    ksum, kptv = tf.favor_stats_reference(k, v, w)
    y = tf.favor_apply_reference(q, ksum, kptv, w)
    assert ksum.dtype == kptv.dtype == y.dtype == torch.float32
    half = tf.favor_apply_reference(q.bfloat16(), ksum, kptv, w)
    assert half.dtype == torch.float32
    ksum64, kptv64 = tf.favor_stats_reference(k.double(), v.double(),
                                              w.double())
    y64 = tf.favor_apply_reference(q.double(), ksum64, kptv64, w.double())
    assert ksum64.dtype == kptv64.dtype == y64.dtype == torch.float64
    torch.testing.assert_close(ksum64.float(), ksum, rtol=1e-5, atol=0)
    torch.testing.assert_close(kptv64.float(), kptv, rtol=1e-5,
                               atol=1e-6 * kptv.abs().max().item())
    torch.testing.assert_close(y64.float(), y, rtol=1e-5, atol=1e-6)


def _split3(x):
    """The bf16x3 split of the stats kernel: three bf16 values (as
    float32) whose sum is x, part i = bf16(x - parts before it)."""
    parts, rest = [], x
    for _ in range(3):
        part = rest.bfloat16().float()
        parts.append(part)
        rest = rest - part
    return parts


def _tensor_core_stats(k, v, w, sms=132):
    """The bf16 stats kernel's arithmetic on the CPU, in its order, for
    bf16-valued k and v [BH, T, e] and float32 w [m, e]: T cut into the
    kernel's T-tiles (``t_tiles`` for its 128-row rounds), each tile into
    64-row slabs taken by two warpgroups in turn.  Per slab: wx as a sum
    over 16-column k-steps of chains of the products with w's three bf16
    parts (smallest first), added in float32; phi in float32; the slab's
    chain of phi's three parts times v added to the warpgroup's running
    kptv in float32.  ksum and kptv: the two warpgroups' partials summed
    in order, then the tiles in order (the reduce kernel)."""
    bh, t, e = k.shape
    chunk, per_sm = tf.stats_tiling(torch.bfloat16)
    tiles = tf.t_tiles(bh, t, sms, chunk, per_sm)
    per_tile = -(-(-(-t // tiles)) // chunk) * chunk
    w_parts = list(reversed(_split3(w)))
    ksum = torch.zeros(bh, w.shape[0])
    kptv = torch.zeros(bh, w.shape[0], e)
    for begin in range(0, t, per_tile):
        ks = [torch.zeros_like(ksum) for _ in range(2)]
        kv = [torch.zeros_like(kptv) for _ in range(2)]
        for i, row in enumerate(range(begin, min(t, begin + per_tile), 64)):
            x = k[:, row:min(t, begin + per_tile, row + 64)]
            wx = torch.zeros(bh, x.shape[1], w.shape[0])
            for c in range(0, e, 16):
                wx = wx + sum(torch.einsum("bte,me->btm", x[..., c:c + 16],
                                           part[:, c:c + 16])
                              for part in w_parts)
            xd = 0.5 * (x * x).sum(dim=-1, keepdim=True)
            phi = torch.exp(wx - xd) / w.shape[0] ** 0.5
            ks[i % 2] = ks[i % 2] + phi.sum(dim=-2)
            vs = v[:, row:row + x.shape[1]]
            kv[i % 2] = kv[i % 2] + sum(
                torch.einsum("btm,bte->bme", part, vs)
                for part in reversed(_split3(phi)))
        ksum = ksum + (ks[0] + ks[1])
        kptv = kptv + (kv[0] + kv[1])
    return ksum, kptv


def test_split_parts_sum_back(rng):
    """The three bf16 parts of a float32 value sum back to it within 2^-24
    of its magnitude, over a wide range of exponents."""
    x = (rng.randn(20000) * 2.0 ** rng.uniform(-40, 40, 20000)).astype(
        np.float32)
    parts = _split3(torch.from_numpy(x))
    for part in parts:
        assert torch.equal(part, part.bfloat16().float())
    total = sum(part.double() for part in parts).numpy()
    assert np.all(np.abs(total - x) <= 2.0 ** -24 * np.abs(x))


def test_tensor_core_split_matches_pallas_stats(rng, monkeypatch):
    """The bf16 stats kernel's arithmetic in its order (the bf16x3 split
    of w and phi, per-k-step feature chains, per-slab outer-product chains,
    two warpgroups' partials and five T-tiles of 256 rows summed in order)
    against the stats pallas_call of _favor_impl (captured as it returns)
    at T = 1100 with bf16-valued k and v, at the card's tolerance: rtol
    1e-4, atol 1e-5 of the largest magnitude."""
    calls = []
    real = pf.pl.pallas_call

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run(*operands):
            calls.append(fn(*operands))
            return calls[-1]
        return run

    monkeypatch.setattr(pf.pl, "pallas_call", spy)
    bh, t, e, m = 2, 1100, 64, 32
    q, k, v, w = _qkvw(rng, (bh, t, e), m, scale=0.5)
    k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (k, v))
    pf._favor_impl(*map(jnp.asarray, (q, k, v, w)))
    jksum, jkptv = (np.asarray(a) for a in calls[0])
    assert tf.t_tiles(bh, t, 132, *tf.stats_tiling(torch.bfloat16)) == 5
    ksum, kptv = _tensor_core_stats(*_t(k, v, w))
    for got, want in ((ksum.numpy(), jksum[:, 0]), (kptv.numpy(), jkptv)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def _tensor_core_apply(q, ksum, kptv, w):
    """The bf16 apply kernel's arithmetic on the CPU, for bf16-valued q
    [BH, T, e], float32 stats and w: wq as the sum of the products with
    w's three bf16 parts (smallest first), phi and D = phi . ksum in
    float32, and phi kptv as the six products phi_i kptv_j of their
    three bf16 parts with i + j <= 2, smallest first, over D."""
    wq = sum(torch.einsum("bte,me->btm", q, part)
             for part in reversed(_split3(w)))
    xd = 0.5 * (q * q).sum(dim=-1, keepdim=True)
    phi = torch.exp(wq - xd) / w.shape[0] ** 0.5
    d = torch.einsum("btm,bm->bt", phi, ksum)[..., None]
    pp, kp = _split3(phi), _split3(kptv)
    y = sum(torch.einsum("btm,bme->bte", pp[i], kp[j])
            for i, j in ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)))
    return y / d


def test_tensor_core_split_matches_pallas_apply(rng, monkeypatch):
    """The bf16 apply's split arithmetic (w in three parts, phi and kptv
    in three parts with six cross products) against the apply
    pallas_call of _favor_impl (captured as it returns, on the Pallas
    stats) at T = 1100 with bf16-valued q, at the card's tolerance: rtol
    1e-4, atol 1e-5."""
    calls = []
    real = pf.pl.pallas_call

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run(*operands):
            calls.append(fn(*operands))
            return calls[-1]
        return run

    monkeypatch.setattr(pf.pl, "pallas_call", spy)
    bh, t, e, m = 2, 1100, 64, 32
    q, k, v, w = _qkvw(rng, (bh, t, e), m, scale=0.5)
    q = torch.from_numpy(q).bfloat16().float().numpy()
    pf._favor_impl(*map(jnp.asarray, (q, k, v, w)))
    (jksum, jkptv), jy = (tuple(np.array(a) for a in calls[0]),
                          np.array(calls[1]))
    got = _tensor_core_apply(*_t(q), *_t(jksum[:, 0], jkptv, w))
    np.testing.assert_allclose(got.numpy(), jy[:, :t], rtol=1e-4, atol=1e-5)


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


@pytest.mark.parametrize("bh,t,sms", [(384, 3137, 132), (256, 3137, 132),
                                      (4, 3137, 132), (28, 3137, 132),
                                      (1, 1, 132), (4, 65, 132),
                                      (4, 129, 132), (4, 1281, 132),
                                      (7, 1048, 8)])
def test_t_tiles_stats_kernel(bh, t, sms):
    """The bf16 stats kernel's tiling: whole 128-row rounds (two
    warpgroups of 64-row slabs) per tile, no empty tile, at most
    MAX_TILES; one block an SM, so a batch of at least one block per SM
    splits T at most in two."""
    chunk, per_sm = tf.stats_tiling(torch.bfloat16)
    assert (chunk, per_sm) == (tf.TC_CHUNK_ROWS, tf.TC_BLOCKS_PER_SM)
    n = tf.t_tiles(bh, t, sms, chunk, per_sm)
    rows = -(-(-(-t // n)) // chunk) * chunk
    assert 1 <= n <= tf.MAX_TILES and -(-t // rows) == n
    assert (n - 1) * rows < t <= n * rows
    if bh >= per_sm * sms:
        assert n <= 2


@pytest.mark.parametrize("bh,t,sms", [(384, 3137, 132), (256, 3137, 132),
                                      (4, 3137, 132), (28, 3137, 132),
                                      (1, 1, 132), (4, 257, 132),
                                      (4, 1281, 132), (7, 1048, 8)])
def test_t_tiles_apply_kernel(bh, t, sms):
    """The bf16 apply kernel's tiling: whole 192-row rounds (three
    warpgroups of 64 rows) per tile, no empty tile, at most MAX_TILES;
    one block an SM, so a batch of at least one block per SM splits T at
    most in two."""
    chunk, per_sm = tf.apply_tiling(torch.bfloat16)
    assert (chunk, per_sm) == (tf.TC_APPLY_CHUNK_ROWS,
                               tf.TC_APPLY_BLOCKS_PER_SM)
    n = tf.t_tiles(bh, t, sms, chunk, per_sm)
    rows = -(-(-(-t // n)) // chunk) * chunk
    assert 1 <= n <= tf.MAX_TILES and -(-t // rows) == n
    assert (n - 1) * rows < t <= n * rows
    if bh >= per_sm * sms:
        assert n <= 2


def test_stats_tiling_at_vip_shapes():
    assert tf.stats_tiling(torch.float32) == (tf.CHUNK_ROWS,
                                              tf.BLOCKS_PER_SM)
    tc = tf.stats_tiling(torch.bfloat16)
    assert tc == (128, 1)
    # train (bs 96 x 4 heads): 384 blocks, three waves of one an SM
    assert tf.t_tiles(384, 3137, 132, *tc) == 1
    # serving bucket 64: 256 blocks, no partials
    assert tf.t_tiles(256, 3137, 132, *tc) == 1
    # serving bucket 1 (4 heads): T split into tiles of two 128-row rounds
    assert tf.t_tiles(4, 3137, 132, *tc) == 13


def test_ops_tiling_at_vip_shapes():
    # train (bs 96 x 4 heads): two tiles, 768 blocks in ~3 waves of 264
    assert tf.t_tiles(384, 3137, 132) == 2
    # serving bucket 64: one wave of 256 blocks, no partials
    assert tf.t_tiles(256, 3137, 132) == 1
    # serving bucket 1 (4 heads): T split so the 132 SMs have work
    assert tf.t_tiles(4, 3137, 132) * 4 >= 132
    # the apply kernel float32 q launches takes these defaults; bf16 q
    # launches the tensor-core kernel, one block of 192-row rounds an SM
    assert tf.apply_tiling(torch.float32) == (tf.CHUNK_ROWS,
                                              tf.BLOCKS_PER_SM)
    ap = tf.apply_tiling(torch.bfloat16)
    # train: 384 blocks, three waves; serving bucket 64: 256 blocks
    assert tf.t_tiles(384, 3137, 132, *ap) == 1
    assert tf.t_tiles(256, 3137, 132, *ap) == 1
    # serving buckets 7 and 1: T split into tiles of two rounds
    assert tf.t_tiles(28, 3137, 132, *ap) == 9
    assert tf.t_tiles(4, 3137, 132, *ap) == 9


@pytest.mark.parametrize("e,offset,strided", [(128, 0, True), (128, 3, False),
                                              (36, 0, False), (36, 0, True),
                                              (64, 0, False)])
def test_tma_rows(e, offset, strided):
    """The bf16 stats kernel's TMA copies take rows that start on 16
    bytes: aligned bf16 operands pass as they are; others (an odd start,
    e % 8 != 0) are copied into zero-padded rows of a multiple of 8
    elements, the same values; float32 operands pass as they are."""
    b, h, t = 2, 3, 5
    src = torch.arange(b * t * h * 3 * e + offset, dtype=torch.float32)
    src = src.bfloat16()[offset:]
    if strided:   # the Performer block's k view of its [B,T,H,3e] kqv
        x = src.view(b, t, h, 3 * e).permute(0, 2, 1, 3)[..., :e]
    else:
        x = src[:b * h * t * e].view(b, h, t, e)
    got = tf._tma_rows(x)
    aligned = x.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for s in x.stride()[:3])
    assert (got is x) == aligned
    assert aligned == (offset == 0 and e % 8 == 0)
    assert torch.equal(got, x) and got.shape == x.shape
    assert got.data_ptr() % 16 == 0
    assert all(s % 8 == 0 for s in got.stride()[:3])
    f32 = x.float()
    assert tf._tma_rows(f32) is f32


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


def _grads_through(fn, q, k, v, w, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(fn(*leaves, w), leaves, g)


# [B, H, T, e, m]: T off the backward kernels' row chunks (32 float32, 128
# bf16) and their edges, e 72 and 128, m 16 and 64
BWD_SHAPES = [(2, 3, 37, 72, 16), (1, 2, 129, 128, 64),
              (2, 1, 33, 128, 16), (1, 2, 65, 72, 64)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_reference_matches_autograd(rng, shape):
    """favor_backward_reference (the backward kernels' closed form) against
    torch.autograd.grad through favor_attention, both in float64, from the
    forward's moments."""
    b, h, t, e, m = shape
    q, k, v, w = (torch.from_numpy(a).double()
                  for a in _qkvw(rng, (b, h, t, e), m, scale=0.5))
    g = torch.from_numpy(rng.randn(b, h, t, e))
    ksum, kptv = tf.favor_stats_reference(k, v, w)
    got = tf.favor_backward_reference(q, k, v, g, ksum, kptv, w)
    want = _grads_through(tf.favor_attention, q, k, v, w, g)
    for name, a, c in zip("qkv", got, want):
        assert a.dtype == torch.float64 and a.shape == c.shape
        torch.testing.assert_close(a, c, rtol=1e-10, atol=1e-12,
                                   msg=f"d{name}")


@pytest.mark.parametrize("shape", [(3, 37, 72, 16), (2, 130, 128, 64)])
def test_fused_backward_3d_matches_autograd(rng, shape):
    """The [B,T,e] entry: favor_attention_fused's gradients (the backward
    ops' CPU implementations) against autograd through favor_attention,
    float64."""
    b, t, e, m = shape
    q, k, v, w = (torch.from_numpy(a).double()
                  for a in _qkvw(rng, (b, t, e), m, scale=0.5))
    g = torch.from_numpy(rng.randn(b, t, e))
    got = _grads_through(tf.favor_attention_fused, q, k, v, w, g)
    want = _grads_through(tf.favor_attention, q, k, v, w, g)
    for a, c in zip(got, want):
        assert a.shape == (b, t, e)
        torch.testing.assert_close(a, c, rtol=1e-10, atol=1e-12)


def _bwd_op_cases():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 37, 72, generator=g) * 0.5
               for _ in range(3))
    w = torch.randn(16, 72, generator=g)
    dy = torch.randn(2, 37, 3, 72, generator=g).permute(0, 2, 1, 3)
    ksum, kptv = tf.favor_stats_reference(k, v, w)
    dq, dkptv, dksum = tf._favor_bwd_q(q, dy, ksum, kptv, w)
    bf = [t.bfloat16() for t in (q, k, v)]
    return {
        "favor_bwd_q": (tf._favor_bwd_q, (q, dy, ksum, kptv, w)),
        "favor_bwd_q-bf16": (tf._favor_bwd_q, (bf[0], dy, ksum, kptv, w)),
        "favor_bwd_kv": (tf._favor_bwd_kv, (k, v, dkptv, dksum, w)),
        "favor_bwd_kv-bf16": (tf._favor_bwd_kv,
                              (bf[1], bf[2], dkptv, dksum, w)),
    }


@pytest.mark.parametrize("case", sorted(_bwd_op_cases()))
def test_backward_ops_pass_opcheck(case):
    """The backward ops' schema, fake implementation (the CPU outputs'
    shapes, dtypes and strides) and dispatch under opcheck; the outputs
    in the operands' dtype, the moments' gradients in float32."""
    op, args = _bwd_op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert all(r == "SUCCESS" for r in result.values()), result
    out = op(*args)
    assert out[0].dtype == args[0].dtype and out[0].shape == args[0].shape
    if case.startswith("favor_bwd_q"):
        assert out[1].dtype == out[2].dtype == torch.float32


def test_backward_wrappers_are_counted():
    from scat_tpu_torch.ops import COUNTED
    for name in ("favor_bwd_q", "favor_bwd_kv", "favor_stats",
                 "favor_apply"):
        assert COUNTED[name] is getattr(tf, name)
    assert tf.backward_tiling(torch.bfloat16) == (tf.TC_BWD_CHUNK_ROWS, 1)
    assert tf.backward_tiling(torch.float32) == (tf.BWD_CHUNK_ROWS, 1)


def test_backward_runs_no_forward_pass(rng, monkeypatch):
    """_FavorAttention's backward on CPU tensors takes the two backward
    ops once each from the forward's saved moments, and runs neither the
    stats nor the apply pass again; bf16 operands get bf16 gradients."""
    calls = []

    def spy(name):
        inner = getattr(tf, name)
        return lambda *a: calls.append(name) or inner(*a)

    for name in ("favor_stats", "favor_apply", "favor_bwd_q",
                 "favor_bwd_kv"):
        monkeypatch.setattr(tf, name, spy(name))
    q, k, v, w = _t(*_qkvw(rng, (2, 2, 40, 32), 16))
    leaves = [t.bfloat16().requires_grad_(True) for t in (q, k, v)]
    out = tf.favor_attention_fused(*leaves, w)
    assert calls == ["favor_stats", "favor_apply"]
    grads = torch.autograd.grad(out, leaves, torch.randn_like(out))
    assert calls[2:] == ["favor_bwd_q", "favor_bwd_kv"]
    assert all(g.dtype == torch.bfloat16 for g in grads)
