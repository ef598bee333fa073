"""The port's fused 1x1-convolution link (scat_tpu_torch.ops.fused_link)
against the JAX package's probe on the CPU: the Pallas kernel
``fused_link`` of ``benchmarks/probe_fused_link.py`` in interpret mode,
a float64 numpy reference at M that are not whole 128-row tiles, and a
narrow port ``Bottleneck``'s own links.

On CPU tensors ``fused_link`` takes the plain version, so these tests
hold the plain math, the wrapper's routing and checks and the custom
op's registration; the CUDA kernel itself is held against the plain
version on the card (chip_smoke.py's link phase,
tests/test_torch_cuda.py).

The tolerances are ``fused_link``'s (``Y_ULPS``, ``S_TOL``, ``SS_RTOL``,
``ROW_TOL``, applied by ``link_gaps``), of the port against the TPU
kernel's float32 arithmetic: both take xn = bf16(relu(x * scale +
shift)) and a float32 product, and only the order of the float32 sums
differs.  y within 1 bf16 ulp at max|y| (the sums' order may flip an
element's rounding); s within 1e-5 of the column's sum of |y|, ss within
2e-5 of itself, each plus one row's float32 rounding (1e-6 of the
largest sum over k of |xn w| a row takes: at M = 1 a column's s is one
dot product, which cancellation can leave far smaller than its
terms)."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scat_tpu_torch.models.resnet import Bottleneck
from scat_tpu_torch.ops import fused_link as fl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_probe():
    """benchmarks/probe_fused_link.py by path (benchmarks/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "probe_fused_link",
        os.path.join(REPO, "benchmarks", "probe_fused_link.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PROBE = _load_probe()


@pytest.fixture
def probe(monkeypatch):
    """The probe with ``pl.pallas_call`` in interpret mode for this test
    only."""
    monkeypatch.setattr(PROBE.pl, "pallas_call", functools.partial(
        PROBE.pl.pallas_call, interpret=True))
    return PROBE


def _operands(m, k, n, seed):
    """x [M, K] and w [K, N] at bf16 values, scale and shift [K], float32
    numpy: a post-conv activation about 0.5, a fan-in-scaled weight, a
    BatchNorm's folded affine about 1 and 0."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(k)).astype(np.float32)
    shift = (0.1 * rng.randn(k)).astype(np.float32)
    return _bf16_values(x), _bf16_values(w), scale, shift


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _torch(x, w, scale, shift):
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
            torch.from_numpy(scale), torch.from_numpy(shift))


def _pallas(probe, x, w, scale, shift, bm=None):
    y, s, ss = probe.fused_link(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(scale), jnp.asarray(shift),
                                bm=bm)
    return np.asarray(y.astype(jnp.float32)), np.asarray(s), np.asarray(ss)


def _ulp(a):
    """A bf16 ulp at the largest |a|: 2^(e-7) for max|a| in [2^e,
    2^(e+1))."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _xn(x, scale, shift):
    """bf16(relu(x * scale + shift)) in float32, as float64 numpy."""
    xn = np.maximum(x * scale + shift, np.float32(0))
    return torch.from_numpy(xn).bfloat16().double().numpy()


def _gaps(got, want, x, w, scale, shift):
    """``link_gaps`` of numpy (y, s, ss) against numpy (y, s, ss)."""
    (y, s, ss), (wy, ws, wss) = got, want
    assert y.shape == wy.shape and s.shape == ss.shape == (wy.shape[1],)
    return fl.link_gaps([torch.from_numpy(np.array(a)) for a in got],
                        [torch.from_numpy(np.array(a)) for a in want],
                        *_torch(x, w, scale, shift))


def _assert_link(got, want, x, w, scale, shift):
    gaps = _gaps(got, want, x, w, scale, shift)
    assert max(gaps.values()) <= 1, gaps


def _numpy(out):
    y, s, ss = out
    assert y.dtype == torch.bfloat16 and s.dtype == ss.dtype == torch.float32
    return y.float().numpy(), s.numpy(), ss.numpy()


# (M, K, N, bm): the TPU kernel's default tile, one whole tile of N = 1024
# split into two 512-wide N tiles, and an M of four 512-row tiles (bm
# below the default 2048) whose statistics it adds across grid steps
PALLAS_CASES = [(256, 64, 32, None), (2048, 256, 64, None),
                (1024, 128, 1024, None), (2048, 256, 64, 512)]


@pytest.mark.parametrize("fn", ["reference", "wrapper"])
@pytest.mark.parametrize("m,k,n,bm", PALLAS_CASES)
def test_matches_pallas_kernel(probe, fn, m, k, n, bm):
    x, w, scale, shift = _operands(m, k, n, seed=m + k + n)
    want = _pallas(probe, x, w, scale, shift, bm)
    f = fl.fused_link_reference if fn == "reference" else fl.fused_link
    _assert_link(_numpy(f(*_torch(x, w, scale, shift))), want, x, w,
                 scale, shift)


def test_statistics_follow_the_float32_accumulator(probe):
    """The TPU kernel's s and ss are sums of its float32 accumulator; the
    probe's xla_link sums the rounded y.  The port follows the kernel:
    within the tolerance of it, where xla_link is not, and its own
    rounded y would not give its s."""
    x, w, scale, shift = _operands(2048, 256, 64, seed=3)
    want = _pallas(probe, x, w, scale, shift)
    y, s, ss = _numpy(fl.fused_link(*_torch(x, w, scale, shift)))
    _assert_link((y, s, ss), want, x, w, scale, shift)
    xla = [np.asarray(a, np.float32) for a in probe.xla_link(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(shift))]
    gaps = _gaps(xla, want, x, w, scale, shift)
    assert gaps["s"] > 1 and gaps["ss"] > 1, gaps
    from_y = y.astype(np.float64).sum(0)
    assert np.abs(from_y - want[1]).max() > 10 * np.abs(s - want[1]).max()


@pytest.mark.parametrize("m,k,n", [(1, 256, 64), (129, 64, 256),
                                   (4704, 2048, 512)])
def test_tails_against_float64(m, k, n):
    """M = 1, 129 and 4704 (ResNet-50's layer4 links at bs 96), which the
    JAX function refuses (not whole 128-row tiles): against a float64
    numpy product of the same bf16 xn."""
    x, w, scale, shift = _operands(m, k, n, seed=m)
    acc = _xn(x, scale, shift) @ w.astype(np.float64)
    want = (torch.from_numpy(acc).bfloat16().float().numpy(), acc.sum(0),
            (acc * acc).sum(0))
    _assert_link(_numpy(fl.fused_link(*_torch(x, w, scale, shift))), want,
                 x, w, scale, shift)


def _bad_cases():
    x, w, scale, shift = _torch(*_operands(64, 32, 16, seed=0))
    wide = torch.zeros(64, 36, dtype=torch.bfloat16)
    return {
        "x float32": ((x.float(), w, scale, shift), TypeError, "bf16 x"),
        "w float16": ((x, w.half(), scale, shift), TypeError, "bf16 x"),
        "scale bf16": ((x, w, scale.bfloat16(), shift), TypeError,
                       "float32 scale"),
        "K mismatch": ((x, w[:24], scale, shift), ValueError, r"x \[M, K\]"),
        "shift length": ((x, w, scale, shift[:24]), ValueError,
                         r"x \[M, K\]"),
        "x 3-D": ((x[None], w, scale, shift), ValueError, r"x \[M, K\]"),
        "K not a multiple of 8": ((x[:, :28], w[:28], scale[:28],
                                   shift[:28]), ValueError, "multiples of 8"),
        "N not a multiple of 8": ((x, w[:, :12], scale, shift), ValueError,
                                  "multiples of 8"),
        "M = 0": ((x[:0], w, scale, shift), ValueError, "M >= 1"),
        "x row stride 36": ((wide[:, :32], w, scale, shift), ValueError,
                            "16-byte aligned"),
        "x rows start off 16 bytes": ((wide.view(-1)[4:4 + 64 * 32].view(
            64, 32), w, scale, shift), ValueError, "start on 16 bytes"),
        "w columns strided": ((x, w.t().contiguous().t(), scale, shift),
                              ValueError, "rows must be contiguous"),
        "scale strided": ((x, w, torch.zeros(64)[::2], shift), ValueError,
                          "must be contiguous"),
        "devices": ((x, w, scale, shift.to("meta")), ValueError,
                    "one device"),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_check_refuses_with_its_reason(case):
    args, error, match = _bad_cases()[case]
    with pytest.raises(error, match=match):
        fl.fused_link(*args)


def test_cpu_tensors_launch_nothing():
    before = fl.fused_link.launches
    out = fl.fused_link(*_torch(*_operands(300, 64, 128, seed=1)))
    assert all(t.device.type == "cpu" for t in out)
    assert fl.fused_link.launches == before


def test_op_passes_opcheck():
    """The op's schema, fake implementation (the CPU outputs' shapes and
    strides), autograd registration and dispatch."""
    args = _torch(*_operands(200, 64, 32, seed=2))
    result = torch.library.opcheck(torch.ops.scat_tpu_torch.fused_link, args)
    assert all(v == "SUCCESS" for v in result.values()), result


def _batch_stats(t):
    """Biased per-channel mean and variance of NCHW ``t`` in float64."""
    t = t.double()
    return t.mean(dim=(0, 2, 3)), t.var(dim=(0, 2, 3), unbiased=False)


def _rows(t):
    """NCHW ``t`` as [B*H*W, C] rows (the NHWC view)."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


@pytest.mark.parametrize("link", ["bn2 -> conv3", "input -> conv1"])
def test_bottleneck_link_equals_fused_link(link):
    """A narrow port Bottleneck (32 -> 8 -> 32 channels) in train mode in
    bf16 (autocast, channels_last): its bn2 -> relu -> conv3 link (or the
    block's post-ReLU input -> conv1, scale 1 and shift 0) equals
    fused_link on the hooked inputs, bn2's batch statistics and affine
    folded into scale and shift; s and ss equal the next BatchNorm's
    batch statistics as sums.  The chain rounds bn2's output where the
    link rounds x * scale + shift, so y within 2% of max|y| (the repo's
    bound for two bf16 paths that differ in rounding) and the statistics
    within 1e-3."""
    torch.manual_seed(0)
    block = Bottleneck(32, 8).train().to(memory_format=torch.channels_last)
    for bn in (block.bn1, block.bn2, block.bn3):
        bn.weight.data.uniform_(0.5, 1.5)
        bn.bias.data.uniform_(-0.2, 0.2)
    first, conv, bn, nxt = ((block.bn2, block.conv3, block.bn2, block.bn3)
                            if link == "bn2 -> conv3" else
                            (block, block.conv1, None, block.bn1))
    seen = {}
    first.register_forward_pre_hook(lambda _, a: seen.update(x=a[0]))
    nxt.register_forward_pre_hook(lambda _, a: seen.update(y=a[0]))
    x = torch.relu(torch.randn(4, 32, 16, 16)).to(
        memory_format=torch.channels_last)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        block(x)
    hx, hy = seen["x"], seen["y"]
    assert hy.dtype == torch.bfloat16
    if bn is None:
        hx = hx.bfloat16()
        scale, shift = torch.ones(32), torch.zeros(32)
    else:
        assert hx.dtype == torch.bfloat16
        mean, var = _batch_stats(hx)
        scale = bn.weight.double() / torch.sqrt(var + bn.eps)
        shift = bn.bias.double() - mean * scale
        scale, shift = scale.float(), shift.float()
    w = conv.weight.detach().bfloat16()[:, :, 0, 0].t().contiguous()
    rows = _rows(hx)
    assert rows.is_contiguous() and rows.shape[0] == 4 * 16 * 16
    y, s, ss = fl.fused_link(rows, w, scale, shift)
    want = _rows(hy).float()
    assert (y.float() - want).abs().max() <= 2e-2 * want.abs().max()
    mean, var = _batch_stats(hy)
    count = rows.shape[0]
    torch.testing.assert_close(s.double(), mean * count, rtol=0,
                               atol=1e-3 * want.abs().sum(0).double().max())
    torch.testing.assert_close(ss.double(), (var + mean * mean) * count,
                               rtol=1e-3, atol=0)
