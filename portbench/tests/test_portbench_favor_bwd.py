"""The reader of the FAVOR+ backward kernels' roofline
(``favor_bwd_roofline.train``) on synthetic traces: its bound from the
bytes and operations of the closed-form backward, nothing where the
backward is not these kernels, a refusal where the launches are not one a
block a traced step, and no crossing with the forward kernels' readers."""

import pytest

from harness import bench, trace

NAME = "favor_bwd_roofline.train"
# [96,4,3137,128], m 64: q, k, v in bf16 and dy in float32 read, dq, dk, dv
# in bf16 written (16 bytes an element), w, ksum and kptv read
BYTES = 96 * 4 * 3137 * 128 * 16 + 64 * 128 * 4 + 96 * 4 * (64 + 64 * 128) * 4
BOUND_MS = 1e3 * BYTES / 3.35e12   # the bytes bound it: 158 GFLOP is 0.16 ms


def fake_trace(events):
    """Traces whose CUDA-only stretch holds the device events (name,
    microseconds) back to back."""
    out, at = [], 0.0
    for name, us in events:
        out.append(trace.Event(name, at, at + us))
        at += us
    quiet = trace.Trace((0.0, at), out, [])
    return trace.Traces(quiet, trace.Trace((0.0, at), [], []))


def reader():
    cell = bench.load_cell("vip-train")
    return cell, cell.metric_readers()[NAME]


def backward(steps, q_us, kv_us, depth=3):
    """Each block's q and k, v launches (and a tile sum) for ``steps``."""
    one = [("favor_bwd_q_bf16_kernel", q_us),
           ("favor_bwd_reduce_kernel", 0.0),
           ("favor_bwd_kv_bf16_kernel", kv_us)]
    return one * depth * steps


def test_bound_is_the_backwards_bytes():
    assert BOUND_MS == pytest.approx(0.740224, rel=1e-6)
    cell, metric = reader()
    entry = next(m for m in cell.per_layer if m["name"] == NAME)
    assert entry["workloads"] == ["vip-train"] and entry["unit"] == "%"
    assert entry["moves"] == "train_crops_per_s.vip"
    # two traced steps of three blocks, each pair at four times the bound
    t = fake_trace(backward(2, 1e3 * BOUND_MS, 3e3 * BOUND_MS))
    got = metric.read(t, {"batch": 96, "trace_steps": 2}, cell.config, {})
    assert got == pytest.approx(25.0, rel=1e-9)


def test_nothing_to_read_without_the_kernels():
    cell, metric = reader()
    work = {"batch": 96, "trace_steps": 1}
    autograd = fake_trace([("gemm_f32f32_kernel", 50.0),
                           ("vectorized_elementwise_kernel", 20.0)])
    assert metric.read(autograd, work, cell.config, {}) is None
    assert metric.read(None, work, cell.config, {}) is None


def test_launches_off_the_reckoning_raise():
    cell, metric = reader()
    t = fake_trace(backward(1, 100.0, 100.0, depth=2))
    with pytest.raises(RuntimeError, match="2 launches .* reckoned 3"):
        metric.read(t, {"batch": 96, "trace_steps": 1}, cell.config, {})


@pytest.mark.parametrize("forward", ["favor_stats_roofline.train",
                                     "favor_apply_roofline.train"])
def test_the_forward_readers_ignore_the_backward(forward):
    """The forward kernels' readers match by substring and count their
    launches: the backward kernels' names hold neither of theirs."""
    cell = bench.load_cell("vip-train")
    metric = cell.metric_readers()[forward]
    kernel = forward.split("_roofline")[0] + "_kernel"
    work = {"batch": 96, "trace_steps": 1}
    alone = metric.read(fake_trace([(kernel, 500.0)] * 3), work,
                        cell.config, {})
    beside = metric.read(fake_trace([(kernel, 500.0)] * 3
                                    + backward(1, 900.0, 800.0)),
                         work, cell.config, {})
    assert beside == alone
