"""The FLOPs a crop, the serving chunks (held to the port's own
bucketing), and each kernel's roofline arithmetic, against PERF.md
section 6's bound column at its shapes."""

import numpy as np
import pytest
import torch

from harness import bench, trace, yardstick


def fake_trace(events):
    """Traces whose CUDA-only stretch holds the device events (name,
    microseconds) back to back."""
    out, at = [], 0.0
    for name, us in events:
        out.append(trace.Event(name, at, at + us))
        at += us
    quiet = trace.Trace((0.0, at), out, [])
    return trace.Traces(quiet, trace.Trace((0.0, at), [], []))


def test_flops_a_crop():
    assert yardstick.resnet50_macs(224) == (4_089_233_408, 28)
    flagship = bench.load_cell("flagship-train").config
    vip = bench.load_cell("vip-train").config
    assert yardstick.forward_flops(flagship) == 8_354_012_794.0
    assert yardstick.forward_flops(vip) == 50_733_450_264.0


@pytest.mark.parametrize("n, want", [(8, [8]), (9, [16]), (64, [64]),
                                     (65, [64, 1]), (200, [64, 64, 64, 8]),
                                     (256, [64] * 4)])
def test_chunks_follow_the_bucket_ladder(n, want):
    assert yardstick.chunks(n, [1, 2, 4, 8, 16, 32, 64]) == want


@pytest.mark.parametrize("max_batch", [64, 48])
def test_chunks_are_the_ports_own(max_batch):
    """The copy in the yardstick chunks every request size as the port's
    serving.run_bucketed hands the chunks to the program."""
    from scat_tpu_torch.serving import bucket_ladder, run_bucketed
    ladder = bucket_ladder(max_batch)
    for n in range(1, 4 * max_batch + 2):
        rows = []

        def forward(xb):
            rows.append(xb.shape[0])
            return tuple(torch.zeros(xb.shape[0], k) for k in (3, 63, 42))
        run_bucketed(forward, np.zeros((n, 1), np.float32), ladder,
                     torch.from_numpy)
        assert rows == yardstick.chunks(n, ladder), n


# PERF.md section 6, bound column (ms): attention_fwd at [96,8,N,64]
# N = 21 and 128, attention_bwd the same; favor_stats and favor_apply at
# [96,4,3137,128], m = 64
ATTENTION = {("fwd", 21): 0.002465, ("fwd", 128): 0.015024,
             ("bwd", 21): 0.004314, ("bwd", 128): 0.026293}


@pytest.mark.parametrize("kind, n", sorted(ATTENTION))
def test_attention_bounds_reproduce_the_table(kind, n):
    cell = bench.load_cell("flagship-train")
    metric = cell.metric_readers()[f"attention_{kind}_roofline.train"]
    config = dict(cell.config, model=dict(cell.config["model"], tokens=n))
    want_ms = ATTENTION[(kind, n)]
    # one step's three launches at twice the bound each: 50%
    t = fake_trace([(f"attention_{kind}_bf16_kernel", 2e3 * want_ms)] * 3)
    got = metric.read(t, {"batch": 96, "trace_steps": 1}, config, {})
    assert got == pytest.approx(50.0, rel=2e-3)


@pytest.mark.parametrize("name, want_ms", [("favor_stats", 0.187902),
                                           ("favor_apply", 0.279956)])
def test_favor_bounds_reproduce_the_table(name, want_ms):
    cell = bench.load_cell("vip-train")
    metric = cell.metric_readers()[f"{name}_roofline.train"]
    events = [(f"{name}_kernel", 4e3 * want_ms)] * 3
    if name == "favor_stats":   # the split-T sum counts with the stats
        events += [("favor_reduce_kernel", 0.0)]
    got = metric.read(fake_trace(events), {"batch": 96, "trace_steps": 1},
                      cell.config, {})
    assert got == pytest.approx(25.0, rel=2e-4)


def test_serving_rooflines_follow_the_requests_chunks():
    cell = bench.load_cell("vip-serve")
    metric = cell.metric_readers()["favor_apply_roofline.serve"]
    work = {"trace_sizes": [70], "buckets": [1, 2, 4, 8, 16, 32, 64]}
    model = cell.config["model"]
    bound = sum(metric.launch_bound(b, model) for b in (64, 8)) * 3
    t = fake_trace([("favor_apply_bf16_kernel", 1e6 * bound / 6)] * 6)
    assert metric.read(t, work, cell.config, {}) == pytest.approx(100.0)
    # launches that are not the reckoned work: the reader says so
    short = fake_trace([("favor_apply_bf16_kernel", 10.0)] * 5)
    with pytest.raises(RuntimeError, match="5 launches .* reckoned 6"):
        metric.read(short, work, cell.config, {})
    # the kernel off the path: nothing to read
    assert metric.read(fake_trace([("gemm", 10.0)]), work, cell.config,
                       {}) is None


def test_mfu_counts_three_forwards_a_trained_crop():
    cell = bench.load_cell("flagship-train")
    readers = cell.metric_readers()
    work = {"window_s": 1.0, "window_crops": 1000}
    got = readers["mfu.train.flagship"].read(None, work, cell.config, {})
    assert got == pytest.approx(100 * 3 * 8.354012794e12 / 989e12)
