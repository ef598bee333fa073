"""The reduction of a trace: the union of device intervals, the idle
share, the gaps named by what the host was doing, the families."""

import pytest

from harness import trace
from harness.trace import Event


def timeline():
    device = [Event("conv_fprop", 10, 40), Event("copy_kernel", 30, 50),
              Event("Memcpy HtoD (Pageable -> Device)", 70, 80),
              Event("attention_fwd_bf16_kernel", 90, 95)]
    host = [Event(trace.STRETCH, 0, 100, 0),
            Event("aten::to", 55, 75, 0), Event("cudaMemcpyAsync", 56, 74, 1),
            Event("cudaLaunchKernel", 85, 86, 0)]
    return trace.Trace((0.0, 100.0), device, host)


def test_busy_is_the_union_of_device_intervals():
    t = timeline()
    assert t.busy_intervals() == [(10, 50), (70, 80), (90, 95)]
    assert t.busy_s == pytest.approx(55e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.gaps() == [(0.0, 10), (50, 70), (80, 90), (95, 100.0)]


@pytest.mark.parametrize("cell, metric", [
    ("flagship-train", "idle_pct.train.flagship"),
    ("vip-train", "idle_pct.train.vip"),
    ("flagship-serve", "idle_pct.serve.flagship")])
def test_idle_share_is_traced_busy_over_unprofiled_wall(cell, metric):
    from harness import bench
    reader = bench.load_cell(cell).metric_readers()[metric]
    # 55 us busy for 10 traced crops; the window ran 1,000 crops in 10 ms
    slow = trace.Trace((0.0, 900.0), timeline().device, [])
    work = {"window_s": 0.01, "window_crops": 1000, "trace_crops": 10}
    got = reader.read(trace.Traces(timeline(), slow), work, {}, {})
    assert got == pytest.approx(100 * (1 - 5.5e-6 / 1e-5))
    assert reader.read(None, work, {}, {}) is None
    assert reader.read(trace.Traces(timeline(), slow),
                       dict(work, trace_crops=0), {}, {}) is None


def test_device_time_a_crop_is_traced_busy_over_traced_crops():
    """flagship-train's end-to-end metric: the union of the device
    intervals a crop, whatever the stretch's wall time; nothing off the
    card."""
    from harness import readings
    slow = trace.Trace((0.0, 900.0), timeline().device, [])
    assert readings.device_us_per_crop(timeline(), 10) == pytest.approx(5.5)
    assert readings.device_us_per_crop(slow, 10) == pytest.approx(5.5)
    assert readings.device_us_per_crop(trace.Trace((0.0, 9.0), [], []),
                                       10) is None
    assert readings.device_us_per_crop(None, 10) is None


def test_the_window_rate_is_every_crop_over_the_wall_time():
    from harness import bench
    reader = bench.load_cell("flagship-train").metric_readers()[
        "window_crops_per_s.train.flagship"]
    assert reader.read(None, {"window_s": 40.0, "window_crops": 96000},
                       {}, {}) == pytest.approx(2400.0)
    assert reader.read(None, {"window_s": 0.0, "window_crops": 0},
                       {}, {}) is None


def test_gaps_are_named_by_the_outermost_host_operation():
    quiet = trace.Trace((0.0, 100.0), timeline().device[:1], [])
    b = trace.breakdown(quiet, timeline())
    assert [n for n, _ in b["device_ops"]] == [
        "GEMM and convolution | conv_fprop"]
    b = trace.breakdown(timeline())
    idle = dict(b["idle_gaps"])
    assert idle["aten::to"] == pytest.approx(20e-6)
    assert idle["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert idle["python"] == pytest.approx(15e-6)
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "GEMM and convolution | conv_fprop"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_families_and_counts():
    t = timeline()
    fams = dict(trace.families(t))
    assert fams["hand-written kernels"] == pytest.approx(5e-6)
    assert fams["copies and casts"] == pytest.approx(30e-6)
    assert t.device_time(("Memcpy HtoD",)) == (pytest.approx(10e-6), 1)
    assert t.host_count(("cudaMemcpyAsync", "cudaLaunchKernel")) == 2


def test_a_profile_of_host_work_reduces():
    import torch
    t = trace.profile(lambda: torch.ones(64, 64) @ torch.ones(64, 64),
                      True, "cpu")
    assert t.window_s > 0 and t.device == []
    assert any(e.name == "aten::matmul" for e in t.host)


def test_a_stretch_without_host_events_takes_the_host_wall_time():
    device = [Event("conv_fprop", 1000.0, 1400.0),
              Event("copy_kernel", 1500.0, 1600.0)]
    t = trace.reduce_events([], 0.002)
    assert t.window == (0.0, 2000.0)

    class Range:
        def __init__(self, e):
            self.start, self.end = e.start, e.end

    class Fake:
        def __init__(self, e):
            import torch
            self.name, self.time_range = e.name, Range(e)
            self.device_type = torch.autograd.DeviceType.CUDA
            self.is_user_annotation = False

    t = trace.reduce_events([Fake(e) for e in device], 0.001)
    assert t.window == (1000.0, 2000.0)
    assert t.busy_s == pytest.approx(500e-6)
    assert t.gaps() == [(1400.0, 1500.0), (1600.0, 2000.0)]
