"""The arithmetic that several per-layer metrics share, each reading
one cell group's traced stretches (``harness.trace.Traces``) or the
window's record (the driver's ``work``); a metric's file under
``portbench/metrics/`` names which, and returns None where there is
nothing to read."""

from __future__ import annotations

import statistics

from harness import yardstick

# host-side CUDA runtime and driver calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
                "cudaMemcpy", "cudaMemsetAsync", "cudaMemset")
UPLOADS = ("Memcpy HtoD",)


def idle_pct(traces, work: dict) -> "float | None":
    """100 x the share of the window in which the device is idle: one
    less the traced busy time a crop (the union of the device intervals
    of the stretch traced with the CUDA activity alone) over the
    window's wall time a crop, which no profiler slowed.  Tracing slows
    a host-paced step (every launch recorded), so the traced stretch's
    own wall time overstates idle time; it also lengthens each kernel a
    little, so a device-bound cell can read just under 0."""
    if traces is None or not work.get("window_crops") \
            or not work.get("trace_crops"):
        return None
    busy = traces.cuda_only.busy_s / work["trace_crops"]
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy * work["window_crops"] / work["window_s"])


def device_us_per_crop(trace, crops: int) -> "float | None":
    """Microseconds of device busy time (the union of the device
    intervals of a stretch traced with the CUDA activity alone) a crop
    of the stretch; None where the trace holds no device work (off the
    card)."""
    if trace is None or crops <= 0 or trace.busy_s <= 0:
        return None
    return 1e6 * trace.busy_s / crops


def mfu_pct(work: dict, config: dict, passes: float) -> "float | None":
    """100 x ``passes`` forward FLOPs of each crop of the window (padding
    rows not counted) over the window's wall time and the card's bf16
    tensor-core peak."""
    if not work.get("window_s") or not work.get("window_crops"):
        return None
    flops = passes * yardstick.forward_flops(config) * work["window_crops"]
    return 100.0 * flops / (work["window_s"] * yardstick.PEAK_BF16)


def dispatch_ms(work: dict) -> "float | None":
    """The median host milliseconds for a step call to return, over the
    window's steps."""
    times = work.get("dispatch_s") or []
    return 1e3 * statistics.median(times) if times else None


def launches_per_step(traces, work: dict) -> "float | None":
    """CUDA runtime calls that put work on the device, a step, over the
    steps of the stretch traced with the CPU activity."""
    steps = work.get("trace_steps", 0)
    if traces is None or not steps:
        return None
    count = traces.with_host.host_count(LAUNCH_CALLS)
    return count / steps if count else None


def upload_pct(traces) -> "float | None":
    """The device time of host-to-device copies as a share of the device
    busy time, in the stretch traced with the CUDA activity alone."""
    if traces is None or traces.cuda_only.busy_s <= 0:
        return None
    seconds, count = traces.cuda_only.device_time(UPLOADS)
    if count == 0:
        return None
    return 100.0 * seconds / traces.cuda_only.busy_s
