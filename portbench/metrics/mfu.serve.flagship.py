"""Model, flagship-serve: the forward FLOPs of the crops answered in the
window (padding rows not counted) over the window's wall time and the
card's bf16 tensor-core peak."""

from harness import readings


def read(trace, work, config, traffic):
    return readings.mfu_pct(work, config, 1.0)
