"""Model, flagship-train: three times the forward FLOPs (forward, and the
backward's two products a forward product) of the crops trained in the
window, over the window's wall time and the card's bf16 tensor-core
peak."""

from harness import readings


def read(trace, work, config, traffic):
    return readings.mfu_pct(work, config, 3.0)
