"""Model, hrnet-serve: the forward FLOPs of the crops answered in the
window (padding rows not counted; ``hrnet_flops.py`` beside this file)
over the window's wall time and the card's bf16 tensor-core peak."""

import os

from harness import bench, yardstick

FLOPS = bench.load_module(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "hrnet_flops.py"))


def read(trace, work, config, traffic):
    if not work.get("window_s") or not work.get("window_crops"):
        return None
    flops = FLOPS.forward_flops(config) * work["window_crops"]
    return 100.0 * flops / (work["window_s"] * yardstick.PEAK_BF16)
