"""Train step, flagship-train: every crop of every step in the window
over the window's wall time (host clock, ending in a synchronize).  The
host's launches pace this step, so the rate follows the host's speed,
which swings between runs by more than an end-to-end bound may allow;
the cell's end-to-end metric is the device time a crop instead."""


def read(trace, work, config, traffic):
    if not work.get("window_s") or not work.get("window_crops"):
        return None
    return work["window_crops"] / work["window_s"]
