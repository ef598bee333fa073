"""Train step, flagship-train: host milliseconds for a step call to return, the
median over the window's steps (host clock around each call, no
synchronisation inside the window)."""

from harness import readings


def read(trace, work, config, traffic):
    return readings.dispatch_ms(work)
