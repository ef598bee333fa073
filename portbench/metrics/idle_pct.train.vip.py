"""Device, vip-train: the share of the window in which no kernel, copy or
set runs on the card: one less the traced busy time a crop over the
window's unprofiled wall time a crop (``readings.idle_pct``)."""

from harness import readings


def read(trace, work, config, traffic):
    return readings.idle_pct(trace, work)
