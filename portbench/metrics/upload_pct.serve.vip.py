"""Serving front end, vip-serve: the device time of host-to-device copies
(the requests' pageable uploads) as a share of the device busy time, in
the stretch traced with the CUDA activity alone."""

from harness import readings


def read(trace, work, config, traffic):
    return readings.upload_pct(trace)
