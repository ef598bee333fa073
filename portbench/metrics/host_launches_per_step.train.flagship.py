"""Train step, flagship-train: CUDA runtime calls that put work on the device
(kernel, graph, copy and set launches) a step, from the profiler's
host-side runtime events over the steps of the stretch traced with the
CPU activity."""

from harness import readings


def read(trace, work, config, traffic):
    return readings.launches_per_step(trace, work)
