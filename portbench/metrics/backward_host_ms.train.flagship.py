"""Train step, flagship-train: host milliseconds a step inside the
program's span ``scat.train.backward``, the host's side of the backward:
the autograd engine's launches, which the call waits for, in the stretch
traced with the CPU activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.train.backward")
