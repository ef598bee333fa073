"""Train step, flagship-train: host milliseconds a step inside the
program's span ``scat.train.optimizer``, Adam's step and the schedule's,
in the stretch traced with the CPU activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.train.optimizer")
