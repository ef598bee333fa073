"""Train step, flagship-train: host milliseconds a step inside the
program's span ``scat.train.forward``, the model's forward, the
projection and the loss, the model's own spans included, in the stretch
traced with the CPU activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.train.forward")
