"""Model, flagship-train: host milliseconds a step inside the program's
span ``scat.model.tokens``, the token build, position encoding and mask,
and the pyramid transformer with the attention kernels, in the stretch
traced with the CPU activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.model.tokens")
