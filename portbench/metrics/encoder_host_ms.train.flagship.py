"""Model, flagship-train: host milliseconds a step inside the program's
span ``scat.model.encoder``, the ResNet-50 encoder and the 1x1 channel
reduction, in the stretch traced with the CPU activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.model.encoder")
