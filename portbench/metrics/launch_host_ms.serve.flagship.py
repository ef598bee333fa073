"""Serving front end, flagship-serve: host milliseconds a request inside
the program's span ``scat.serve.launch``, the artifact's static-input
copy, graph replay and output clones, in the stretch traced with the CPU
activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.serve.launch")
