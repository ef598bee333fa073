"""Serving front end, vip-serve: host milliseconds a request inside the
program's span ``scat.serve.fetch``, the host waiting for the chunks'
answers and copying them out, in the stretch traced with the CPU
activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.serve.fetch")
