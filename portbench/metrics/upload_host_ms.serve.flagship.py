"""Serving front end, flagship-serve: host milliseconds a request inside
the program's span ``scat.serve.upload``, the chunks' host-to-device
copies from pageable memory, which the host waits for, in the stretch
traced with the CPU activity."""

from harness import spans


def read(trace, work, config, traffic):
    return spans.host_ms(trace, work, "scat.serve.upload")
