"""The program's own spans (``scat_tpu_torch.utils.profiling.SPANS``),
read from the host events of the stretch traced with the CPU activity
(``harness.trace.Traces.with_host``): a span is a ``record_function``
range on the profiler's clock, so its host time sits beside the device
events of the same trace.  A program without the span (a renamed span,
or a commit before the spans) reads None, not 0."""

from __future__ import annotations


def host_ms(traces, work: dict, name: str) -> "float | None":
    """Host milliseconds inside the span ``name`` (children included)
    a step or a request of the stretch: the sum of the durations of its
    events that start inside the stretch, over the stretch's steps
    (``work["trace_steps"]``) or requests (``work["trace_sizes"]``)."""
    count = work.get("trace_steps") or len(work.get("trace_sizes") or ())
    if traces is None or not count:
        return None
    trace = traces.with_host
    lo, hi = trace.window
    spent = [e.dur for e in trace.host
             if e.name == name and lo <= e.start <= hi]
    if not spent:
        return None
    return 1e-3 * sum(spent) / count
