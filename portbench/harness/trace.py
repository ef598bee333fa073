"""The traced stretches: ``torch.profiler`` over a fixed number of
requests or steps, reduced to plain event lists that the per-layer
metric readers and the ``breakdown`` read.

A traced run profiles two stretches of the same length, one after the
other (``Traces``).  The first traces the CUDA activity alone: its
device times, busy time and wall time, and so the idle share, carry no
cost of recording host operations, which on a host-paced step would
otherwise show as idle device time.  The second traces the CPU activity
too: the host's launch calls, and what the host was doing in each idle
gap.

Device events are the profiler's CUDA kernels, copies and sets (user
annotations' device ranges left out); host events are every CPU-side
event (aten ops, CUDA runtime calls).  A stretch with host events is the
host range of the annotation ``STRETCH``; one without is its wall time
on the host clock, from its first device event.  Busy time is the
length of the union of the device intervals inside the stretch."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

STRETCH = "portbench.stretch"
# device kernels grouped by what they do, first match wins (a frozen
# copy of chip_smoke.py's PROFILE_FAMILIES); the rest is elementwise
# arithmetic (adds, products, activations, dropout, the optimizer)
FAMILIES = (
    ("hand-written kernels", ("attention_fwd", "attention_bwd", "favor_",
                              "fused_link")),
    ("float32 GEMM", ("gemm_f32f32",)),
    ("GEMM and convolution", ("gemm", "nvjet", "xmma", "cutlass", "conv")),
    ("normalisation", ("norm",)),
    ("copies and casts", ("copy", "Memcpy", "Cat", "Memset")),
    ("reductions", ("reduce",)),
)
@dataclasses.dataclass
class Event:
    name: str
    start: float   # microseconds, the profiler's clock
    end: float
    depth: int = 0  # host events: nesting depth (0 outermost)

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]   # the stretch, microseconds
    device: List[Event]           # kernels, copies, sets, by start
    host: List[Event]             # CPU-side events, by start
    _top: Optional[List[Event]] = dataclasses.field(default=None,
                                                    repr=False)
    _starts: List[float] = dataclasses.field(default_factory=list,
                                             repr=False)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(e.start, lo), min(e.end, hi)) for e in self.device
                       if e.end > lo and e.start < hi)
        merged: List[List[float]] = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window."""
        out, at = [], self.window[0]
        for s, t in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def device_time(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """(seconds, count) of the device events whose name holds one of
        ``patterns``."""
        hits = [e for e in self.device if any(p in e.name for p in patterns)]
        return sum(e.dur for e in hits) * 1e-6, len(hits)

    def host_count(self, names: Sequence[str]) -> int:
        lo, hi = self.window
        return sum(1 for e in self.host
                   if e.name in names and lo <= e.start <= hi)

    def host_at(self, t: float) -> str:
        """The outermost host operation running at time ``t`` (the
        stretch's own annotation left out), or "python" where none is
        (the host between operations)."""
        if self._top is None:
            self._top = sorted((e for e in self.host
                                if e.depth == 0 and e.name != STRETCH),
                               key=lambda e: e.start)
            self._starts = [e.start for e in self._top]
        i = bisect.bisect_right(self._starts, t) - 1
        for e in self._top[max(i - 64, 0):i + 1][::-1]:
            if e.end >= t:
                return e.name
        return "python"


def family(name: str) -> str:
    return next((f for f, keys in FAMILIES if any(k in name for k in keys)),
                "elementwise and other")


def short(name: str, width: int = 96) -> str:
    for cut in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(cut, "")
    return name[:width]


def breakdown(trace: Trace, gaps_of: Optional[Trace] = None,
              top: int = 10) -> dict:
    """The device operations of ``trace`` that took most time ([family |
    name, seconds]) and the idle time of ``gaps_of`` (``trace`` itself if
    None) by what the host was doing when the device went idle ([host
    operation, seconds], summed over gaps)."""
    by_name: dict = {}
    for e in trace.device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps_of = gaps_of or trace
    idle: dict = {}
    for s, t in gaps_of.gaps():
        what = gaps_of.host_at(0.5 * (s + t))
        idle[what] = idle.get(what, 0.0) + (t - s) * 1e-6
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[f"{family(n)} | {short(n)}", s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def families(trace: Trace) -> List[Tuple[str, float]]:
    """Device seconds by family, largest first."""
    out: dict = {}
    for e in trace.device:
        f = family(e.name)
        out[f] = out.get(f, 0.0) + e.dur * 1e-6
    return sorted(out.items(), key=lambda kv: -kv[1])


@dataclasses.dataclass
class Traces:
    """A traced run's two stretches (see the module doc)."""
    cuda_only: Trace   # device times, busy and idle
    with_host: Trace   # launch calls, the idle gaps' host operations


def profile(fn: Callable[[], None], with_host: bool,
            device: str = "cuda") -> Trace:
    """Run ``fn`` (which ends in a synchronize) under ``torch.profiler``,
    inside the annotation ``STRETCH``, and reduce the result: with the
    CUDA activity alone, or with ``with_host`` the CPU activity too (off
    the card, the CPU activity alone)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    acts = [ProfilerActivity.CUDA] if device == "cuda" else []
    if with_host or not acts:
        acts.append(ProfilerActivity.CPU)
    if device == "cuda":
        torch.cuda.synchronize()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(STRETCH):
            fn()
        wall = time.perf_counter() - t0
    return reduce_events(prof.events(), wall)


def reduce_events(events, wall_s: float) -> Trace:
    """``Trace`` of a profiler's ``events()``; ``wall_s``, the stretch's
    wall time on the host clock, gives the window where the trace holds
    no host range of ``STRETCH`` (the CUDA activity traced alone)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device, host = [], []
    for e in events:
        rng = e.time_range
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False) and rng.end > rng.start:
                device.append(Event(e.name, rng.start, rng.end))
            continue
        # nesting below any enclosing operation but the stretch's own
        # annotation (a thread's outermost operations have depth 0)
        depth, parent = 0, e.cpu_parent
        while parent is not None:
            depth += parent.name != STRETCH
            parent = parent.cpu_parent
        if e.name == STRETCH and window is None:
            window = (rng.start, rng.end)
        host.append(Event(e.name, rng.start, rng.end, depth))
    device.sort(key=lambda e: e.start)
    if window is None:
        # the host ends the stretch after its last device event (a
        # synchronize), and starts it before its first
        start = device[0].start if device else 0.0
        window = (start, start + 1e6 * wall_s)
    host.sort(key=lambda e: e.start)
    return Trace(window, device, host)
