"""One run of one cell: the driver's set-up, window, traced stretch and
comparison, then the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; the numbers compared, each beside
its limit, come last under ``check``, and again as the last lines of
standard error."""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Dict, List, Optional

from harness import bench as bench_lib
from harness import env


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, and the
    device; ``fault`` plants one of the faults a test checks the
    comparison against (never set by the command line)."""
    cell: bench_lib.Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    fault: Optional[str] = None
    log: object = sys.stderr

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def say(self, *parts) -> None:
        print(f"[{self.cell.name}]", *parts, file=self.log, flush=True)

    def limits(self) -> Dict[str, float]:
        return self.config["limits"][self.traffic["driver"]]


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""
    attempted: int
    failed: int
    setup_s: float
    end_to_end: Dict[str, float]      # by metric name
    work: dict                        # what the metric readers read
    numbers: Dict[str, float]         # the compared numbers, by name
    memory_peak_bytes: int
    trace: object = None              # harness.trace.Traces, traced runs


def device_info(device: str) -> dict:
    import torch
    if device != "cuda":
        return {"platform": device, "kind": device, "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def require_devices(count: int) -> None:
    """Raise unless CUDA is there with ``count`` devices or more."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the port "
                           "on the card and has no CPU fallback")
    if torch.cuda.device_count() < count:
        raise RuntimeError(f"the cell asks for {count} devices, CUDA has "
                           f"{torch.cuda.device_count()}")


def run_cell(cell: bench_lib.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: Optional[str] = None,
             log=sys.stderr) -> dict:
    """Run ``cell`` and return its result line as a dict."""
    ctx = Context(cell, seed, seconds, trace, device, fault, log)
    outcome: Outcome = cell.driver().run(ctx)
    found = env.forbidden_modules()
    if found:
        raise RuntimeError(f"the process holds {found} after the window: "
                           "the benchmark's process must not load JAX or "
                           "the JAX package")
    limits = ctx.limits()
    values = {k: outcome.numbers.get(k, math.inf) for k in limits}
    correct = outcome.failed == 0 and all(
        values[k] <= limits[k] for k in limits)
    # a number that is not finite (a missing or broken answer) is null
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": limits[k]} for k, v in values.items()}
    metrics: Dict[str, dict] = {}
    if trace:
        readers = cell.metric_readers()
        for m in cell.per_layer:
            value = readers[m["name"]].read(outcome.trace, outcome.work,
                                            cell.config, cell.traffic)
            if value is None:
                ctx.say(f"per-layer metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        # an end-to-end metric <quantity>.<group> reports the driver's
        # <quantity> for a group of cells with a bound of its own
        e2e = dict(outcome.end_to_end, setup_s=outcome.setup_s)
        for m in cell.end_to_end:
            value = e2e[m["name"].split(".")[0]]
            if value is None:   # a device time, off the card
                ctx.say(f"end-to-end metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(device_info(device),
               memory_peak_bytes=int(outcome.memory_peak_bytes))
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": dev}
    if trace:
        from harness import trace as trace_lib
        t = outcome.trace.cuda_only
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        line["breakdown"] = trace_lib.breakdown(t, outcome.trace.with_host)
        for name, s in trace_lib.families(t):
            ctx.say(f"device time by family: {name} {s:.6f} s "
                    f"({100 * s / max(t.busy_s, 1e-12):.2f}% of busy)")
    line["check"] = checks
    return line


def emit(line: dict, log=sys.stderr) -> None:
    """The check's lines last on standard error, the result line last on
    standard output."""
    for name, c in line["check"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        verdict = "ok" if ok else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=log, flush=True)
    print(json.dumps(line), flush=True)


def cpu_ticks() -> dict:
    """The machine's CPU time by kind (``/proc/stat``, clock ticks), or
    {} where it cannot be read: ``steal`` is time the hypervisor gave
    the machine's virtual CPUs to others."""
    kinds = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
             "steal")
    try:
        with open("/proc/stat") as f:
            return dict(zip(kinds, map(int, f.readline().split()[1:9])))
    except (OSError, ValueError):
        return {}


def host_report(before, after, ticks: dict, wall: float, ends: List[float],
                t0: float) -> str:
    """What the host did in a window: this process's CPU seconds and
    context switches (``resource.getrusage`` before and after), the
    share of the machine's CPU time stolen by the hypervisor (``ticks``,
    ``cpu_ticks()`` at the window's start), and the calls completed in
    each fifth of the window (from their return times ``ends``), so that
    a slow run shows whether it was slow throughout or in bursts."""
    fifths = [0] * 5
    for t in ends:
        fifths[min(int(5 * (t - t0) / wall), 4)] += 1
    now = cpu_ticks()
    spent = {k: now[k] - ticks[k] for k in now if k in ticks}
    steal = (f"{100 * spent['steal'] / max(sum(spent.values()), 1):.2f}%"
             if spent else "unknown")
    return (f"host: {after.ru_utime - before.ru_utime:.2f} s user and "
            f"{after.ru_stime - before.ru_stime:.2f} s system CPU in "
            f"{wall:.2f} s; {after.ru_nvcsw - before.ru_nvcsw} voluntary "
            f"and {after.ru_nivcsw - before.ru_nivcsw} involuntary context "
            f"switches; machine CPU time stolen {steal}; calls a fifth of "
            f"the window {fifths}")


def idle_report(traces, work: dict) -> str:
    """The idle share of each traced stretch by its own wall time, and
    the one ``idle_pct`` reads: the traced busy time a crop over the
    window's unprofiled wall time a crop."""
    from harness import readings

    def pct(x):
        return "none" if x is None else f"{x:.2f}%"

    def own(t):
        return 100 * (1 - t.busy_s / t.window_s) if t.window_s > 0 else None
    a, b = traces.cuda_only, traces.with_host
    return (f"idle: {pct(own(a))} of the stretch traced with the CUDA "
            f"activity alone, {pct(own(b))} of the one traced with the "
            f"host's too; traced busy "
            f"{1e6 * a.busy_s / max(work['trace_crops'], 1):.3f} us a crop "
            f"over the window's unprofiled "
            f"{1e6 * work['window_s'] / max(work['window_crops'], 1):.3f} us:"
            f" {pct(readings.idle_pct(traces, work))}")


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))
