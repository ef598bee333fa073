"""Step timing and profiler traces (the port's own copy of
``scat_tpu/utils/profiling.py``).

The reference takes t0..t6 wall-clock checkpoints around data, forward,
loss and backward and never reports them (reference train.py:128-208).
Here: ``StepTimer`` (device-synchronised step timing and samples/s),
``TraceWindow`` (a ``torch.profiler`` Chrome trace of a window of
training steps, ``--profile_trace_dir``), ``profiler_trace`` (the same
around any block) and ``benchmark_fn``.  The JAX package's
``enable_compilation_cache`` has no counterpart: PyTorch runs eagerly,
and the hand-written kernels keep their own build cache
(``kernels/build.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch

TRACE_FILE = "trace.json"


def _sync(result=None) -> None:
    """Wait for the device work queued so far (a no-op without CUDA or
    when nothing is given to wait for)."""
    if result is not None and torch.cuda.is_available() and \
            torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Rolling samples/s and ms/step with the device synchronised before
    the clock stops."""

    def __init__(self, batch_size: int, warmup: int = 1):
        self.batch_size = batch_size
        self.warmup = warmup
        self.reset()

    def reset(self) -> None:
        self._steps = 0
        self._t0 = None
        self._elapsed = 0.0

    def tick(self, result=None) -> None:
        """Call once per step; given the step's output, the device is
        synchronised first so that queued work is not left out."""
        _sync(result)
        now = time.perf_counter()
        if self._steps >= self.warmup and self._t0 is not None:
            self._elapsed += now - self._t0
        self._t0 = now
        self._steps += 1

    @property
    def counted_steps(self) -> int:
        return max(self._steps - self.warmup, 0)

    @property
    def ms_per_step(self) -> float:
        n = self.counted_steps
        return self._elapsed / n * 1000 if n else float("nan")

    @property
    def samples_per_sec(self) -> float:
        n = self.counted_steps
        return (self.batch_size * n / self._elapsed
                if n and self._elapsed else float("nan"))

    def samples_per_sec_per_chip(self) -> float:
        return self.samples_per_sec / max(torch.cuda.device_count(), 1)


def _profile(log_dir: str) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    return torch.profiler.profile(activities=activities)


class TraceWindow:
    """A ``torch.profiler`` trace of ``n_steps`` steps of a training loop
    (``--profile_trace_dir``), written as a Chrome trace
    ``{log_dir}/trace.json`` (chrome://tracing, Perfetto).  The loop
    calls ``step(k)`` after its k-th step: the window opens at
    ``step(start_step)`` and closes at ``step(start_step + n_steps)``,
    so the steps in between are traced.  It opens after the first steps,
    so the trace shows steady-state device time, not kernel builds; the
    device is synchronised at the window's edges only."""

    def __init__(self, log_dir: Optional[str], n_steps: int = 20,
                 start_step: int = 3):
        self._dir = log_dir or None
        self._start = start_step
        self._end = start_step + max(n_steps, 1)
        self._prof = None
        self._captured = False
        self._done = self._dir is None

    @property
    def path(self) -> Optional[str]:
        return None if self._dir is None else os.path.join(self._dir,
                                                           TRACE_FILE)

    def step(self, step: int, sync=None) -> None:
        """Call once per loop iteration with an increasing step counter
        (the trainer passes its 1-based global step, so the default
        window opens at the 3rd step)."""
        if self._done:
            return
        if self._prof is None and step >= self._start:
            _sync(sync)
            self._prof = _profile(self._dir)
            self._prof.__enter__()
            self._captured = True
        elif self._prof is not None and step >= self._end:
            self.stop(sync)

    def stop(self, sync=None) -> None:
        """Close the window and write the trace; idempotent, and safe
        where the loop ended inside the window."""
        if self._prof is not None:
            _sync(sync)
            self._prof.__exit__(None, None, None)
            self._prof.export_chrome_trace(self.path)
            self._prof = None
        if self._dir is not None and not self._captured and not self._done:
            # a short run can end before the window opens; an empty
            # trace dir with no explanation is a debugging trap
            print(f"WARNING: the run ended before step {self._start}; "
                  f"no profiler trace was captured in {self._dir}")
        self._done = True


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, written to
    ``{log_dir}/trace.json``; nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    prof = _profile(log_dir)
    with prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def benchmark_fn(fn: Callable, *args, iters: int = 20, warmup: int = 1,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
    """Time ``fn(*args)`` after ``warmup`` calls, the device synchronised
    around the timed calls; ms/step, and samples/s given the batch
    size."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    dt = time.perf_counter() - t0
    res = {"ms_per_step": dt / iters * 1000}
    if batch_size is not None:
        res["samples_per_sec"] = batch_size * iters / dt
        res["samples_per_sec_per_chip"] = (
            res["samples_per_sec"] / max(torch.cuda.device_count(), 1))
    return res
