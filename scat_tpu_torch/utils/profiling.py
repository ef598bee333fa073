"""Spans and profiler traces (the port's counterpart of
``scat_tpu/utils/profiling.py``).

The reference takes t0..t6 wall-clock checkpoints around data, forward,
loss and backward and never reports them (reference train.py:128-208).
Here the program marks its layer boundaries with ``span(name)``: while
a ``torch.profiler`` records, a span is a ``record_function`` range on
the profiler's own clock, beside the device events of the same trace;
otherwise it is one shared no-op context.  The profiler being on is
the only switch.  ``TraceWindow`` writes a Chrome trace of a window of
training steps (``--profile_trace_dir``), spans included.  The JAX
package's ``enable_compilation_cache`` has no counterpart: PyTorch runs
eagerly, and the hand-written kernels keep their own build cache
(``kernels/build.py``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"

# every span of the program, beside the per-layer metric of the benchmark
# that reads it (portbench/metrics/<metric>.py, through harness/spans.py);
# no span reaches an exported program, so the model spans of a served
# head are read in eager profiles alone
SPANS = (
    "scat.train.forward",    # forward_host_ms.train.flagship
    "scat.train.backward",   # backward_host_ms.train.flagship
    "scat.train.optimizer",  # optimizer_host_ms.train.flagship
    "scat.model.encoder",    # encoder_host_ms.train.flagship
    "scat.model.tokens",     # tokens_host_ms.train.flagship
    "scat.model.mano",       # none: the MANO decode (models/mano.py)
    "scat.serve.upload",     # upload_host_ms.serve.{flagship,vip}
    "scat.serve.launch",     # launch_host_ms.serve.{flagship,vip}
    "scat.serve.fetch",      # fetch_wait_ms.serve.{flagship,vip}
)
_NAMES = frozenset(SPANS)
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else
    one shared no-op context (no allocation, no clock read).  ``name``
    must be one of ``SPANS``."""
    if name not in _NAMES:
        raise ValueError(f"unknown span {name!r}; the spans are {SPANS}")
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _sync(result=None) -> None:
    """Wait for the device work queued so far (a no-op without CUDA or
    when nothing is given to wait for)."""
    if result is not None and torch.cuda.is_available() and \
            torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
