"""Batch prefetching (port of ``scat_tpu/data/prefetch.py``): the host's
data work overlaps the device's steps.

The reference overlaps with DataLoader worker processes (num_workers=10,
reference MultiDataset.py:47).  Here one thread runs the loader: while
the card trains on batch i, the thread decodes batch i+1..i+depth and
stages it on the card.  On a CUDA device the thread works on a CUDA
stream of its own, so the loader's uploads (from pinned host memory,
``non_blocking``) and its device work (the warp, the blur) overlap the
step on the consumer's stream; each batch carries an event recorded
after its last operation, the consumer's stream waits on it, and every
tensor is marked as used by the consumer's stream (``record_stream``),
so that the caching allocator does not hand its memory out again before
the step that reads it has run.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device``; host memory is pinned first
    for a CUDA device, so the copy is asynchronous on the current
    stream."""
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def map_batch(batch, fn: Callable):
    """``fn`` applied to every tensor of a batch dict or a tuple of them
    (``ConcatDataset``'s)."""
    if isinstance(batch, tuple):
        return tuple(map_batch(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: map_batch(v, fn) for k, v in batch.items()}
    return fn(batch)


class PrefetchIterator:
    """An iterable of batches behind a depth-``depth`` background thread
    that stages each batch on ``device`` (None: batches pass as they
    are)."""

    def __init__(self, iterable: Iterable, depth: int = 2,
                 device: Optional[torch.device] = None,
                 shard: Optional[Callable] = None):
        self._iterable = iterable
        self._depth = max(depth, 1)
        self._device = None if device is None else torch.device(device)
        self._shard = shard

    def __len__(self) -> int:
        return len(self._iterable)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err: list = []
        stop = threading.Event()
        device = self._device
        cuda = device is not None and device.type == "cuda"
        stream = torch.cuda.Stream(device) if cuda else None

        def put(item) -> bool:
            # poll the stop flag: a consumer that leaves early (break, an
            # exception) would otherwise leave this thread blocked in
            # q.put, holding the loader and `depth` staged batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # the loader's own device work runs on the side stream too (a
            # thread's current stream is its own)
            with (torch.cuda.stream(stream) if cuda
                  else contextlib.nullcontext()):
                try:
                    for batch in self._iterable:
                        event = None
                        if device is not None:
                            batch = map_batch(
                                batch, lambda t: to_device(t, device))
                        if self._shard is not None:
                            batch = self._shard(batch)
                        if cuda:
                            event = torch.cuda.Event()
                            event.record(stream)
                        if not put((batch, event)):
                            return
                except BaseException as e:  # raised in the consumer
                    err.append(e)
                finally:
                    # the sentinel must land (a put_nowait would drop it
                    # when the queue is full and the consumer would wait
                    # in q.get forever): the same stop-aware put
                    put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                batch, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(event)
                    map_batch(batch, lambda x: x.record_stream(consumer)
                              if x.is_cuda else None)
                yield batch
        finally:
            # on generator close or collection too (an early exit)
            stop.set()


def prefetch_to_device(iterable: Iterable, device=None, depth: int = 2,
                       shard: Optional[Callable] = None
                       ) -> PrefetchIterator:
    """Prefetch ``iterable`` and stage its batches on ``device`` in the
    background thread, so the consumer only ever sees batches there;
    ``shard`` (this rank's rows of a global batch under a mesh,
    ``parallel/mesh.shard_batch``; JAX ``prefetch.py:84-97``) runs in
    the thread too."""
    return PrefetchIterator(iterable, depth=depth, device=device,
                            shard=shard)
