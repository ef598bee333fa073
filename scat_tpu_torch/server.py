"""Minimal HTTP front end for the serving engine (the port's own copy of
``scat_tpu/server.py``).

Wraps any predictor with a ``predict(images) -> dict`` contract and an
``image_size`` attribute, by default ``serving.HandPosePredictor`` on the
CUDA device, or with ``--serve_artifact DIR`` an
``export.ExportedPredictor`` (one CUDA graph per bucket and request
dtype), in a stdlib-only threaded HTTP server.

Endpoints:
  GET  /healthz   liveness + model metadata
  POST /predict   body = raw crop bytes, headers:
                    X-Shape: N,H,W,3         (comma-separated ints)
                    X-Dtype: uint8 | float32 (uint8 [0,255] or
                                              float32 [-1,1])
                  response: JSON {camera, joints_3d, joints_2d} lists

By default requests serialize through a lock: the predictor already
pipelines chunks internally (``serving.run_bucketed``).  With
``--batch_window_ms W`` concurrent requests arriving within W ms
coalesce into one device batch (``MicroBatcher``).

CLI:
  python -m scat_tpu_torch.server --server_port 8080 \
      --net reg_transformer --iteration 3 --vit_heads 8 \
      --checkpoint_path_eval .../hand_net_final.pth
  (``--checkpoint_path_eval ''`` serves a seeded fresh init.)
  python -m scat_tpu_torch.server --server_port 8080 --serve_artifact out/
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_ALLOWED_DTYPES = ("uint8", "float32")


class MicroBatcher:
    """Coalesce concurrent requests into one device batch.

    Classic serving-throughput lever: N clients posting small requests
    within ``window_s`` of each other ride ONE forward pass instead of
    N serialized ones (the predictor's bucket padding then amortizes
    over real samples instead of zeros).  A dispatcher thread owns the
    device — callers block on an event until their slice is scattered
    back.  Requests are grouped by dtype (uint8 and float crops cannot
    share one batch); oversized coalesced batches are fine because
    ``predict`` already chunks internally (serving.run_bucketed)."""

    def __init__(self, predictor, window_s: float = 0.002):
        self._pred = predictor
        self._window = window_s
        self._cv = threading.Condition()
        self._queue: list = []   # (images, slot, event)
        self._stopped = False
        self.batches_run = 0     # observability / tests
        self.requests_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def image_size(self):
        return self._pred.image_size

    def stop(self) -> None:
        """End the dispatcher thread (queued requests get errors).

        Without this every ``make_server(batch_window_ms>0)`` would leak
        an immortal thread pinning the predictor's device buffers;
        ``server_close()`` calls it."""
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # e.g. mid-predict on a long batch; the guard must not
            # claim success silently
            print("WARNING: MicroBatcher dispatcher still running "
                  "after 5s (mid-predict?); it will exit after the "
                  "current batch")

    def predict(self, images):
        slot, done = {}, threading.Event()
        with self._cv:
            if self._stopped:
                raise RuntimeError("MicroBatcher is stopped")
            self._queue.append((np.asarray(images), slot, done))
            self._cv.notify()
        done.wait()
        if "error" in slot:
            # a fresh exception per waiting thread: re-raising the one
            # shared instance from N threads races on its __traceback__
            raise RuntimeError(
                f"micro-batched predict failed: {slot['error']}"
            ) from slot["error"]
        return slot["out"]

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    for _, slot, done in self._queue:
                        slot["error"] = RuntimeError(
                            "MicroBatcher stopped")
                        done.set()
                    self._queue = []
                    return
            time.sleep(self._window)  # let the burst accumulate
            with self._cv:
                batch, self._queue = self._queue, []
            by_dtype: dict = {}
            for item in batch:
                by_dtype.setdefault(str(item[0].dtype), []).append(item)
            for items in by_dtype.values():
                try:
                    out = self._pred.predict(
                        np.concatenate([x for x, _, _ in items]))
                    self.batches_run += 1
                    start = 0
                    for x, slot, done in items:
                        n = x.shape[0]
                        slot["out"] = {k: v[start:start + n]
                                       for k, v in out.items()}
                        start += n
                        self.requests_served += 1
                        done.set()
                except Exception as e:  # deliver, don't kill the loop
                    for _, slot, done in items:
                        slot["error"] = e
                        done.set()


class _Handler(BaseHTTPRequestHandler):
    # set by make_server:
    predictor = None
    # a threading.Lock, or a nullcontext when the MicroBatcher's
    # dispatcher owns the device — only used as a context manager
    lock = None
    model_info: dict = None
    max_request_batch: int = 256

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path != "/healthz":
            return self._send(404, {"error": f"no route {self.path}"})
        self._send(200, {"status": "ok", **self.model_info})

    def do_POST(self):
        if self.path != "/predict":
            return self._send(404, {"error": f"no route {self.path}"})
        try:
            shape = tuple(int(s) for s in
                          self.headers.get("X-Shape", "").split(","))
            dtype = self.headers.get("X-Dtype", "uint8")
            if dtype not in _ALLOWED_DTYPES:
                raise ValueError(f"X-Dtype must be one of "
                                 f"{_ALLOWED_DTYPES}, got {dtype!r}")
            size = self.model_info["image_size"]
            if len(shape) != 4 or shape[1:] != (size, size, 3) \
                    or shape[0] < 1:
                raise ValueError(
                    f"X-Shape must be N,{size},{size},3 with N>=1, "
                    f"got {shape}")
            if shape[0] > self.max_request_batch:
                # bound host memory per request: the predictor chunks
                # device work internally, but the body is buffered in
                # full here (a declared N of 10^6 would read ~150 GB)
                self.close_connection = True  # body was never read
                return self._send(413, {
                    "error": f"batch {shape[0]} exceeds the server "
                             f"limit {self.max_request_batch}; split "
                             "the request"})
            n_bytes = int(self.headers.get("Content-Length", 0))
            expected = int(np.prod(shape)) * np.dtype(dtype).itemsize
            if n_bytes != expected:
                raise ValueError(
                    f"body is {n_bytes} bytes, X-Shape/X-Dtype imply "
                    f"{expected}")
            images = np.frombuffer(self.rfile.read(n_bytes),
                                   dtype).reshape(shape)
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        try:
            with self.lock:
                out = self.predictor.predict(images)
        except Exception as e:  # a transient device error must answer
            # every coalesced client with a 500, not a connection reset
            return self._send(
                500, {"error": f"{type(e).__name__}: {e}"})
        self._send(200, {k: np.asarray(v).tolist()
                         for k, v in out.items()})


def make_server(predictor, host: str = "127.0.0.1", port: int = 8080,
                model_info: dict = None, batch_window_ms: float = 0.0,
                max_request_batch: int = 256) -> ThreadingHTTPServer:
    """Build (not start) the server; caller runs ``serve_forever()``.

    ``predictor``: anything with ``predict(images) -> dict`` and an
    ``image_size`` attribute.  ``batch_window_ms`` > 0 turns on
    micro-batching: concurrent requests arriving within the window
    coalesce into one device batch (see :class:`MicroBatcher`).
    ``max_request_batch`` caps the declared N of one request (the body
    is buffered whole on the host); larger requests get HTTP 413."""
    batcher = None
    if batch_window_ms > 0:
        predictor = batcher = MicroBatcher(predictor,
                                           batch_window_ms / 1e3)
        # the batcher's dispatcher owns the device; no handler lock
        lock = contextlib.nullcontext()
    else:
        lock = threading.Lock()
    handler = type("Handler", (_Handler,), {
        "predictor": predictor,
        "lock": lock,
        "model_info": {"image_size": predictor.image_size,
                       **(model_info or {})},
        "max_request_batch": int(max_request_batch),
    })
    httpd = _ScatHTTPServer((host, port), handler)
    httpd.batcher = batcher
    return httpd


class _ScatHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose ``server_close`` also ends the
    micro-batcher's dispatcher thread (otherwise each batched server
    leaks an immortal thread pinning the predictor)."""
    batcher: MicroBatcher = None

    def server_close(self):
        super().server_close()
        if self.batcher is not None:
            self.batcher.stop()


def main(argv=None) -> None:
    import argparse
    import sys

    from scat_tpu_torch.config import BaseOptions

    # server-only flags peel off first; the rest is the standard surface
    peel = argparse.ArgumentParser(add_help=False)
    peel.add_argument("--server_port", type=int, default=8080)
    peel.add_argument("--server_host", default="0.0.0.0")
    peel.add_argument("--serve_artifact", default="",
                      help="serve an export dir (scat_tpu_torch.export) "
                           "instead of a live checkpoint")
    peel.add_argument("--batch_window_ms", type=float, default=0.0,
                      help="coalesce concurrent requests arriving "
                           "within this window into one device batch")
    peel.add_argument("--max_request_batch", type=int, default=256,
                      help="largest per-request batch N accepted; "
                           "bigger requests get HTTP 413")
    server_opt, rest = peel.parse_known_args(
        sys.argv[1:] if argv is None else argv)

    if server_opt.serve_artifact:
        from scat_tpu_torch.export import load_artifact
        predictor = load_artifact(server_opt.serve_artifact, device="cuda")
        info = {"source": f"artifact:{server_opt.serve_artifact}",
                "net": predictor.manifest["net"]}
    else:
        opt = BaseOptions().parse(rest)
        from scat_tpu_torch.serving import HandPosePredictor
        predictor = HandPosePredictor.from_checkpoint(opt, device="cuda")
        info = {"source": f"checkpoint:{opt.checkpoint_path_eval}",
                "net": opt.net}

    httpd = make_server(predictor, server_opt.server_host,
                        server_opt.server_port, info,
                        batch_window_ms=server_opt.batch_window_ms,
                        max_request_batch=server_opt.max_request_batch)
    # run every bucket once before accepting traffic (an artifact
    # captures its CUDA graphs here)
    predictor.warmup()
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} "
          f"(POST /predict, GET /healthz)")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
