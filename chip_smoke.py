#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (scat_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure raises and exits non-zero:
  1. build    compile every kernel source under scat_tpu_torch/csrc
              (one nvcc each, in parallel) and print the card's name and
              power limit;
  2. kernels  each kernel against its plain PyTorch version on the card
              at the serving path's shapes: float32 (TF32 off) at atol
              2e-5, bfloat16 at atol = rtol = 1e-2 against the plain
              version run in float32 on the same bf16 inputs; then timed
              beside the plain version and the library call;
  3. slice    the flagship --net reg_transformer predictor at full width
              (resnet50, 224x224 crops, 784-dim tokens, 8 heads,
              iteration 3, bfloat16, weights from seed 0) serves uint8
              requests of 1, 7, 64 and 150 crops and one float32 request;
              outputs are checked, the attention kernel must run 3 times
              per forward chunk, and the predictor must agree with the
              same predictor on the plain attention path; then the
              end-to-end rate (all crops of a window of back-to-back
              640-crop requests over its wall time) and, per bucket, the
              p50 chunk and request latencies are printed;
  4. serve    the HTTP front end answers POST /predict (also with
              micro-batching on) with exactly what predict returns, and
              GET /healthz;
  5. the card line, the kernels line, and the final
     {"ok": true, "device": ...} line.

TF32 is off for the whole run (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32), so float32 comparisons are float32.
"""

import dataclasses
import http.client
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from scat_tpu_torch.config import Options
from scat_tpu_torch.kernels import build
from scat_tpu_torch.ops.attention import attention_reference, flash_attention
from scat_tpu_torch.server import make_server
from scat_tpu_torch.serving import HandPosePredictor

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLAGSHIP = Options(net="reg_transformer", vit_heads=8, vit_depth=3,
                   iteration=3, compute_dtype="bfloat16",
                   use_pallas_attention=True, checkpoint_path_eval="",
                   seed=0)
IMAGE = 224
HEADS, TOKENS, HEAD_DIM = 8, 21, 64
SCALE = HEAD_DIM ** -0.5
REQUESTS = (1, 7, 64, 150)
WINDOW_REQUESTS, WINDOW_CROPS = 6, 640
# Bounds between two runs of the whole predictor that differ only in
# rounding: the kernel vs the plain attention path, and a float32 request
# vs the uint8 request of the same crops (the device normalizes uint8 by
# multiplying with 1/127.5, the host divides, so inputs differ by an ulp).
# In bf16 such a difference can flip an input's or an activation's bf16
# rounding (2^-9 relative); outputs must agree to 2% of their largest
# magnitude.  In float32 they must agree to 1e-3, the repo's model
# parity bar.
BF16_REL = 2e-2
F32_ATOL = 1e-3


@dataclasses.dataclass
class Kernel:
    name: str
    route: str
    source: str
    replaces: str
    wrapper: object
    result: dict = dataclasses.field(default_factory=dict)


KERNELS = [
    Kernel("attention_fwd", "cuda", "scat_tpu_torch/csrc/attention_fwd.cu",
           "scat_tpu/ops/pallas_attention.py:49", flash_attention),
]


def reset_counts():
    for k in KERNELS:
        k.wrapper.launches = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def device_ms(fn, iters=200) -> float:
    """Device time per call of ``fn`` in ms: ``iters`` calls captured in
    one CUDA graph, replayed, timed by CUDA events (no host launch cost
    between the calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def qkv_views(b, h, n, d, dtype, seed):
    """q, k, v as the transformer passes them: strided [B,H,N,D] views
    of one [B,N,3,H,D] projection output."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g).to("cuda", dtype)
    return qkv.permute(2, 0, 3, 1, 4)


def phase_build():
    t0 = time.perf_counter()
    compiled = build.build_all()
    for name in build.SOURCES:
        print(f"[build] {name}: {build.library_path(name)}")
    print(f"[build] {compiled} source(s) compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"[build] card: {card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")


def phase_kernels():
    buckets = [1, 2, 4, 7, 8, 16, 32, 64]
    shapes = [(b, HEADS, TOKENS, HEAD_DIM) for b in buckets]
    shapes += [(2, 4, 128, HEAD_DIM), (3, 2, TOKENS, HEAD_DIM)]
    kern = KERNELS[0]
    for i, shape in enumerate(shapes):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
            q, k, v = qkv_views(*shape, dtype, seed=i)
            with torch.no_grad():
                got = flash_attention(q, k, v, SCALE)
            torch.cuda.synchronize()
            want = attention_reference(q.float(), k.float(), v.float(),
                                       SCALE)
            err = (got.float() - want).abs().max().item()
            torch.testing.assert_close(
                got.float(), want, atol=tol,
                rtol=tol if dtype == torch.bfloat16 else 0)
            print(f"[kernels] attention_fwd {list(shape)} "
                  f"{str(dtype)[6:]}: max_abs_err {err:.3e} (tol {tol})")
            if shape == (64, HEADS, TOKENS, HEAD_DIM) \
                    and dtype == torch.bfloat16:
                kern.result["max_abs_err"] = err
    print("[kernels] device times in ms, bf16, q/k/v strided views as in "
          "the model; 200 calls in one CUDA graph, timed by CUDA events:")
    for b in (1, 7, 64):
        q, k, v = qkv_views(b, HEADS, TOKENS, HEAD_DIM, torch.bfloat16,
                            seed=100 + b)
        calls = {
            "kernel": lambda: flash_attention(q, k, v, SCALE),
            "plain": lambda: attention_reference(q, k, v, SCALE),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q, k, v, scale=SCALE)}
        with torch.no_grad():
            dev = {name: device_ms(fn) for name, fn in calls.items()}
        n_bytes = 4 * b * HEADS * TOKENS * HEAD_DIM * 2
        flops = 4 * b * HEADS * TOKENS * TOKENS * HEAD_DIM
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[kernels] b={b:2d} [{b},8,21,64]: kernel "
              f"{dev['kernel']:.5f} plain {dev['plain']:.5f} sdpa "
              f"{dev['sdpa']:.5f} | bound {bound:.6f} ({bound_by}: "
              f"{n_bytes} B, {flops} flop)")
        if b == 64:
            kern.result.update(
                ms=dev["kernel"], plain_ms=dev["plain"],
                library_ms=dev["sdpa"], bound_ms=bound, bound_by=bound_by)


def n_chunks(n: int, big: int) -> int:
    return -(-n // big)


def check_output(out, n):
    assert out["camera"].shape == (n, 3), out["camera"].shape
    assert out["joints_3d"].shape == (n, 21, 3), out["joints_3d"].shape
    assert out["joints_2d"].shape == (n, 21, 2), out["joints_2d"].shape
    for k, v in out.items():
        assert v.dtype == np.float32 and np.isfinite(v).all(), k
    assert np.all(out["joints_3d"][:, 1] == 0), "joint 1 is the root"


def phase_slice(rng):
    t0 = time.perf_counter()
    pred = HandPosePredictor.from_checkpoint(FLAGSHIP, image_size=IMAGE)
    model = pred.model
    assert model.main_encoder.fc1.in_features == 2048      # resnet50
    assert model.transformer.layers[0][0].fn.norm.normalized_shape \
        == ((IMAGE // 8) ** 2,)
    assert len(model.transformer.layers) == 3
    assert next(model.transformer.parameters()).dtype == torch.bfloat16
    print(f"[slice] predictor built in {time.perf_counter() - t0:.1f} s "
          f"(resnet50, 224, 784-dim tokens, 8 heads, iteration 3, bf16); "
          f"buckets {pred._buckets}")
    t0 = time.perf_counter()
    pred.warmup()
    print(f"[slice] warmup of every bucket, uint8 and float32: "
          f"{time.perf_counter() - t0:.1f} s")

    crops = {n: rng.randint(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)
             for n in REQUESTS}
    as_float = crops[7].astype(np.float32) / 127.5 - 1.0
    big = pred._buckets[-1]
    reset_counts()
    outs = {n: pred.predict(crops[n]) for n in REQUESTS}
    out_f = pred.predict(as_float)
    launches = flash_attention.launches
    chunks = sum(n_chunks(n, big) for n in REQUESTS) + n_chunks(7, big)
    KERNELS[0].result["launches"] = launches
    print(f"[slice] requests {list(REQUESTS)} uint8 + 7 float32: "
          f"{chunks} forward chunks, attention_fwd launches {launches}")
    assert launches == 3 * chunks, (launches, chunks)
    for n, out in outs.items():
        check_output(out, n)
    check_output(out_f, 7)
    j = outs[64]["joints_3d"]
    print(f"[slice] outputs finite, root-centred; |joints_3d| max "
          f"{np.abs(j).max():.4f}, camera[0] {outs[64]['camera'][0]}")

    # (what, got, want, bound or None for BF16_REL * max|want|)
    pairs = [(f"bf16 float32 vs uint8 request, 7 crops, {k}", out_f[k],
              outs[7][k], None) for k in out_f]
    # the same weights (same seed) on the plain attention path
    plain = HandPosePredictor.from_checkpoint(
        dataclasses.replace(FLAGSHIP, use_pallas_attention=False),
        image_size=IMAGE)
    before = flash_attention.launches
    out_plain = plain.predict(crops[64])
    assert flash_attention.launches == before, "plain path launched"
    del plain
    pairs += [(f"bf16 kernel vs plain attention, 64 crops, {k}", outs[64][k],
               out_plain[k], None) for k in out_plain]
    f32 = dataclasses.replace(FLAGSHIP, compute_dtype="float32")
    p32 = HandPosePredictor.from_checkpoint(f32, image_size=IMAGE)
    o32 = p32.predict(crops[7])
    o32_float = p32.predict(as_float)
    del p32
    o32_plain = HandPosePredictor.from_checkpoint(
        dataclasses.replace(f32, use_pallas_attention=False),
        image_size=IMAGE).predict(crops[7])
    pairs += [("float32 kernel vs plain attention, 7 crops, joints_3d",
               o32["joints_3d"], o32_plain["joints_3d"], F32_ATOL),
              ("float32 float32 vs uint8 request, 7 crops, joints_3d",
               o32_float["joints_3d"], o32["joints_3d"], F32_ATOL)]
    failed = []
    for what, got, want, bound in pairs:
        if bound is None:
            bound = BF16_REL * float(np.abs(want).max())
        diff = float(np.abs(got - want).max())
        print(f"[slice] {what}: max abs diff {diff:.4e} (bound {bound:.4e})")
        if not diff <= bound:
            failed.append(what)
    assert not failed, failed

    # end to end: every crop of a window of back-to-back requests over
    # the window's wall time, on the pipelined serving path
    window = [rng.randint(0, 256, (WINDOW_CROPS, IMAGE, IMAGE, 3),
                          dtype=np.uint8) for _ in range(WINDOW_REQUESTS)]
    pred.predict(window[0])
    t0 = time.perf_counter()
    for x in window:
        pred.predict(x)
    dt = time.perf_counter() - t0
    n = WINDOW_REQUESTS * WINDOW_CROPS
    print(f"[slice] end to end: {WINDOW_REQUESTS} back-to-back requests of "
          f"{WINDOW_CROPS} uint8 crops (chunks of {big}), {n} crops in "
          f"{dt * 1e3:.1f} ms: {n / dt:.1f} crops/s")
    del window

    print("[slice] per bucket (uint8, 20 requests each): p50 chunk "
          "latency (upload done -> joints on the host, measurement mode, "
          "one chunk at a time) and p50 request latency (host clock, "
          "pipelined path)")
    for b in pred._buckets:
        x = rng.randint(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        chunk_t, req_t = [], []
        for _ in range(20):
            pred.predict(x, chunk_device_times=chunk_t)
            t0 = time.perf_counter()
            pred.predict(x)
            req_t.append(time.perf_counter() - t0)
        print(f"[slice] bucket {b:2d}: p50 chunk "
              f"{np.median(chunk_t) * 1e3:.3f} ms, p50 request "
              f"{np.median(req_t) * 1e3:.3f} ms")
    return pred, crops


def phase_profile(pred, rng):
    """Where a forward chunk's device time goes: torch.profiler over one
    pipelined 256-crop request (4 chunks of 64), kernel time by name, the
    attention kernel's share and the device's idle share of the wall
    time (one stream, so kernel times add up)."""
    x = rng.randint(0, 256, (256, IMAGE, IMAGE, 3)).astype(np.uint8)
    pred.predict(x)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred.predict(x)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events)
    attn = sum(e.self_device_time_total for e in events
               if "attention_fwd" in e.key)
    busy_pct = 100 * busy / wall_us
    print(f"[profile] 256 crops in 4 chunks of 64: wall {wall_us / 1e3:.3f}"
          f" ms, device busy {busy / 1e3:.3f} ms ({busy_pct:.1f}%, idle "
          f"{100 - busy_pct:.1f}%), attention_fwd {attn / 1e3:.4f} ms "
          f"({100 * attn / max(busy, 1e-9):.2f}% of device time)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / busy:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")


def _post(port, arr):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/predict", body=arr.tobytes(), headers={
        "X-Shape": ",".join(map(str, arr.shape)),
        "X-Dtype": str(arr.dtype)})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, (resp.status, body)
    return {k: np.asarray(v, np.float32) for k, v in body.items()}


def phase_serve(pred, crops):
    servers = [make_server(pred, "127.0.0.1", 0),
               make_server(pred, "127.0.0.1", 0, batch_window_ms=5.0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        ports = [s.server_address[1] for s in servers]
        as_float = crops[7].astype(np.float32) / 127.5 - 1.0
        sent = [(ports[0], crops[7]), (ports[0], as_float),
                (ports[1], crops[1])]
        for port, body in sent:
            got = _post(port, body)
            want = pred.predict(body)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
            print(f"[serve] POST /predict {list(body.shape)} "
                  f"{body.dtype} on port {port}: equals predict")
        conn = http.client.HTTPConnection("127.0.0.1", ports[0], timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["status"] == "ok", health
        assert health["image_size"] == IMAGE, health
        print(f"[serve] GET /healthz: {health}")
        batcher = servers[1].RequestHandlerClass.predictor
        assert batcher.requests_served == 1, batcher.requests_served
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "server thread alive"


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's smoke run "
                 "needs one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    rng = np.random.RandomState(0)
    phases = [("build", phase_build), ("kernels", phase_kernels)]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pred, crops = phase_slice(rng)
    print(f"[slice] done in {time.perf_counter() - t0:.1f} s")
    phase_profile(pred, rng)
    t0 = time.perf_counter()
    phase_serve(pred, crops)
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(card_line())
    print(json.dumps({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, **{key: k.result[key] for key in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
