#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (scat_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, in order; any failure raises and exits non-zero:
  1. build    compile every kernel source under scat_tpu_torch/csrc
              (one nvcc each, in parallel) and print the card's name and
              power limit;
  2. kernels  each kernel against its plain PyTorch version on the card
              at the serving and training paths' shapes: float32 (TF32
              off) at atol 2e-5, bfloat16 at atol = rtol = 1e-2 against
              the plain version run in float32 on the same bf16 inputs;
              flash_attention's autograd against autograd through the
              plain forward; then each kernel timed beside its plain
              version and the library call (SDPA forward, and SDPA
              forward+backward beside the two kernels' sum);
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
  5. train    the Trainer at the canonical run's configuration
              (script/ablation_pose.sh on the synthetic task: resnet50,
              bs 96, 224x224, 8 heads, iteration 3, mask_rate 0.2, bf16
              compute, Adam with the warmup, seed 0) for 3 epochs of 8
              steps: finite losses, 3 forward and 3 backward attention
              launches per step, a falling loss; one step's loss and
              gradient norm against the plain attention path; a
              grad_accum 2 step; hand_net_final.pth served by
              HandPosePredictor; the eval step's PCK and MPJPE; then the
              training rate, p50 step time and a profile;
  6. the card line, the kernels line, and the final
     {"ok": true, "device": ...} line.

TF32 is off for the whole run (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32), so float32 comparisons are float32.
"""

import copy
import csv
import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from scat_tpu_torch.config import Options
from scat_tpu_torch.kernels import build
from scat_tpu_torch.models.transformer import Attention
from scat_tpu_torch.ops.attention import (attention_bwd,
                                          attention_bwd_reference,
                                          attention_reference,
                                          flash_attention)
from scat_tpu_torch.server import make_server
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.training import steps
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLAGSHIP = Options(net="reg_transformer", vit_heads=8, vit_depth=3,
                   iteration=3, compute_dtype="bfloat16",
                   use_pallas_attention=True, checkpoint_path_eval="",
                   seed=0)
# the canonical training run, script/ablation_pose.sh, on the synthetic
# task; the checkpoints go to build/, which .gitignore lists
TRAIN = dataclasses.replace(
    FLAGSHIP, batch_size=96, lr=5e-4, l_weight_3d=1e5, l_weight_2d=10.0,
    pos_embed=True, mask_rate=0.2, synthetic_data=True, debug=False,
    epoch=3, steps_per_epoch=8, log_every=1,
    checkpoint_folder=os.path.join("build", "chip_smoke_train"))
IMAGE = 224
HEADS, TOKENS, HEAD_DIM = 8, 21, 64
TRAIN_BATCH = 96
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
    Kernel("attention_bwd", "cuda", "scat_tpu_torch/csrc/attention_bwd.cu",
           "scat_tpu/ops/pallas_attention.py:63", attention_bwd),
]
FWD, BWD = KERNELS


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


def grad_out(b, h, n, d, dtype, seed):
    """dO as autograd delivers it after the merge of heads: [B,N,H,D]
    storage seen as [B,H,N,D]."""
    g = torch.Generator().manual_seed(seed)
    do = torch.randn(b, n, h, d, generator=g).to("cuda", dtype)
    return do.permute(0, 2, 1, 3)


def bound(n_bytes, flops):
    """(ms, what bounds it): the larger of bytes over the memory rate
    and bf16 flops over the tensor cores' peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels():
    buckets = [1, 2, 4, 7, 8, 16, 32, 64, TRAIN_BATCH]
    shapes = [(b, HEADS, TOKENS, HEAD_DIM) for b in buckets]
    shapes += [(2, 4, 128, HEAD_DIM), (3, 2, TOKENS, HEAD_DIM)]
    train_shape = (TRAIN_BATCH, HEADS, TOKENS, HEAD_DIM)
    for i, shape in enumerate(shapes):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
            rtol = tol if dtype == torch.bfloat16 else 0
            q, k, v = qkv_views(*shape, dtype, seed=i)
            do = grad_out(*shape, dtype, seed=1000 + i)
            with torch.no_grad():
                got = flash_attention(q, k, v, SCALE)
            dgot = attention_bwd(q, k, v, do, SCALE)
            torch.cuda.synchronize()
            want = attention_reference(q.float(), k.float(), v.float(),
                                       SCALE)
            dwant = attention_bwd_reference(q.float(), k.float(), v.float(),
                                            do.float(), SCALE)
            err = (got.float() - want).abs().max().item()
            derr = max((a.float() - b).abs().max().item()
                       for a, b in zip(dgot, dwant))
            torch.testing.assert_close(got.float(), want, atol=tol,
                                       rtol=rtol)
            for name, a, b in zip(("dq", "dk", "dv"), dgot, dwant):
                assert a.dtype == dtype, (name, a.dtype)
                torch.testing.assert_close(a.float(), b, atol=tol,
                                           rtol=rtol, msg=name)
            print(f"[kernels] {list(shape)} {str(dtype)[6:]}: attention_fwd "
                  f"max_abs_err {err:.3e}, attention_bwd max_abs_err "
                  f"{derr:.3e} (tol {tol})")
            if shape == train_shape and dtype == torch.bfloat16:
                FWD.result["max_abs_err"] = err
                BWD.result["max_abs_err"] = derr

    # the autograd.Function against autograd through the plain version,
    # float32, on the strided views the model passes
    for i, shape in enumerate([train_shape, (2, 4, 128, HEAD_DIM)]):
        views = qkv_views(*shape, torch.float32, seed=50 + i)
        leaves = [t.detach().requires_grad_(True) for t in views]
        do = grad_out(*shape, torch.float32, seed=60 + i)
        got = torch.autograd.grad(flash_attention(*leaves, SCALE), leaves,
                                  do)
        want = torch.autograd.grad(attention_reference(*leaves, SCALE),
                                   leaves, do)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
        print(f"[kernels] flash_attention autograd {list(shape)} float32 "
              f"vs autograd through attention_reference: max_abs_err "
              f"{err:.3e} (tol 2e-05)")

    print("[kernels] device times in ms, bf16, q/k/v strided views as in "
          "the model; 200 calls in one CUDA graph, timed by CUDA events:")
    for b in (1, 7, 64, TRAIN_BATCH):
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
        ms, by = bound(n_bytes, flops)
        print(f"[kernels] attention_fwd b={b:2d} [{b},8,21,64]: kernel "
              f"{dev['kernel']:.5f} plain {dev['plain']:.5f} sdpa "
              f"{dev['sdpa']:.5f} | bound {ms:.6f} ({by}: "
              f"{n_bytes} B, {flops} flop)")
        if b == TRAIN_BATCH:
            FWD.result.update(ms=dev["kernel"], plain_ms=dev["plain"],
                              library_ms=dev["sdpa"], bound_ms=ms,
                              bound_by=by)

    # the backward at the training shape; the library yardstick is SDPA's
    # forward+backward through autograd, beside the two kernels' sum
    b = TRAIN_BATCH
    q, k, v = qkv_views(b, HEADS, TOKENS, HEAD_DIM, torch.bfloat16, seed=7)
    do = grad_out(b, HEADS, TOKENS, HEAD_DIM, torch.bfloat16, seed=8)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    dev = {
        "kernel": device_ms(lambda: attention_bwd(q, k, v, do, SCALE)),
        "plain": device_ms(
            lambda: attention_bwd_reference(q, k, v, do, SCALE)),
        "kernels fwd+bwd": device_ms(lambda: torch.autograd.grad(
            flash_attention(*leaves, SCALE), leaves, do)),
        "sdpa fwd+bwd": device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, scale=SCALE), leaves,
            do))}
    n_bytes = 7 * b * HEADS * TOKENS * HEAD_DIM * 2
    flops = 10 * b * HEADS * TOKENS * TOKENS * HEAD_DIM
    ms, by = bound(n_bytes, flops)
    print(f"[kernels] attention_bwd b={b} [{b},8,21,64]: kernel "
          f"{dev['kernel']:.5f} plain {dev['plain']:.5f} | kernels "
          f"fwd+bwd {dev['kernels fwd+bwd']:.5f} sdpa fwd+bwd "
          f"{dev['sdpa fwd+bwd']:.5f} | bound {ms:.6f} ({by}: {n_bytes} B, "
          f"{flops} flop)")
    BWD.result.update(ms=dev["kernel"], plain_ms=dev["plain"],
                      library_ms=dev["sdpa fwd+bwd"], bound_ms=ms,
                      bound_by=by)


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
    assert model.transformer.layers[0][0].fn.fn.to_qkv.weight.dtype \
        == torch.bfloat16
    assert model.main_encoder.bn1.running_var.dtype == torch.float32
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
    FWD.result["launches"] = launches
    print(f"[slice] requests {list(REQUESTS)} uint8 + 7 float32: "
          f"{chunks} forward chunks, attention_fwd launches {launches}, "
          f"attention_bwd launches {attention_bwd.launches}")
    assert launches == 3 * chunks, (launches, chunks)
    assert attention_bwd.launches == 0, attention_bwd.launches
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


def device_profile(tag, fn, what):
    """torch.profiler over ``fn()`` (which ends in a synchronize): wall
    time, the device's busy and idle share of it, each attention
    kernel's share of device time, and the top device operations (one
    stream, so kernel times add up).  Returns the busy time in ms."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again, and so do the device-side ranges
    # of user annotations (the optimizer's step)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events)
    busy_pct = 100 * busy / wall_us
    shares = []
    for k in KERNELS:
        t = sum(e.self_device_time_total for e in events if k.name in e.key)
        shares.append(f"{k.name} {t / 1e3:.4f} ms "
                      f"({100 * t / max(busy, 1e-9):.2f}% of device time)")
    print(f"[{tag}] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({busy_pct:.1f}%, idle "
          f"{100 - busy_pct:.1f}%), {', '.join(shares)}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / busy:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")
    return busy / 1e3


def phase_profile(pred, rng):
    """Where a forward chunk's device time goes: one pipelined 256-crop
    request (4 chunks of 64)."""
    x = rng.randint(0, 256, (256, IMAGE, IMAGE, 3)).astype(np.uint8)
    pred.predict(x)
    device_profile("profile", lambda: pred.predict(x),
                   "256 crops in 4 chunks of 64")


def set_kernel(model, on: bool):
    for m in model.modules():
        if isinstance(m, Attention):
            m.use_kernel = on


def phase_train(rng):
    t0 = time.perf_counter()
    trainer = Trainer(TRAIN, image_size=IMAGE)
    state, model = trainer.state, trainer.model
    assert model.main_encoder.fc1.in_features == 2048      # resnet50
    assert model.transformer.layers[0][0].fn.norm.normalized_shape \
        == ((IMAGE // 8) ** 2,)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.compute_dtype == torch.bfloat16
    print(f"[train] trainer built in {time.perf_counter() - t0:.1f} s "
          f"(resnet50, bs {TRAIN.batch_size}, {IMAGE}x{IMAGE}, "
          f"{(IMAGE // 8) ** 2}-dim tokens, 8 heads, iteration 3, mask_rate "
          f"0.2, bf16 compute, float32 parameters)")
    log = os.path.join(TRAIN.checkpoint_folder, "metrics.csv")
    if os.path.exists(log):
        os.remove(log)
    n_steps = TRAIN.epoch * TRAIN.steps_per_epoch
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    print(f"[train] {TRAIN.epoch} epochs x {TRAIN.steps_per_epoch} steps in "
          f"{time.perf_counter() - t0:.1f} s (first steps and saves "
          f"included); attention_fwd launches {fwd}, attention_bwd "
          f"launches {bwd}")
    FWD.result["launches"] += fwd
    BWD.result["launches"] = bwd
    assert fwd == 3 * n_steps and bwd == 3 * n_steps, (fwd, bwd, n_steps)
    with open(log) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses) == n_steps and np.isfinite(losses).all(), losses
    quarter = n_steps // 4
    first, last = np.mean(losses[:quarter]), np.mean(losses[-quarter:])
    print(f"[train] loss: mean of the first {quarter} steps {first:.1f}, "
          f"of the last {quarter} {last:.1f}")
    assert last < first, (first, last)

    # one step's loss and gradient norm, kernels against plain attention,
    # from the same weights, batch and token mask
    batches = list(trainer.train_loader)[:2]
    batch = batches[0]
    flags = torch.zeros(21, dtype=torch.bool, device="cuda")
    flags[[0, 5, 9, 17]] = True

    def loss_and_grad_norm():
        model.zero_grad(set_to_none=True)
        bd = steps.forward_loss(model, batch["image"], batch["label"],
                                batch["valid"], TRAIN.l_weight_3d,
                                TRAIN.l_weight_2d, token_mask=flags)[0]
        bd.total.backward()
        norm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                              for p in model.parameters()
                              if p.grad is not None))
        return bd.total.item(), norm.item()

    reset_counts()
    loss_k, norm_k = loss_and_grad_norm()
    assert flash_attention.launches == 3 and attention_bwd.launches == 3
    set_kernel(model, False)
    loss_p, norm_p = loss_and_grad_norm()
    assert flash_attention.launches == 3 and attention_bwd.launches == 3, \
        "plain path launched"
    set_kernel(model, True)
    model.zero_grad(set_to_none=True)
    failed = []
    for what, got, want in (("loss", loss_k, loss_p),
                            ("global gradient norm", norm_k, norm_p)):
        diff, bnd = abs(got - want), BF16_REL * abs(want)
        print(f"[train] bf16 kernel vs plain attention, one step, {what}: "
              f"{got:.6g} vs {want:.6g}, diff {diff:.4e} (bound {bnd:.4e})")
        if not diff <= bnd:
            failed.append(what)
    assert not failed, failed

    stats = steps.make_train_step(TRAIN.l_weight_3d, TRAIN.l_weight_2d,
                                  grad_accum=2)(state, batch)
    assert np.isfinite(stats["loss"].item())
    print(f"[train] grad_accum 2 step: loss {stats['loss'].item():.1f}")

    # the final checkpoint, served as it is: in bf16 it equals the trained
    # model cast to bf16; in float32 it agrees with the trained model's
    # float32 eval forward to the float32 bar
    path = checkpoint.save_state(TRAIN.checkpoint_folder, state,
                                 checkpoint.FINAL_NAME)
    crops = rng.randint(0, 256, (8, IMAGE, IMAGE, 3)).astype(np.uint8)
    served = HandPosePredictor.from_checkpoint(
        dataclasses.replace(TRAIN, checkpoint_path_eval=path),
        image_size=IMAGE)
    got = served.predict(crops)
    check_output(got, 8)
    mirror = HandPosePredictor(
        model=copy.deepcopy(model).cast_compute(torch.bfloat16),
        image_size=IMAGE)
    for k, v in mirror.predict(crops).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    del served, mirror
    got32 = HandPosePredictor.from_checkpoint(
        dataclasses.replace(TRAIN, checkpoint_path_eval=path,
                            compute_dtype="float32"),
        image_size=IMAGE).predict(crops)
    model.eval().set_compute_dtype(torch.float32)
    with torch.no_grad():
        x = torch.from_numpy(crops).cuda().float() / 127.5 - 1.0
        want = model(x.permute(0, 3, 1, 2))[0][:, 3:].reshape(-1, 21, 3)
    model.train().set_compute_dtype(torch.bfloat16)
    diff = float(np.abs(got32["joints_3d"] - want.cpu().numpy()).max())
    print(f"[train] {path} served by HandPosePredictor: bf16 predict equals "
          f"the trained model's; float32 predict vs the trained model's "
          f"float32 eval forward, joints_3d max abs diff {diff:.4e} (bound "
          f"{F32_ATOL})")
    assert diff <= F32_ATOL, diff

    ev = steps.make_eval_step(model)(batch)
    pck, err = ev["pck"].cpu().numpy(), ev["mpjpe_per_sample"].cpu().numpy()
    assert pck.shape == (7, 22) and ((pck >= 0) & (pck <= 100)).all()
    assert np.isfinite(err).all() and err.shape == (TRAIN.batch_size,)
    print(f"[train] eval step on a training batch: PA-MPJPE "
          f"{1e3 * err.mean():.2f} mm, PCK at 20..50 mm "
          f"{', '.join(f'{v:.2f}' for v in pck[:, -1])} %")

    # the training rate: a window of steps after warm-up, synchronised at
    # its ends; then each step synchronised for the p50 step time
    step = trainer.train_step
    for i in range(3):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    window = 20
    t0 = time.perf_counter()
    for i in range(window):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    times = []
    for i in range(10):
        t1 = time.perf_counter()
        step(state, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    print(f"[train] rate: {window} steps of {TRAIN.batch_size} crops in "
          f"{dt * 1e3:.1f} ms: {window * TRAIN.batch_size / dt:.1f} crops/s; "
          f"p50 step time {np.median(times) * 1e3:.3f} ms (10 steps, each "
          f"synchronised); card {card_line()}")

    def three_steps():
        for i in range(3):
            step(state, batches[i % 2])
        torch.cuda.synchronize()

    busy = device_profile("train", three_steps, f"3 train steps of "
                          f"{TRAIN.batch_size} crops")
    # the profiler slows the host; against the unprofiled p50 step time
    p50 = float(np.median(times)) * 1e3
    print(f"[train] device busy {busy / 3:.3f} ms per step against the "
          f"p50 step time {p50:.3f} ms: device idle "
          f"{100 * (1 - busy / 3 / p50):.1f}% of an unprofiled step")


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
    del pred, crops
    t0 = time.perf_counter()
    phase_train(rng)
    print(f"[train] done in {time.perf_counter() - t0:.1f} s")
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
