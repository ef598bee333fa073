"""Serving traffic: one client in a closed loop, each request handed to
the port's exported artifact (``export.ExportedPredictor.predict``,
which buckets, pads and replays one CUDA graph per bucket) as soon as
the previous one's numpy answers are back.

Set-up exports the configuration's predictor once per checkout into
``build/portbench/artifacts/<config>-<hash>`` (the hash of every file of
``scat_tpu_torch`` and of the configuration's file; the programs take
the weights as an input, so they do not depend on the seed), loads it,
puts the seed's weights into the tensors the programs read, makes the
pool of crops in pageable host memory and captures the graphs the
traffic uses by serving each of its request sizes twice.  The window
serves requests back to back; a request's latency runs from the call to
its answers.  A traced run then profiles two stretches of
``trace_requests`` more each (``harness.trace``).  Afterwards the
reference answers a seeded sample of the window's requests, the longest
among them.

Traffic parameters: ``sizes`` [lo, hi] (the log-uniform law of the
request sizes; lo = hi for requests of one size), ``size_bins`` (the
sizes of one pass, each seed's in its own order), ``pool`` (distinct
crops), ``check_requests`` (requests compared), ``trace_requests``."""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import resource
import shutil
import time

import numpy as np
import torch

from harness import check, env, port, runner, seeded, trace as trace_lib
from harness.runner import Context, Outcome

BLOCK_ROWS = 64   # rows the reference takes at a time


def artifact_key(config: dict) -> str:
    """A hash of every file of ``scat_tpu_torch`` and of the
    configuration."""
    digest = hashlib.sha256()
    pkg = os.path.join(env.ROOT, "scat_tpu_torch")
    for base, dirs, files in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(files):
            if name.endswith((".pyc", ".so")):
                continue
            path = os.path.join(base, name)
            digest.update(os.path.relpath(path, pkg).encode())
            with open(path, "rb") as f:
                digest.update(f.read())
    digest.update(json.dumps(config, sort_keys=True).encode())
    return digest.hexdigest()[:16]


def artifact(ctx: Context) -> str:
    """The directory of the configuration's exported predictor, exported
    now if this checkout has none yet."""
    name = ctx.cell.entry["config"]
    path = os.path.join(env.ARTIFACTS, f"{name}-{artifact_key(ctx.config)}")
    if os.path.exists(os.path.join(path, "manifest.json")):
        return path
    from scat_tpu_torch.export import export_predictor
    from scat_tpu_torch.models.factory import compute_dtype
    from scat_tpu_torch.serving import HandPosePredictor
    model = port.build(ctx.config, ctx.seed, ctx.device)
    model.cast_compute(compute_dtype(port.options(ctx.config, ctx.seed)))
    predictor = HandPosePredictor(model=model,
                                  image_size=ctx.config["image_size"],
                                  device=ctx.device)
    tmp = f"{path}.{os.getpid()}.tmp"
    export_predictor(predictor, tmp, net=ctx.config["options"]["net"])
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    ctx.say(f"exported {path}")
    return path


def reference_answers(ctx: Context, weights: dict, crops: np.ndarray,
                      num) -> dict:
    """The reference's camera, joints_3d and joints_2d of uint8 crops."""
    from reference import common
    ref = port.reference(ctx.config)
    mean = common.mean_template(ctx.device)
    out = {f: [] for f in check.FIELDS}
    with torch.no_grad(), common.strict_float32():
        for s in range(0, crops.shape[0], BLOCK_ROWS):
            x = torch.from_numpy(crops[s:s + BLOCK_ROWS]).to(ctx.device)
            pred = ref.forward(weights, common.uint8_to_unit(x),
                               ctx.config["model"], False, None, num, mean)
            for f, t in zip(check.FIELDS, common.keypoints(pred)):
                out[f].append(t.cpu().numpy())
    return {f: np.concatenate(v) for f, v in out.items()}


def sample(ctx: Context, plan: list, served: int) -> list:
    """Indices of the requests compared: a seeded sample of the first
    ``served``, the longest of them always among it."""
    rng = np.random.default_rng(int(ctx.seed) + 1)
    k = min(ctx.traffic["check_requests"], served)
    longest = max(range(served), key=lambda i: plan[i][1])
    picked = set(rng.choice(served, size=k, replace=False).tolist())
    if longest not in picked:
        picked.discard(next(iter(picked)))
        picked.add(longest)
    return sorted(picked)


def alter(answers: dict) -> dict:
    """The fault "altered": the request's first answer replaced by its
    second's."""
    return {f: np.concatenate([v[1:2], v[1:]]) for f, v in answers.items()}


def make_pool(ctx: Context) -> np.ndarray:
    gen = seeded.generator(ctx.seed, ctx.device, 1)
    crops = seeded.to_uint8(seeded.images(gen, ctx.traffic["pool"],
                                          ctx.config["image_size"]))
    return crops.cpu().numpy()   # pageable host memory, as callers hold it


def request_plan(ctx: Context, count: int) -> list:
    lo, hi = ctx.traffic["sizes"]
    return seeded.request_plan(ctx.seed, lo, hi, ctx.traffic["size_bins"],
                               ctx.traffic["pool"], count)


def run(ctx: Context) -> Outcome:
    from scat_tpu_torch.export import ExportedPredictor
    from scat_tpu_torch.serving import bucket_ladder
    if ctx.fault not in (None, "altered"):
        raise ValueError(f"no fault {ctx.fault!r} in serving")
    path = artifact(ctx)
    ctx.say(f"set-up: artifact ready at {env.process_age_s():.2f} s")
    predictor = ExportedPredictor(path, device=ctx.device)
    ctx.say(f"set-up: artifact loaded at {env.process_age_s():.2f} s")
    weights = seeded.weights(seeded.shapes_of(predictor.weights),
                             ctx.config["init"], ctx.seed, ctx.device)
    with torch.no_grad():
        for k, t in predictor.weights.items():
            t.copy_(weights[k])   # rounded to the served dtype
    pool = make_pool(ctx)
    # enough requests for any window: at most one a millisecond
    plan = request_plan(ctx, int(1000 * ctx.seconds) + 64 +
                        2 * ctx.traffic["trace_requests"])
    ctx.say(f"set-up: weights and crops made at {env.process_age_s():.2f} s")
    buckets = bucket_ladder(predictor.max_batch)
    for n in sorted({n for _, n in plan}):
        for _ in range(2):
            predictor.predict(pool[:n])
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    setup_s = env.process_age_s()

    answers, latency, ends, failed = [], [], [], 0

    def serve(i):
        off, n = plan[i]
        got = predictor.predict(pool[off:off + n])
        return alter(got) if ctx.fault == "altered" else got

    usage, ticks = resource.getrusage(resource.RUSAGE_SELF), \
        runner.cpu_ticks()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        t = time.perf_counter()
        try:
            answers.append(serve(len(answers)))
        except RuntimeError as err:   # a request that raises is failed
            ctx.say(f"request {len(answers)} failed: {err}")
            answers.append(None)
            failed += 1
        ends.append(time.perf_counter())
        latency.append(ends[-1] - t)
    wall = time.perf_counter() - t0
    served = len(answers)
    crops = sum(plan[i][1] for i in range(served) if answers[i] is not None)
    ctx.say(f"window: {served} requests, {crops} crops in {wall:.3f} s; "
            f"set-up {setup_s:.2f} s")
    ctx.say(runner.host_report(usage, resource.getrusage(
        resource.RUSAGE_SELF), ticks, wall, ends, t0))
    work = {"window_s": wall, "window_crops": crops, "buckets": buckets,
            "trace_sizes": []}

    traced = None
    k = ctx.traffic["trace_requests"] if ctx.trace else 0
    if ctx.trace:
        def stretch(first):
            def requests_from():
                for j in range(k):
                    serve(first + j)
                if ctx.device == "cuda":
                    torch.cuda.synchronize()
            return requests_from
        traced = trace_lib.Traces(
            cuda_only=trace_lib.profile(stretch(served), False, ctx.device),
            with_host=trace_lib.profile(stretch(served + k), True,
                                        ctx.device))
        work["trace_sizes"] = [plan[served + j][1] for j in range(k)]
        work["trace_crops"] = sum(work["trace_sizes"])
        ctx.say(runner.idle_report(traced, work))
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    del predictor
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    from reference.common import F32
    picked = [i for i in sample(ctx, plan, served) if answers[i] is not None]
    numbers = {"answers": math.inf}   # no answer came
    if picked:
        got = {f: np.concatenate([answers[i][f] for i in picked])
               for f in check.FIELDS}
        crops_checked = np.concatenate(
            [pool[plan[i][0]:plan[i][0] + plan[i][1]] for i in picked])
        t = time.perf_counter()
        want = reference_answers(ctx, weights, crops_checked, F32)
        numbers["answers"] = check.answer_gap(got, want)
        ctx.say(f"compared {len(picked)} requests, "
                f"{crops_checked.shape[0]} crops, with the reference in "
                f"{time.perf_counter() - t:.2f} s")
    return Outcome(
        attempted=served, failed=failed, setup_s=setup_s,
        end_to_end={"serve_crops_per_s": crops / wall,
                    "serve_p95_ms": 1e3 * runner.percentile(latency, 95)},
        work=work, numbers=numbers, memory_peak_bytes=peak, trace=traced)


def control(ctx: Context, served: int) -> dict:
    """The compared number of the control: the reference with every
    product's operands in float8 e4m3, put in the program's place, on
    the requests a run of ``served`` requests would compare, held against
    the float32 reference."""
    from reference.common import F32, FP8
    model = port.build(ctx.config, ctx.seed, "meta")
    weights = seeded.weights(seeded.shapes_of(model.state_dict()),
                             ctx.config["init"], ctx.seed, ctx.device)
    pool = make_pool(ctx)
    plan = request_plan(ctx, served)
    crops = np.concatenate([pool[plan[i][0]:plan[i][0] + plan[i][1]]
                            for i in sample(ctx, plan, served)])
    return {"answers": check.answer_gap(
        reference_answers(ctx, weights, crops, FP8),
        reference_answers(ctx, weights, crops, F32))}
