"""Training traffic: back-to-back train steps of the port
(``training.steps.make_train_step`` on a ``TrainState`` with the port's
Adam and warmup) on a pool of distinct batches made on the card from the
seed.

Set-up builds the one train state, loads the seeded weights into its
model (``load_state_dict(strict=True)``), and drives it through its
first three steps on three different batches through the window's own
step function: they warm up every shape, and they are what the
reference follows (each step's loss, the first gradient as Adam holds
it, the change of every leaf after three steps).  The window then runs
steps back to back, the pool's batches in turn, with no synchronisation
but at its end.  Then ``trace_steps`` more steps are profiled with the
CUDA activity alone, where the run is traced or the cell reports
``train_device_us_per_crop`` (the union of the device intervals a crop:
the card's own time, which the host's speed does not move); a traced
run profiles as many again with the host's activity too
(``harness.trace``).

Traffic parameters: ``batch`` (rows a step), ``pool`` (distinct
batches), ``steps_per_epoch`` (the warmup's epoch), ``trace_steps``."""

from __future__ import annotations

import gc
import resource
import time

import torch

from harness import check, env, port, readings, runner, seeded
from harness import trace as trace_lib
from harness.runner import Context, Outcome

FOLLOWED = 3   # steps the reference follows
# the end-to-end quantity of the device's busy time a crop
DEVICE_TIME = "train_device_us_per_crop"


def make_batches(ctx: Context) -> list:
    """The pool of distinct batches: crops, and labels about the mean
    template's joints (root-centred where the model predicts them so)."""
    from reference.common import mean_template
    gen = seeded.generator(ctx.seed, ctx.device, 1)
    size, n = ctx.config["image_size"], ctx.traffic["batch"]
    joints = mean_template(ctx.device)[3:].reshape(21, 3)
    if ctx.config["model"]["root_centred"]:
        joints = joints - joints[1:2]
    sigma_3d, sigma_2d = ctx.traffic["label_sigma"]
    return [{"image": seeded.images(gen, n, size),
             "label": seeded.labels(gen, n, joints, sigma_3d, sigma_2d)}
            for _ in range(ctx.traffic["pool"])]


def planted(ctx: Context, state, step):
    """The step with ``ctx.fault`` planted: "unchanged" leaves the state
    as it was (the optimizer never steps); "half_batch" trains on the
    first half of each batch's rows only."""
    if ctx.fault == "unchanged":
        state.optimizer.step = lambda *a, **k: None
        return step
    if ctx.fault == "half_batch":
        def half(s, batch):
            rows = batch["image"].shape[0] // 2
            return step(s, {k: v[:rows] for k, v in batch.items()})
        return half
    if ctx.fault is not None:
        raise ValueError(f"no fault {ctx.fault!r} in training")
    return step


def program(ctx: Context, model, weights: dict, batches: list):
    """The port's train state of ``model`` with ``weights``, its step,
    and what the reference compares after its first three steps."""
    from scat_tpu_torch.models.factory import compute_dtype
    from scat_tpu_torch.training import schedule, steps
    from scat_tpu_torch.training.state import TrainState
    opt = port.options(ctx.config, ctx.seed)
    model.load_state_dict(weights, strict=True)
    model.set_compute_dtype(compute_dtype(opt))
    optimizer, scheduler = schedule.make_optimizer(
        model, opt.lr, ctx.traffic["steps_per_epoch"])
    state = TrainState.create(model, optimizer, scheduler, seed=ctx.seed)
    step = planted(ctx, state, steps.make_train_step(opt.l_weight_3d,
                                                     opt.l_weight_2d))
    names = {p: k for k, p in model.named_parameters()}
    b1 = optimizer.param_groups[0]["betas"][0]
    # the first step's predictions, as its forward produced them
    preds = []
    hook = model.register_forward_hook(
        lambda module, args, out: preds.append(out[0].detach().float()))
    losses, grad_norms = [], None
    for i in range(FOLLOWED):
        stats = step(state, batches[i])
        losses.append(float(stats["loss"]))
        if grad_norms is None:
            hook.remove()
            # the first gradient as Adam got it: exp_avg = (1 - b1) g
            grad_norms = {names[p]: float(
                optimizer.state[p]["exp_avg"].norm() / (1 - b1))
                if p in optimizer.state else 0.0 for p in names}
    params = dict(model.named_parameters())
    change = {k: float((p.detach() - weights[k]).norm())
              for k, p in params.items()}
    return state, step, {"losses": losses, "grad_norms": grad_norms,
                         "change_norms": change, "pred": torch.cat(preds)}


def follow(ctx: Context, weights: dict, batches: list, num) -> dict:
    """The reference's first three steps from the same weights and
    batches, with the random inputs drawn again as the step draws them."""
    from reference import common
    ref = port.reference(ctx.config)
    model = ctx.config["model"]
    opt = ctx.config["options"]
    mean = common.mean_template(ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    n = ctx.traffic["batch"]
    draws = [ref.draw(gen, n, model) for _ in range(FOLLOWED)]

    def forward_loss(P, images, labels, draw, rows):
        pred = ref.forward(P, images[rows], model, True,
                           ref.slice_draw(draw, rows), num, mean)
        return common.scat_loss(pred, labels, images, opt["l_weight_3d"],
                                opt["l_weight_2d"], rows), pred

    with common.strict_float32():
        return common.follow_steps(
            forward_loss, weights, ref.trainable, batches[:FOLLOWED], draws,
            opt["lr"], ctx.traffic["steps_per_epoch"],
            model.get("row_blocks", 1))


def seeded_weights(ctx: Context, model) -> dict:
    """Float32 weights from the seed for every key of ``model``'s
    state_dict (the reference key layout)."""
    return seeded.weights(seeded.shapes_of(model.state_dict()),
                          ctx.config["init"], ctx.seed, ctx.device)


def run(ctx: Context) -> Outcome:
    model = port.build(ctx.config, ctx.seed, ctx.device)
    ctx.say(f"set-up: model built at {env.process_age_s():.2f} s")
    weights = seeded_weights(ctx, model)
    batches = make_batches(ctx)
    ctx.say(f"set-up: weights and batches made at "
            f"{env.process_age_s():.2f} s")
    state, step, got = program(ctx, model, weights, batches)
    del model
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    setup_s = env.process_age_s()
    pool, n = len(batches), ctx.traffic["batch"]

    window_losses, dispatch, ends = [], [], []
    usage, ticks = resource.getrusage(resource.RUSAGE_SELF), \
        runner.cpu_ticks()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    i = FOLLOWED
    while time.perf_counter() < end:
        t = time.perf_counter()
        stats = step(state, batches[i % pool])
        ends.append(time.perf_counter())
        dispatch.append(ends[-1] - t)
        window_losses.append(stats["loss"])
        i += 1
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps_run = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum()) \
        if window_losses else 0
    ctx.say(f"window: {steps_run} steps of {n} crops in {wall:.3f} s; "
            f"set-up {setup_s:.2f} s")
    ctx.say(runner.host_report(usage, resource.getrusage(
        resource.RUSAGE_SELF), ticks, wall, ends, t0))
    work = {"window_s": wall, "window_crops": steps_run * n, "batch": n,
            "dispatch_s": dispatch, "trace_steps": 0}

    # a stretch traced with the CUDA activity alone, where the run is
    # traced or the cell reports the device time a crop end to end
    reported = {m["name"].split(".")[0] for m in ctx.cell.end_to_end}
    traced, device_us = None, None
    if ctx.trace or DEVICE_TIME in reported:
        k = ctx.traffic["trace_steps"]

        def stretch(first):
            def steps_from():
                for j in range(k):
                    step(state, batches[(first + j) % pool])
                if ctx.device == "cuda":
                    torch.cuda.synchronize()
            return steps_from
        cuda_only = trace_lib.profile(stretch(i), False, ctx.device)
        work.update(trace_steps=k, trace_crops=k * n)
        device_us = readings.device_us_per_crop(cuda_only, k * n)
        ctx.say(f"device time a crop: {device_us!r} us over {k} steps "
                f"traced with the CUDA activity alone")
        if ctx.trace:
            traced = trace_lib.Traces(
                cuda_only=cuda_only,
                with_host=trace_lib.profile(stretch(i + k), True,
                                            ctx.device))
            ctx.say(runner.idle_report(traced, work))
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0

    del state, step
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    from reference.common import F32
    t = time.perf_counter()
    want = follow(ctx, weights, batches, F32)
    numbers = check.train_numbers(got, want)
    ctx.say(f"reference: {FOLLOWED} steps in {time.perf_counter() - t:.2f} s")
    for what in ("grad_norms", "change_norms"):
        gap, leaf = check.worst_leaf(got[what], want[what],
                                     sorted(want["grad_norms"]))
        ctx.say(f"{what}: worst leaf {leaf} {got[what].get(leaf)!r} against "
                f"{want[what].get(leaf)!r} (gap {gap:.4g})")
    ctx.say(f"losses {got['losses']!r} against {want['losses']!r}; "
            f"{len(check.moved_leaves(want['grad_norms']))} of "
            f"{len(want['grad_norms'])} leaves moved enough to compare "
            f"their change")
    return Outcome(
        attempted=steps_run, failed=failed, setup_s=setup_s,
        end_to_end={"train_crops_per_s": work["window_crops"] / wall
                    if wall > 0 else 0.0, DEVICE_TIME: device_us},
        work=work, numbers=numbers, memory_peak_bytes=peak, trace=traced)


def control(ctx: Context) -> dict:
    """The compared numbers of the control: the reference with every
    product's operands in float8 e4m3, put in the program's place, held
    against the float32 reference on the run's weights and batches."""
    from reference.common import F32, FP8
    model = port.build(ctx.config, ctx.seed, "meta")
    weights = seeded_weights(ctx, model)
    batches = make_batches(ctx)
    return check.train_numbers(follow(ctx, weights, batches, FP8),
                               follow(ctx, weights, batches, F32))
