"""The trainer (port of ``scat_tpu/training/trainer.py``; reference
train.py:122-246): epoch loop -> batch loop -> train step (valid mask,
forward, projection, losses, backward, Adam with the warmup) -> the
reference's loss prints every ``--log_every`` steps -> a checkpoint every
``--checkpoint_every_epochs`` epochs -> the final save.

``Trainer(opt, device=None).train()`` runs on the CUDA device unless the
caller asks for another (the tests pass ``device="cpu"``).  Parameters,
BatchNorm statistics and Adam moments are float32; the backbone, 1x1
conv and transformer compute in ``--compute_dtype`` under autocast.  The
step stays asynchronous: losses accumulate on the device and reach the
host only at the log boundary.

It trains the 66-dim heads (``--net reg_transformer``,
``reg_transformer_coarse`` through ``python -m
scat_tpu_torch.train_coarse``, ``ViP``) and refuses the 61-dim
MANO-parameter heads with the JAX trainer's ``ValueError``.  It trains on
the synthetic task (``--synthetic_data True``, the JAX
package's ``data/synthetic.py``) or on the mix of ``--stage`` 1-6
(``--synthetic_data False --data_dir <STB tree>``, the other datasets'
trees beside it: FreiHAND, HO-3D, STB, MHP, RHD), whose loaders run
behind ``data/prefetch.prefetch_to_device``.  Flags whose feature is not
ported raise and name their ROADMAP.md item (``UNPORTED_FLAGS``); none is
ignored.  ``--donate_state`` has nothing to do: the state is
updated in place.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import torch

from scat_tpu_torch import assets
from scat_tpu_torch.config import BaseOptions, Options
from scat_tpu_torch.data.common import local_batch_size
from scat_tpu_torch.data.prefetch import prefetch_to_device
from scat_tpu_torch.data.synthetic import SyntheticDataset
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models.factory import MANO_PARAM_NETS, compute_dtype
from scat_tpu_torch.training import schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.utils import checkpoint as ckpt_lib
from scat_tpu_torch.utils.logging import MetricsLogger

# (flag, test on the options, ROADMAP.md queue 1 item that ports it)
UNPORTED_FLAGS = (
    ("--debug True (the debug grid of viz/)", lambda o: o.debug, 18),
    ("--param_sharding fsdp", lambda o: o.param_sharding == "fsdp", 17),
    ("a multi-device --mesh_shape",
     lambda o: any(size not in (1, -1) for _, size in mesh_axes(o)), 17),
    ("--profile_trace_dir", lambda o: bool(o.profile_trace_dir), 18),
    ("--tensorboard True", lambda o: o.tensorboard, 18),
)


def mesh_axes(opt: Options):
    """``--mesh_shape`` as ((name, size), ...), -1 = every device."""
    axes = []
    for part in opt.mesh_shape.split(","):
        name, _, n = part.partition(":")
        axes.append((name.strip(), int(n) if n else -1))
    return tuple(axes)


def check_flags(opt: Options) -> None:
    """Raise on a flag the port does not carry yet, naming its item."""
    for what, hit, item in UNPORTED_FLAGS:
        if hit(opt):
            raise NotImplementedError(
                f"{what} is not ported to scat_tpu_torch yet "
                f"(ROADMAP.md queue 1 item {item})")
    if opt.param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"--param_sharding {opt.param_sharding!r}: "
                         "expected 'replicated' or 'fsdp'")
    if opt.grad_accum < 1 or opt.batch_size % opt.grad_accum:
        raise ValueError(
            f"--grad_accum {opt.grad_accum} must be >= 1 and divide "
            f"--batch_size {opt.batch_size}")


def make_dataset(opt: Options, image_size: int, training: bool = True,
                 device=None):
    """The batches of ``opt`` on ``device``: the synthetic task, the
    training mix of ``--stage``, or the evaluation set of
    ``--eval_dataset`` (STB, frei or ho3d), each at this process's share
    of ``--batch_size``."""
    lbs = local_batch_size(opt.batch_size)
    if opt.synthetic_data:
        return SyntheticDataset(
            lbs, num_batches=opt.steps_per_epoch or 16, seed=opt.seed,
            image_size=image_size,
            mean_params=assets.load_mean_params(outside=opt.outside),
            layout=opt.synthetic_layout, device=resolve_device(device))
    if training:
        from scat_tpu_torch.data.multi import concat_dataset
        return concat_dataset(lbs, opt, device=device)
    if opt.eval_dataset == "frei":
        # stage "training" picks the labelled split, which the reference
        # evaluates (eval.py:793-795); eval batches are neither shuffled
        # nor jittered
        from scat_tpu_torch.data.freihand import get_loader_frei
        return get_loader_frei("training", lbs, opt, shuffle=False,
                               color_jitter=False, device=device)
    if opt.eval_dataset == "ho3d":
        from scat_tpu_torch.data.ho3d import get_loader_ho3d
        return get_loader_ho3d("training", lbs, opt, shuffle=False,
                               device=device)
    from scat_tpu_torch.data.stb import get_loader_STB_eval
    return get_loader_STB_eval(opt, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """``Trainer(opt).train()``, the reference train.py:29-246 surface."""

    def __init__(self, opt: Options, device=None, image_size: int = 224,
                 dataset: Optional[Iterable] = None):
        check_flags(opt)
        self.opt = opt
        self.device = resolve_device(device, "the trainer")
        self.batch_size = opt.batch_size
        self.epoches = opt.epoch
        self.pl = opt.pl_reg
        print("with pose length reg" if self.pl else "no pose length reg")
        if not (opt.l_weight_3d or opt.l_weight_2d or self.pl):
            print("WARNING: l_weight_3d == l_weight_2d == 0 and pl_reg "
                  "off — the training loss is identically zero (the "
                  "reference's default too); pass --l_weight_3d 100000 "
                  "--l_weight_2d 10 for the canonical run")
        if opt.net == "reg_transformer":
            print("[iccv2021 scat] Transformer regressor...")
        elif opt.net in MANO_PARAM_NETS:
            # the JAX trainer's refusal (scat_tpu/training/trainer.py:
            # 128-139): these heads emit 61 MANO parameters, not the
            # 66-dim camera + joints that the keypoint loss reads, and the
            # reference ships no training script for them
            raise ValueError(
                f"--net {opt.net} is a 61-dim MANO-parameter head; "
                "use the adversarial stage for training or the tester for "
                "inference (scat_tpu_torch.training.adversarial and "
                "scat_tpu_torch.evaluation.tester, ROADMAP.md queue 1 "
                "items 14 and 11)")
        model, self.mean_params = build_model(opt, image_size)
        ckpt_lib.load_weights(model, "", seed=opt.seed)
        if opt.pretrained_resnet_pth:
            ckpt_lib.load_pretrained_backbone(model,
                                              opt.pretrained_resnet_pth)
        # NHWC batches are channels_last NCHW views; channels_last
        # weights let cuDNN run NHWC convolutions
        model = model.to(self.device, memory_format=torch.channels_last)
        model.set_compute_dtype(compute_dtype(opt))

        self.train_loader = dataset if dataset is not None else \
            make_dataset(opt, image_size, device=self.device)
        steps_per_epoch = len(self.train_loader)
        print("batch num", steps_per_epoch)
        optimizer, scheduler = schedule.make_optimizer(
            model, opt.lr, steps_per_epoch, warmup_epochs=15,
            freeze_backbone=opt.freeze)
        self.state = TrainState.create(model, optimizer, scheduler,
                                       seed=opt.seed)
        self.success_load = False
        if opt.resume:
            self.success_load = ckpt_lib.restore_state(opt.checkpoint_hand,
                                                       self.state)
        self.train_step = steps.make_train_step(
            opt.l_weight_3d, opt.l_weight_2d, pl_reg=self.pl,
            ema_reset_compat=opt.compat_pl_ema_reset,
            grad_accum=opt.grad_accum)

    @property
    def model(self):
        return self.state.model

    def train(self) -> None:
        opt = self.opt
        log_every = max(opt.log_every, 1)
        logger = MetricsLogger(opt.checkpoint_folder)
        global_step = self.state.step
        for epoch in range(self.epoches):
            # loss_pl accumulates over the whole epoch and prints raw, as
            # the reference's does (train.py:224-234)
            running = torch.zeros(3, device=self.device)
            loss_pl = torch.zeros((), device=self.device)
            window_steps = 0
            _sync(self.device)
            t_epoch = t_window = time.perf_counter()
            n_samples = 0
            # a real loader decodes and stages batch i+1 in a background
            # thread while the card runs step i; the synthetic task
            # renders on the card in the step's stream
            loader = self.train_loader
            if not isinstance(loader, SyntheticDataset):
                loader = prefetch_to_device(loader, self.device)
            for i, batches in enumerate(loader):
                # ConcatDataset yields one batch of each member: one step
                # each, as the reference's inner loop (train.py:136-138)
                if isinstance(batches, dict):
                    batches = (batches,)
                for batch in batches:
                    stats = self.train_step(self.state, batch)
                    n_samples += self.batch_size
                    global_step += 1
                    running += torch.stack([stats["loss"], stats["loss_3d"],
                                            stats["loss_2d"]])
                    loss_pl += stats["loss_pl"]
                    window_steps += 1
                if i % log_every == 0:
                    total, l3d, l2d = running.tolist()  # waits for the step
                    pl = float(loss_pl)
                    dt = time.perf_counter() - t_window
                    # stdout divides by log_every like the reference
                    # (train.py:231-232); the CSV by the true step count
                    print("[%d, %5d] loss: %.3f, 3d loss: %.3f, "
                          "2d loss: %.3f, pose length reg: %.3f"
                          % (epoch + 1, i + 1, total / log_every,
                             l3d / log_every, l2d / log_every, pl))
                    logger.log(global_step, {
                        "epoch": epoch + 1,
                        "loss": total / window_steps,
                        "loss_3d": l3d / window_steps,
                        "loss_2d": l2d / window_steps,
                        "loss_pl": pl,
                        "samples_per_sec":
                            window_steps * self.batch_size / dt,
                        "ms_per_step": 1e3 * dt / window_steps})
                    running.zero_()
                    window_steps = 0
                    t_window = time.perf_counter()
            _sync(self.device)
            dt = time.perf_counter() - t_epoch
            print(f"epoch {epoch + 1}: {n_samples / dt:.1f} samples/s")
            if epoch % opt.checkpoint_every_epochs == 0:
                ckpt_lib.save_state(opt.checkpoint_folder, self.state)
        print("Finished Training")
        logger.close()
        ckpt_lib.save_state(opt.checkpoint_folder, self.state,
                            ckpt_lib.FINAL_NAME)


def main(argv=None):
    Trainer(BaseOptions().parse(argv)).train()


if __name__ == "__main__":
    main()
