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
scat_tpu_torch.train_coarse``, ``ViT``, ``ViP``) and refuses the 61-dim
MANO-parameter heads with the JAX trainer's ``ValueError``
(``frankmocap`` trains in the temporal stage,
``training/video_trainer.py``).  It trains on
the synthetic task (``--synthetic_data True``, the JAX
package's ``data/synthetic.py``) or on the mix of ``--stage`` 1-6
(``--synthetic_data False --data_dir <STB tree>``, the other datasets'
trees beside it: FreiHAND, HO-3D, STB, MHP, RHD), whose loaders run
behind ``data/prefetch.prefetch_to_device``.

``--debug True`` (the default) saves sample 0's GT/pred grid every 100
batches as ``debug_img/debug_gt_pred_{--debug_img}.png``
(``viz/draw.debug_pred_gt``; skipped with a message where matplotlib
is missing); ``--profile_trace_dir`` writes a ``torch.profiler`` Chrome
trace of ``--profile_trace_steps`` steps from the 3rd
(``utils/profiling.TraceWindow``); ``--tensorboard True`` mirrors the
CSV as tensorboardX events.  ``--donate_state`` has nothing to do: the
state is updated in place.

Under ``torchrun`` (one process a device) ``--mesh_shape`` lays the
processes out (``parallel/mesh.py``): each rank trains on its rows of
the ``data`` axis, which the loaders of a real dataset read and decode
alone (``data/common``: the ranks of one ``data`` coordinate read the
same rows; the synthetic task and an injected dataset give the global
batch, of which each rank takes its rows), with DDP (or
``--param_sharding fsdp``, FSDP2) and BatchNorm over the global batch;
a ``model`` axis splits the transformer's Megatron pairs, a ``seq`` axis
the token stream of ViP and ViT (the other nets run it replicated, as
the JAX package's do), and a ``pipe`` axis runs replicated, as the JAX
package's train step does.  Process 0 prints, logs and writes the
checkpoints, which every rank gathers to the global layout.
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
from scat_tpu_torch.parallel import mesh as mesh_lib
from scat_tpu_torch.parallel import sharding_rules
from scat_tpu_torch.training import schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.utils import checkpoint as ckpt_lib
from scat_tpu_torch.utils.logging import MetricsLogger
from scat_tpu_torch.utils.profiling import TraceWindow

def check_flags(opt: Options) -> None:
    """Raise on a flag value the trainer cannot run."""
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
    of ``--batch_size`` (the synthetic task: the global batch, which it
    renders on the card, so that every mesh trains on the same rows)."""
    lbs = local_batch_size(opt.batch_size)
    if opt.synthetic_data:
        return SyntheticDataset(
            opt.batch_size, num_batches=opt.steps_per_epoch or 16, seed=opt.seed,
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


def parallelize(state: TrainState, mesh: mesh_lib.Mesh, opt: Options,
                steps_per_epoch: int,
                tp_min_elems: int = sharding_rules.TP_MIN_ELEMS) -> None:
    """Lay a (restored) train state over ``mesh`` in place: the ``model``
    axis's Megatron split, the ``seq`` axis's token split, then DDP or
    FSDP (``--param_sharding fsdp``) over the replicas.  The optimizer is
    rebuilt over the resulting parameters and takes the global-layout
    moments sliced as its parameters are."""
    model = state.model
    opt_sd, sched_sd = state.optimizer.state_dict(), \
        state.scheduler.state_dict()
    if mesh_lib.MODEL_AXIS in mesh.axis_names:
        sharding_rules.shard_transformer(model, mesh, tp_min_elems)
    sp = sharding_rules.seq_parallel(mesh)
    if sp is not None and hasattr(model, "set_seq_parallel"):
        model.set_seq_parallel(sp)
    fsdp = opt.param_sharding == "fsdp"
    if fsdp:
        state.reduce_gradients = mesh_lib.fsdp_state(mesh, model)
    else:
        state.wrapped = mesh_lib.replicate_state(mesh, model)
    foreach = False if fsdp else None
    state.optimizer, state.scheduler = schedule.make_optimizer(
        model, opt.lr, steps_per_epoch, warmup_epochs=15,
        freeze_backbone=opt.freeze, foreach=foreach)
    if opt_sd["state"]:
        mesh_lib.shard_optimizer_state(model, state.optimizer, opt_sd)
        for group in state.optimizer.param_groups:
            group["foreach"] = foreach
    state.scheduler.load_state_dict(sched_sd)
    state.mesh = mesh


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
        self.mesh = mesh_lib.make_mesh(mesh_lib.mesh_axes(opt),
                                       device_type=self.device.type)
        if self.mesh is not None and self.device.type == "cuda":
            self.device = mesh_lib.rank_device("cuda")
        self.is_main = mesh_lib.is_main_process()
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
                "inference (scat_tpu_torch.training.video_trainer and "
                "scat_tpu_torch.evaluation.tester)")
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
        # the batches that hold every rank's rows (the rest are this
        # rank's already)
        self._global_batches = dataset is not None or opt.synthetic_data
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
        if self.mesh is not None:
            parallelize(self.state, self.mesh, opt, steps_per_epoch)
        self.train_step = steps.make_train_step(
            opt.l_weight_3d, opt.l_weight_2d, pl_reg=self.pl,
            ema_reset_compat=opt.compat_pl_ema_reset,
            grad_accum=opt.grad_accum, mesh=self.mesh)

    @property
    def model(self):
        return self.state.model

    def _debug_visualize(self, batch, stats) -> None:
        """The GT/pred grid of sample 0 (reference train.py:211-222): its
        crop back to uint8, its GT joints sliced from the label row (105
        wide, or 166 with the 61 MANO parameters first), the step's
        sample-0 predictions, saved under ``--debug_img``."""
        from scat_tpu_torch.viz import draw
        print("==== Visualize ====")
        image = draw.unnormalize_image(batch["image"][0].float().cpu().numpy())
        label = batch["label"][0].float().cpu().numpy()
        off = 0 if label.shape[0] == 105 else 61
        gt_3d = label[off:off + 63].reshape(21, 3)
        gt_2d = label[off + 63:off + 105].reshape(21, 2)
        pred_3d = stats["pred0_3d"].float().cpu().numpy().reshape(21, 3)
        pred_2d = stats["pred0_2d"].float().cpu().numpy().reshape(21, 2)
        draw.debug_pred_gt(image, gt_2d, gt_3d, pred_2d, pred_3d,
                           self.opt.debug_img)

    def train(self) -> None:
        opt = self.opt
        log_every = max(opt.log_every, 1)
        main = self.is_main
        logger = MetricsLogger(opt.checkpoint_folder if main else None,
                               tensorboard=opt.tensorboard)
        # --profile_trace_dir: one steady-state trace (the reference's
        # t0..t6 wall clocks are taken and never reported,
        # train.py:128-208)
        trace = TraceWindow(opt.profile_trace_dir if main else None,
                            opt.profile_trace_steps)

        def shard(b):
            if not self._global_batches:
                return b
            return mesh_lib.shard_batch(self.mesh, b, opt.grad_accum)
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
                # under a mesh the thread also takes this rank's rows
                # of a global batch
                loader = prefetch_to_device(loader, self.device,
                                            shard=shard)
            for i, batches in enumerate(loader):
                if isinstance(loader, SyntheticDataset):
                    batches = shard(batches)
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
                    trace.step(global_step, stats["loss"])
                if opt.debug and main and i % 100 == 0:
                    # one grid a firing, of the tuple's last member (the
                    # reference overwrites one PNG per member, so only
                    # the last survives)
                    self._debug_visualize(batch, stats)
                if i % log_every == 0:
                    total, l3d, l2d = running.tolist()  # waits for the step
                    pl = float(loss_pl)
                    dt = time.perf_counter() - t_window
                    # stdout divides by log_every like the reference
                    # (train.py:231-232); the CSV by the true step count
                    if main:
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
            if main:
                print(f"epoch {epoch + 1}: {n_samples / dt:.1f} samples/s")
            if epoch % opt.checkpoint_every_epochs == 0:
                ckpt_lib.save_state(opt.checkpoint_folder, self.state)
        if main:
            print("Finished Training")
        trace.stop()
        logger.close()
        ckpt_lib.save_state(opt.checkpoint_folder, self.state,
                            ckpt_lib.FINAL_NAME)


def main(argv=None):
    Trainer(BaseOptions().parse(argv)).train()


if __name__ == "__main__":
    main()
