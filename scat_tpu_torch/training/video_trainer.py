"""The video (temporal) training loop, the full SCAT stage (port of
``scat_tpu/training/video_trainer.py:33-138``; BASELINE config 5): frames
with video ids -> ``seqlen``-frame windows (``data/testset.
split_into_chunks``, reference dataset/utils.py:158-178) -> the
adversarial step of ``training/adversarial.py`` over an H3DW encoder and
the motion discriminator.

``VideoTrainer(opt, device=None).train(dataset)`` runs on the CUDA device
unless the caller asks for another (the tests pass ``device="cpu"``):
the encoder (``H3DWEncoder``, resnet50) at ``--compute_dtype`` with
float32 parameters and statistics, the reference VIBE discriminator
(GRU 1024 x 2, attention pooling, motion_discriminator.py:85-94), Adam at
``--lr`` and ``--lr * 0.1``, fresh weights from ``--seed``.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.data.testset import split_into_chunks
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.models import mano as mano_lib
from scat_tpu_torch.models.discriminator import MotionDiscriminator
from scat_tpu_torch.models.factory import compute_dtype
from scat_tpu_torch.models.hand_net import H3DWEncoder
from scat_tpu_torch.models.vibe_loss import VIBELossConfig
from scat_tpu_torch.training.adversarial import (AdversarialTrainState,
                                                 make_adversarial_train_step)
from scat_tpu_torch.utils import checkpoint as ckpt_lib


class VideoChunkDataset:
    """Frames [N,H,W,3] in [-1,1], their 166-float labels and video ids ->
    batches of ``batch_size`` windows ``{"image" [B,T,H,W,3], "label"
    [B,T,166], "real_theta" [B,T,61]}`` on ``device`` (default ``cuda``).
    Each epoch shuffles the windows with ``RandomState(seed + 9973 *
    epoch)`` and draws the real-motion windows from the same stream, as
    the JAX package does; without ``real_theta_bank`` the bank is its
    smooth-noise stand-in for AMASS, drawn from ``RandomState(seed)``."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 vid_names: np.ndarray, seqlen: int = 16, stride: int = 8,
                 batch_size: int = 2,
                 real_theta_bank: Optional[np.ndarray] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device, "VideoChunkDataset")
        self.images = images
        self.labels = labels
        self.windows = split_into_chunks(np.asarray(vid_names), seqlen,
                                         stride)
        self.seqlen = seqlen
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0
        if real_theta_bank is None:
            rng = np.random.RandomState(seed)
            base = rng.randn(64, 1, 61).astype(np.float32) * 0.05
            walk = np.cumsum(
                rng.randn(64, seqlen, 61).astype(np.float32) * 0.01, axis=1)
            real_theta_bank = base + walk
        self.real_theta_bank = real_theta_bank

    def __len__(self) -> int:
        return len(self.windows) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed + 9973 * self._epoch)
        self._epoch += 1
        order = np.arange(len(self.windows))
        rng.shuffle(order)
        B = self.batch_size
        for b in range(len(self)):
            idxs = order[b * B:(b + 1) * B]
            imgs = np.stack([self.images[self.windows[i][0]:
                                         self.windows[i][1] + 1]
                             for i in idxs])
            labs = np.stack([self.labels[self.windows[i][0]:
                                         self.windows[i][1] + 1]
                             for i in idxs])
            bank = self.real_theta_bank[
                rng.randint(0, len(self.real_theta_bank), B)]
            yield {k: torch.as_tensor(v).to(self.device)
                   for k, v in (("image", imgs), ("label", labs),
                                ("real_theta", bank))}


class VideoTrainer:
    """``VideoTrainer(opt).train(dataset)``, the temporal stage.  The
    encoder and discriminator are attributes until the first step builds
    the state from them (a caller may replace them before)."""

    def __init__(self, opt: Options, image_size: int = 224,
                 cfg: VIBELossConfig = VIBELossConfig(),
                 disc_pool: str = "attention", device=None):
        self.opt = opt
        self.device = resolve_device(device, "the VideoTrainer")
        self.image_size = image_size
        self.cfg = cfg
        self.encoder = H3DWEncoder(mean_params=torch.from_numpy(
            assets.load_mean_mano_pose(opt.mean_mano_param)))
        self.discriminator = MotionDiscriminator(
            rnn_size=1024, input_size=48, num_layers=2, output_size=2,
            feature_pool=disc_pool)
        self.mano = mano_lib.ManoModel.from_data(device=self.device)
        self.state: Optional[AdversarialTrainState] = None

    def init_state(self) -> AdversarialTrainState:
        """Fresh weights from ``--seed`` (the encoder's), ``--seed + 1``
        (the discriminator's); the state's generator from ``--seed + 2``."""
        seed = self.opt.seed
        ckpt_lib.init_weights(self.encoder, seed)
        ckpt_lib.init_weights(self.discriminator, seed + 1)
        encoder = self.encoder.to(self.device,
                                  memory_format=torch.channels_last)
        encoder.set_compute_dtype(compute_dtype(self.opt))
        self.state = AdversarialTrainState.create(
            encoder, self.discriminator.to(self.device), self.opt.lr,
            self.opt.lr * 0.1, seed=seed + 2)
        return self.state

    def train(self, dataset, epochs: Optional[int] = None
              ) -> AdversarialTrainState:
        epochs = epochs or self.opt.epoch
        step = make_adversarial_train_step(self.mano, self.cfg)
        state = self.state or self.init_state()
        for epoch in range(epochs):
            t0 = time.perf_counter()
            n = 0
            for batch in dataset:
                stats = step(state, batch)
                n += batch["image"].shape[0]
            host = {k: float(v) for k, v in stats.items()}  # waits
            print("[video %d] gen: %.3f disc: %.3f (d_real %.3f "
                  "d_fake %.3f) %.1f seq/s"
                  % (epoch + 1, host["gen_loss"], host["disc_loss"],
                     host["d_real"], host["d_fake"],
                     n / max(time.perf_counter() - t0, 1e-9)))
        return state
