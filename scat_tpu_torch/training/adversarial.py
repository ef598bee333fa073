"""The temporal stage's adversarial step (port of
``scat_tpu/training/adversarial.py:30-145``; BASELINE config 5).

A window batch: ``image`` [B,T,H,W,3] crops in [-1,1], ``label``
[B,T,166] (pose 3:51, 3D joints 61:124, 2D joints 124:166, reference
train.py:193-196) and ``real_theta`` [B,T,61], a real motion bank for the
discriminator.  One step:

  1. the generator: the frames folded into the batch ([B*T, ...]) through
     the encoder in training mode (its BatchNorm statistics update over
     the B*T frames) -> thetas [B*T,61] -> the MANO decode in float32
     (``decode_thetas``: joints and their projection to 224-pixel crop
     coordinates) -> the discriminator on the pose sequences
     ``thetas[:, :, 3:51]`` -> ``vibe_generator_loss`` -> the gradient
     with respect to the encoder's parameters only (``backward(inputs=)``:
     the discriminator's ``.grad`` stays untouched) -> Adam;
  2. the discriminator, on the thetas of step 1 detached (computed before
     the encoder's update, reference loss.py:200) and the real bank ->
     ``vibe_discriminator_loss`` -> Adam.

The discriminator is applied deterministically on both sides (no
attention dropout), as the JAX step applies it, and stays in training
mode, which cuDNN's GRU backward needs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from scat_tpu_torch.models import mano as mano_lib
from scat_tpu_torch.models import vibe_loss as vl
from scat_tpu_torch.ops.geometry import batch_orth_proj_idrot, project_2d

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdversarialTrainState:
    """The encoder, the discriminator, their Adams, the step and the
    generator of the stage's random draws, updated in place."""

    encoder: nn.Module
    discriminator: nn.Module
    gen_optimizer: torch.optim.Optimizer
    disc_optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, encoder: nn.Module, discriminator: nn.Module,
               gen_lr: float, disc_lr: float, seed: int = 0
               ) -> "AdversarialTrainState":
        """Adam at torch's defaults (optax's ``adam``: b1 0.9, b2 0.999,
        eps 1e-8) for each side."""
        device = next(encoder.parameters()).device
        return cls(encoder=encoder, discriminator=discriminator,
                   gen_optimizer=torch.optim.Adam(encoder.parameters(),
                                                  lr=gen_lr),
                   disc_optimizer=torch.optim.Adam(
                       discriminator.parameters(), lr=disc_lr),
                   generator=torch.Generator(device).manual_seed(seed))


def decode_thetas(mano: mano_lib.ManoModel, thetas_flat: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """theta [N,61] -> (joints [N,21,3], 2D joints [N,21,2] in crop
    pixels), in float32."""
    thetas_flat = thetas_flat.float()
    out = mano_lib.rot_pose_beta_to_mesh(
        mano, thetas_flat[:, 3:6], thetas_flat[:, 6:51],
        thetas_flat[:, 51:61])
    joints = out[:, :21]
    return joints, project_2d(batch_orth_proj_idrot(joints,
                                                    thetas_flat[:, :3]))


def _grad_norm(params) -> torch.Tensor:
    grads = [p.grad.float().square().sum() for p in params
             if p.grad is not None]
    return torch.stack(grads).sum().sqrt()


def generator_step(state: AdversarialTrainState, batch: Batch,
                   mano: mano_lib.ManoModel,
                   cfg: vl.VIBELossConfig = vl.VIBELossConfig(),
                   grad_norm: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Step 1: the encoder's update.  Returns (thetas [B,T,61], detached,
    from before the update; the stats as device tensors)."""
    images, labels = batch["image"], batch["label"]
    B, T = images.shape[:2]
    encoder = state.encoder.train()
    flat = images.reshape((B * T,) + tuple(images.shape[2:]))
    _, thetas_flat = encoder(flat.permute(0, 3, 1, 2))
    joints, j2d = decode_thetas(mano, thetas_flat)
    thetas = thetas_flat.float().reshape(B, T, 61)
    labels = labels.float()
    zeros = labels.new_zeros
    gt_theta = torch.cat([zeros(B, T, 3), labels[..., 3:51],
                          zeros(B, T, 10)], dim=-1)
    disc_fake = state.discriminator(thetas[:, :, 3:51])
    total, parts = vl.vibe_generator_loss(
        cfg, thetas, j2d.reshape(B, T, 21, 2), joints.reshape(B, T, 21, 3),
        labels[..., 124:].reshape(B, T, 21, 2),
        labels[..., 61:124].reshape(B, T, 21, 3), gt_theta,
        disc_fake_value=disc_fake)
    params = [p for p in encoder.parameters() if p.requires_grad]
    state.gen_optimizer.zero_grad(set_to_none=True)
    total.backward(inputs=params)
    stats = {"gen_loss": total.detach(),
             **{k: v.detach() for k, v in parts.items()}}
    if grad_norm:
        stats["gen_grad_norm"] = _grad_norm(params)
    state.gen_optimizer.step()
    return thetas.detach(), stats


def discriminator_step(state: AdversarialTrainState,
                       fake_motion: torch.Tensor, real_theta: torch.Tensor,
                       cfg: vl.VIBELossConfig = vl.VIBELossConfig(),
                       grad_norm: bool = False) -> Dict[str, torch.Tensor]:
    """Step 2: the discriminator's update on fake [B,T,61] thetas (step
    1's, detached) and the real bank."""
    disc = state.discriminator.train()
    state.disc_optimizer.zero_grad(set_to_none=True)
    fake_val = disc(fake_motion[:, :, 3:51])
    real_val = disc(real_theta[:, :, 3:51].float())
    d_real, d_fake, total = vl.vibe_discriminator_loss(cfg, real_val,
                                                       fake_val)
    total.backward()
    stats = {"disc_loss": total.detach(), "d_real": d_real.detach(),
             "d_fake": d_fake.detach()}
    if grad_norm:
        stats["disc_grad_norm"] = _grad_norm(disc.parameters())
    state.disc_optimizer.step()
    return stats


def make_adversarial_train_step(
        mano: mano_lib.ManoModel,
        cfg: vl.VIBELossConfig = vl.VIBELossConfig(),
        grad_norms: bool = False
        ) -> Callable[[AdversarialTrainState, Batch],
                      Dict[str, torch.Tensor]]:
    """The fused generator + discriminator update, in place; returns the
    stats (``gen_loss``, ``disc_loss``, ``d_real``, ``d_fake``, the
    generator's parts, and with ``grad_norms`` each side's global
    gradient norm) as device tensors."""

    def train_step(state: AdversarialTrainState, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        fake, stats = generator_step(state, batch, mano, cfg, grad_norms)
        stats.update(discriminator_step(state, fake, batch["real_theta"],
                                        cfg, grad_norms))
        state.step += 1
        return stats

    return train_step
