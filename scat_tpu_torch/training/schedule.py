"""Learning-rate schedule and optimizer (port of
``scat_tpu/training/schedule.py``).

Reference train.py:60-63: Adam(lr) + StepLR(step_size=10, gamma=1, no
decay) inside GradualWarmupScheduler(multiplier=1, total_epoch=15),
stepped once per epoch with ``epoch+1``: the lr ramps as a staircase
``base * (epoch+1)/15`` for 15 epochs, then stays at ``base``.  As in
the JAX package the schedule is a function of the step, applied per step
(``LambdaLR`` stepped after every optimizer step).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn


def warmup_schedule(steps_per_epoch: int, warmup_epochs: int = 15
                    ) -> Callable[[int], float]:
    """Multiplier of the base lr at a step: ``min(epoch+1, W)/W``."""

    def factor(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return min((epoch + 1.0) / warmup_epochs, 1.0)

    return factor


def make_optimizer(model: nn.Module, base_lr: float, steps_per_epoch: int,
                   warmup_epochs: int = 15, b1: float = 0.9,
                   b2: float = 0.999, freeze_backbone: bool = False,
                   foreach: Optional[bool] = None
                   ) -> Tuple[torch.optim.Adam,
                              torch.optim.lr_scheduler.LambdaLR]:
    """Adam (torch's defaults, reference train.py:60) with the warmup.

    ``freeze_backbone`` is the reference's declared-but-unwired
    ``--freeze`` (config.py:45), as the JAX package wires it: the
    parameters under ``main_encoder`` get no updates (they are left out
    of the optimizer); their BatchNorm statistics still update.
    ``foreach=False``: one parameter at a time (FSDP's sharded and
    replicated parameters cannot meet in one multi-tensor op)."""
    params = [p for name, p in model.named_parameters()
              if not (freeze_backbone and name.startswith("main_encoder."))]
    opt = torch.optim.Adam(params, lr=base_lr, betas=(b1, b2), eps=1e-8,
                           foreach=foreach)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, warmup_schedule(steps_per_epoch, warmup_epochs))
    return opt, sched
