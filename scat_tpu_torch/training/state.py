"""Train state (port of ``scat_tpu/training/state.py``): the model (its
parameters and BatchNorm statistics), the optimizer, the lr schedule,
the step, the path-length EMA and the generator that draws the token
masks and ViP's dropout masks, in one object, so a checkpoint captures
everything.  The JAX package's ``constants`` (ViP's frozen FAVOR+
projection) are the model's persistent buffers ``mains.{i}.w`` here.

Unlike the JAX package's immutable pytree, the state is updated in
place by the train step, as PyTorch modules and optimizers are."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    pl_mean: torch.Tensor
    step: int = 0
    # under a mesh (parallel/mesh.py): the module the step calls (DDP;
    # the model itself under FSDP), FSDP's gradient reduction that the
    # step calls after the backward, and the mesh
    wrapped: Optional[nn.Module] = None
    reduce_gradients: Optional[Callable[[], None]] = None
    mesh: object = None

    @property
    def forward(self) -> nn.Module:
        """The module of the forward: the DDP wrapper, or the model."""
        return self.model if self.wrapped is None else self.wrapped

    @classmethod
    def create(cls, model: nn.Module, optimizer, scheduler,
               seed: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        return cls(model=model, optimizer=optimizer, scheduler=scheduler,
                   generator=torch.Generator(device).manual_seed(seed),
                   pl_mean=torch.zeros((), device=device))

    def state_dict(self) -> dict:
        """Everything, as tensors and plain values; the model part is the
        reference-keyed state_dict under ``"state_dict"``, so the file
        also loads as a reference ``.pth``.  Under a mesh the model and
        the Adam moments are gathered to the global layout
        (``parallel.mesh.full_state_dict``, ``full_optimizer_state``;
        every rank takes part), so the file loads on any mesh."""
        if self.mesh is not None:
            from scat_tpu_torch.parallel import mesh as mesh_lib
            return {"state_dict": mesh_lib.full_state_dict(self.model),
                    "optimizer": mesh_lib.full_optimizer_state(
                        self.model, self.optimizer),
                    "scheduler": self.scheduler.state_dict(),
                    "generator": self.generator.get_state(),
                    "step": self.step,
                    "pl_mean": self.pl_mean.detach().cpu()}
        return {"state_dict": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "generator": self.generator.get_state(),
                "step": self.step,
                "pl_mean": self.pl_mean}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["state_dict"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.generator.set_state(sd["generator"])
        self.step = int(sd["step"])
        self.pl_mean = sd["pl_mean"].to(self.pl_mean.device)
