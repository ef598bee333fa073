"""The system under test, as the benchmark builds it: the port's model
of a configuration's ``options`` (``scat_tpu_torch``'s own factory), and
the configuration's plain reference."""

from __future__ import annotations

import importlib

import torch


def options(config: dict, seed: int):
    from scat_tpu_torch.config import Options
    return Options(**config["options"], seed=seed)


def build(config: dict, seed: int, device):
    """The port's float32 model of ``config`` on ``device``, channels_last
    as the trainer and the predictor hold it."""
    from scat_tpu_torch.models import build_model
    model, _ = build_model(options(config, seed), config["image_size"])
    return model.to(device, memory_format=torch.channels_last)


def reference(config: dict):
    """The module ``portbench/reference/<config["reference"]>.py``."""
    return importlib.import_module(f"reference.{config['reference']}")
