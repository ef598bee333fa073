"""The device rule of the port's entry points: CUDA unless the caller
asks for another device."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None],
                   who: str = "scat_tpu_torch") -> torch.device:
    """``device``, or ``cuda`` when None; raises if that is absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return device
