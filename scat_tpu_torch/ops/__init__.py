"""Tensor ops of the port: the attention kernel wrapper and geometry."""

import torch

#: The wrappers of the hand-written kernels by name (``counted``): each
#: counts its kernel's launches in ``.launches`` where it launches.
COUNTED: dict = {}


def counted(wrapper):
    """Register ``wrapper`` in ``COUNTED``, its launch counter at 0."""
    wrapper.launches = 0
    COUNTED[wrapper.__name__] = wrapper
    return wrapper


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is float64: the modules
    that compute in float32 whatever the compute dtype keep a float64
    model in float64 (the CPU tests hold the distributed step so)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
