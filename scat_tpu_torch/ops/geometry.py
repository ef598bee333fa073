"""Weak-perspective projection (port of
``scat_tpu/ops/geometry.py:104-117``, reference train.py:112-120)."""

from __future__ import annotations

import torch


def batch_orth_proj_idrot(X: torch.Tensor, camera: torch.Tensor
                          ) -> torch.Tensor:
    """``X`` [B,N,3] joints, ``camera`` [B,3] = (scale s, tx, ty) ->
    [B,N,2] = ``s * (X_xy + t)``."""
    camera = camera.reshape(-1, 1, 3)
    return camera[..., 0:1] * (X[..., :2] + camera[..., 1:])


def project_2d(joints_2d: torch.Tensor, half: float = 112.0
               ) -> torch.Tensor:
    """Normalized [-1,1] coordinates -> 224-pixel crop coordinates."""
    return joints_2d * half + half
