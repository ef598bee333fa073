"""Geometry (port of ``scat_tpu/ops/geometry.py:21-117,170-173``):
Rodrigues rotations, weak-perspective projection (reference
train.py:112-120) and root-centring.  Batched, branch-free and
differentiable, like the JAX functions."""

from __future__ import annotations

import torch


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Unit-normalize quaternions ``[B,4] (w,x,y,z)`` -> rotations
    ``[B,3,3]`` (reference models/mano.py:24-38)."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``[B,3]`` -> rotation matrices ``[B,3,3]`` via
    quaternions, with the reference's ``+1e-8`` inside the norm
    (reference models/mano.py:12-22)."""
    l1norm = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    normalized = theta / l1norm
    half = l1norm * 0.5
    return quat2mat(torch.cat([torch.cos(half),
                               torch.sin(half) * normalized], dim=-1))


def _skew(n: torch.Tensor) -> torch.Tensor:
    """``[B,3] -> [B,3,3]`` cross-product matrices."""
    x, y, z = n.unbind(-1)
    zeros = torch.zeros_like(x)
    rows = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1)
    return rows.reshape(n.shape[:-1] + (3, 3))


def rodrigues_guarded(r: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rodrigues formula with a second-order Taylor form below angle
    ``eps`` (reference models/mano.py:236-267, which switches at 1e-30).
    Branch-free, with guarded intermediates so that the branch not taken
    stays finite and so do its gradients at theta = 0."""
    theta2 = (r * r).sum(dim=-1)
    small = theta2 < eps * eps
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    n = r / theta[..., None]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(
        r.shape[:-1] + (3, 3))
    sin_t = torch.sin(theta)[..., None, None]
    cos_t = torch.cos(theta)[..., None, None]
    # Sn @ Sn == n n^T - I for unit n
    nnT = n[..., :, None] * n[..., None, :]
    exact = cos_t * eye + sin_t * _skew(n) + (1.0 - cos_t) * nnT
    # Taylor form on the unnormalized vector; Sr @ Sr == r r^T - theta^2 I
    rrT = r[..., :, None] * r[..., None, :]
    t2 = theta2[..., None, None]
    taylor = (eye + (1.0 - t2 / 6.0) * _skew(r)
              + (0.5 - t2 / 24.0) * (rrT - t2 * eye))
    return torch.where(small[..., None, None], taylor, exact)


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


def root_center(joints: torch.Tensor, root_index: int = 1) -> torch.Tensor:
    """Subtract the root joint (index 1, reference hand_net.py:389-393)."""
    return joints - joints[..., root_index:root_index + 1, :]
