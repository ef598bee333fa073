"""Geometry (port of ``scat_tpu/ops/geometry.py``): Rodrigues rotations,
weak-perspective projection (reference train.py:112-120), root-centring,
and the label math of the data loaders: pinhole projection, the 2D
rotation affine and its action on joints, and STB's bone-normalised 3D
rescale (reference dataset/rotation.py:7-55, load_STB.py:98-110,257-258).
Batched, branch-free and differentiable, like the JAX functions.

The loader functions take ``xp``, as the JAX ones do: ``torch`` (the
default) for tensors on the device, ``numpy`` for the loaders'
per-sample host work.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def float32_exact(device_type: str):
    """float32 products without TF32 and outside autocast: the JAX
    package's ``Precision.HIGHEST``.  The flag is cuBLAS's own
    (``allow_tf32``), as ``ops/favor.py`` sets it: reading the generic
    matmul precision raises where a caller has set that flag."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


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


def project_points_pinhole(joints_3d, K, xp=torch):
    """Pinhole projection ``[.,N,3] @ K.T``, then the perspective divide
    (reference dataset/load_STB.py:257-258)."""
    uvw = joints_3d @ xp.swapaxes(K, -1, -2)
    return uvw[..., :2] / uvw[..., 2:]


def rotation_matrix_2d(angle_deg, center, xp=torch):
    """cv2.getRotationMatrix2D: the ``[...,2,3]`` affine of a CCW rotation
    by ``angle_deg`` about ``center`` (reference rotation.py:17)."""
    a = xp.deg2rad(angle_deg)
    cos, sin = xp.cos(a), xp.sin(a)
    cx, cy = center[..., 0], center[..., 1]
    # OpenCV: x' = cos*x + sin*y + (1-cos)cx - sin*cy
    r0 = xp.stack([cos, sin, (1 - cos) * cx - sin * cy], -1)
    r1 = xp.stack([-sin, cos, sin * cx + (1 - cos) * cy], -1)
    return xp.stack([r0, r1], -2)


def rotate_joints_2d(joints_2d, M, xp=torch):
    """A 2x3 affine applied to ``[...,N,2]`` joints (reference
    rotation.py:33-34)."""
    ones = xp.ones_like(joints_2d[..., :1])
    homo = xp.concatenate([joints_2d, ones], -1)
    return homo @ xp.swapaxes(M, -1, -2)


def rotate_joints_3d(joints_3d, M, xp=torch):
    """The in-plane 3D rotation of an image affine (reference
    rotation.py:36-45): the 2x2 block with the transposed sign pattern,
    z unchanged; a batched ``[B,2,3]`` M broadcasts over the joints."""
    c = M[..., 0, 0][..., None]
    s = M[..., 0, 1][..., None]
    x, y, z = joints_3d[..., 0], joints_3d[..., 1], joints_3d[..., 2]
    return xp.stack([c * x + s * y, -s * x + c * y, z], -1)


def root_center(joints: torch.Tensor, root_index: int = 1) -> torch.Tensor:
    """Subtract the root joint (index 1, reference hand_net.py:389-393)."""
    return joints - joints[..., root_index:root_index + 1, :]


def rescale_3d_joints_flip(joints_3d, ref_bone_len: float = 0.03058954,
                           xp=torch):
    """STB's label normalisation (reference load_STB.py:98-110): bone 4-5
    pinned to ``ref_bone_len`` meters, x mirrored, root-centred on joint
    1."""
    bone = joints_3d[..., 4, :] - joints_3d[..., 5, :]
    length = xp.linalg.norm(bone, axis=-1, keepdims=True) if xp is np \
        else torch.linalg.norm(bone, dim=-1, keepdim=True)
    scaled = joints_3d * (ref_bone_len / length)[..., None]
    mirror = xp.asarray([-1.0, 1.0, 1.0], dtype=scaled.dtype)
    if xp is torch:
        mirror = mirror.to(scaled.device)
    flipped = scaled * mirror
    return flipped - flipped[..., 1:2, :]
