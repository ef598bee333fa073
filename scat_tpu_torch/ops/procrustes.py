"""Batched orthogonal Procrustes (PA) alignment (port of
``scat_tpu/ops/procrustes.py``; reference eval.py:110-161
``batch_compute_similarity_transform_torch``)."""

from __future__ import annotations

import torch


def similarity_align(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """PA-align ``S1`` (``[B,N,3]`` or ``[B,3,N]``) to ``S2``; returns the
    aligned S1.  Mean-centre, SVD of the cross-covariance K = X1 X2^T,
    det-sign fix on the last singular vector, scale = trace(R K)/var1,
    translate.

    The result does not depend on the SVD's choice of signs: flipping a
    pair (u_i, v_i) leaves both R = V D U^T and det(V U^T) unchanged."""
    transposed = S1.shape[1] not in (2, 3)
    if transposed:
        S1, S2 = S1.transpose(1, 2), S2.transpose(1, 2)
    if S2.shape[1] != S1.shape[1]:
        raise ValueError(f"shapes differ: {tuple(S1.shape)}, "
                         f"{tuple(S2.shape)}")

    mu1 = S1.mean(dim=-1, keepdim=True)
    mu2 = S2.mean(dim=-1, keepdim=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = (X1 ** 2).sum(dim=(1, 2))
    K = X1 @ X2.transpose(1, 2)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(1, 2)
    det = torch.linalg.det(U @ V.transpose(1, 2))
    sign_fix = torch.ones(S1.shape[0], S1.shape[1], dtype=S1.dtype,
                          device=S1.device)
    sign_fix[:, -1] = torch.sign(det)
    R = (V * sign_fix[:, None, :]) @ U.transpose(1, 2)
    scale = (R @ K).diagonal(dim1=1, dim2=2).sum(dim=-1) / var1
    t = mu2 - scale[:, None, None] * (R @ mu1)
    S1_hat = scale[:, None, None] * (R @ S1) + t
    return S1_hat.transpose(1, 2) if transposed else S1_hat
