"""Gaussian heatmaps and their decoding (port of
``scat_tpu/ops/heatmap.py``).

  * ``draw_gaussian_heatmaps``: the CenterNet-style splat
    ``draw_umich_gaussian`` (reference dataset/utils.py:180-202), a
    (2r+1)^2 Gaussian with sigma = diameter/6 at the int-cast centre,
    clipped at the borders, evaluated over the whole grid with a square
    window mask;
  * ``heatmap_to_coords``: the weighted-average decode ``get_ave_xy``
    (reference data_utils/heatmap_coord.py:10-45).
"""

from __future__ import annotations

import torch


def draw_gaussian_heatmaps(centers: torch.Tensor, height: int, width: int,
                           radius: int = 8, k: float = 1.0) -> torch.Tensor:
    """``centers`` [..., J, 2] (x, y) -> heatmaps [..., J, H, W]."""
    sigma = (2 * radius + 1) / 6.0
    # int() in the reference truncates toward zero: floor would move the
    # window one pixel for a centre in (-1, 0)
    cx = torch.trunc(centers[..., 0]).to(torch.int32)
    cy = torch.trunc(centers[..., 1]).to(torch.int32)
    ys = torch.arange(height, device=centers.device)
    xs = torch.arange(width, device=centers.device)
    dy = ys - cy[..., None]                                # [..., J, H]
    dx = xs - cx[..., None]                                # [..., J, W]
    gy = torch.exp(-(dy.float() ** 2) / (2 * sigma * sigma))
    gx = torch.exp(-(dx.float() ** 2) / (2 * sigma * sigma))
    gy = gy * ((dy >= -radius) & (dy <= radius))
    gx = gx * ((dx >= -radius) & (dx <= radius))
    return k * (gy[..., :, None] * gx[..., None, :])


def heatmap_to_coords(heatmaps: torch.Tensor, threshold_rel: float = 0.5
                      ) -> torch.Tensor:
    """[..., J, H, W] -> [..., J, 2] (x, y): the pixels at or above
    ``threshold_rel`` of the map's peak, weighted by their values.  A map
    whose weights sum to about zero gives the reference's (-1, -1)."""
    H, W = heatmaps.shape[-2:]
    peak = heatmaps.amax(dim=(-2, -1), keepdim=True)
    w = torch.where(heatmaps >= threshold_rel * peak, heatmaps,
                    torch.zeros_like(heatmaps))
    ys = torch.arange(H, dtype=torch.float32, device=heatmaps.device)
    xs = torch.arange(W, dtype=torch.float32, device=heatmaps.device)
    raw = w.sum(dim=(-2, -1))
    degenerate = raw.abs() < 1e-8
    denom = torch.where(degenerate, torch.ones_like(raw), raw)
    y = (w.sum(dim=-1) * ys).sum(dim=-1) / denom
    x = (w.sum(dim=-2) * xs).sum(dim=-1) / denom
    return torch.where(degenerate[..., None], torch.full_like(raw, -1.0)[
        ..., None], torch.stack([x, y], dim=-1))
