"""Mesh rendering: a weak-perspective overlay of the MANO hand mesh (the
port's own copy of ``scat_tpu/viz/render.py``).

Reference data_utils/render.py:10-88 (``Renderer``) renders with
pyrender offscreen and trimesh, a weak-perspective camera, three point
lights and an alpha composite over the input image; as shipped it is
broken (``WeakPerspectiveCamera`` is used at render.py:56 and never
defined).  Here, as in the JAX package without pyrender, a
painter's-algorithm rasterizer in numpy with Lambertian shading: the
faces far to near, each filled by cv2, or the vertices splatted where
cv2 is missing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def weak_perspective_project(verts: np.ndarray, cam: np.ndarray,
                             img_size: int = 224) -> np.ndarray:
    """[V,3] and (s, tx, ty) -> [V,2] pixels (reference
    train.py:112-120)."""
    s, tx, ty = cam
    xy = s * (verts[:, :2] + np.array([tx, ty]))
    return xy * (img_size / 2) + img_size / 2


def render_mesh_overlay(image: np.ndarray, verts: np.ndarray,
                        faces: np.ndarray, cam: np.ndarray,
                        color: Tuple[float, float, float] = (0.65, 0.74,
                                                            0.86),
                        alpha: float = 0.9,
                        light_dir=(0.3, 0.3, -1.0)) -> np.ndarray:
    """The mesh drawn over ``image`` (HxWx3 uint8): ``verts`` [V,3] in
    the camera frame (z toward the viewer), ``faces`` [F,3], ``cam`` the
    weak-perspective (s, tx, ty)."""
    img = image.astype(np.float32).copy()
    H, W = img.shape[:2]
    pts = weak_perspective_project(verts, cam, min(H, W))
    tri_pts = pts[faces]                       # [F,3,2]
    tri_z = verts[:, 2][faces].mean(axis=1)    # [F]
    v0, v1, v2 = (verts[faces[:, 0]], verts[faces[:, 1]],
                  verts[faces[:, 2]])
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-9
    light = np.asarray(light_dir, np.float32)
    light = light / np.linalg.norm(light)
    shade = np.clip(np.abs(n @ light), 0.25, 1.0)
    order = np.argsort(tri_z)[::-1]            # far to near
    base = np.asarray(color, np.float32) * 255.0
    overlay = img.copy()
    try:
        import cv2
    except ImportError:  # vertex splats
        ix = np.clip(pts[:, 0].astype(int), 0, W - 1)
        iy = np.clip(pts[:, 1].astype(int), 0, H - 1)
        overlay[iy, ix] = base
    else:
        for fi in order:
            cv2.fillConvexPoly(overlay, tri_pts[fi].astype(np.int32),
                               tuple(float(c) for c in base * shade[fi]))
    out = (1 - alpha) * img + alpha * overlay
    return np.clip(out, 0, 255).astype(np.uint8)


class Renderer:
    """The reference Renderer's surface (render.py:10-88):
    ``__call__(verts, faces, cam, img)``, on the rasterizer above."""

    def __init__(self, resolution: Tuple[int, int] = (224, 224),
                 wireframe: bool = False):
        self.resolution = resolution
        self.wireframe = wireframe

    def __call__(self, verts: np.ndarray, faces: np.ndarray,
                 cam: np.ndarray, img: Optional[np.ndarray] = None,
                 color=(0.65, 0.74, 0.86), alpha: float = 0.9
                 ) -> np.ndarray:
        if img is None:
            img = np.zeros(self.resolution + (3,), np.uint8)
        return render_mesh_overlay(img, np.asarray(verts),
                                   np.asarray(faces), np.asarray(cam),
                                   color, alpha)
