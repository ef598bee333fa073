"""Fused preprocessing (port of ``scat_tpu/data/preprocess.py``): flip,
rotate, crop, resize and normalise as ONE affine gather per image.

The reference does this per sample with PIL and cv2 in DataLoader
workers (hand_flip load_STB.py:69-74, rotate_img rotation.py:7-55,
crop_hand load_STB.py:76-96, Resize+ToTensor+Normalize load_STB.py:48-67).
Here the geometry composes into one 2x3 affine per sample, and the pixel
work is one batched bilinear gather on the tensors' device.

The affine helpers take ``xp``: ``torch`` (the default) for tensors on
the device, ``numpy`` for the loaders' host work (the native path bakes
the affine into its C++ warp).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from scat_tpu_torch.ops.geometry import rotation_matrix_2d


def _f32(xp, value, like=None):
    """``value`` as a float32 array of ``xp`` (on ``like``'s device)."""
    if xp is torch:
        return torch.as_tensor(value, dtype=torch.float32,
                               device=None if like is None else like.device)
    return np.asarray(value, np.float32)


def affine_compose(A, B, xp=torch):
    """2x3 affines composed, result(x) = A(B(x)); batched [...,2,3]."""
    RA, tA = A[..., :2], A[..., 2]
    RB, tB = B[..., :2], B[..., 2]
    t = xp.einsum("...ij,...j->...i", RA, tB) + tA
    return xp.concatenate([RA @ RB, t[..., None]], -1)


def affine_invert(M, xp=torch):
    """2x3 affines inverted; batched."""
    R, t = M[..., :2], M[..., 2]
    det = R[..., 0, 0] * R[..., 1, 1] - R[..., 0, 1] * R[..., 1, 0]
    inv = xp.stack([
        xp.stack([R[..., 1, 1], -R[..., 0, 1]], -1),
        xp.stack([-R[..., 1, 0], R[..., 0, 0]], -1),
    ], -2) / det[..., None, None]
    ti = -xp.einsum("...ij,...j->...i", inv, t)
    return xp.concatenate([inv, ti[..., None]], -1)


def identity_affine(batch_shape=(), device=None) -> torch.Tensor:
    eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=device)
    return eye.expand(tuple(batch_shape) + (2, 3))


def flip_affine(width, xp=torch):
    """Horizontal mirror x' = width - x (reference hand_flip
    load_STB.py:69-74 maps joints as [w,0] + (-x, y))."""
    w = _f32(xp, width, like=width if xp is torch and
             isinstance(width, torch.Tensor) else None)
    z = xp.zeros_like(w)
    one = xp.ones_like(w)
    return xp.stack([xp.stack([-one, z, w], -1),
                     xp.stack([z, one, z], -1)], -2)


def crop_hand_affine(joints_2d, img_w, img_h, out_size: int = 224,
                     expand: float = 1.3, min_size: float = 10.0,
                     max_size: float = 500.0, center_joint: int = 4,
                     xp=torch):
    """Square crop about joint ``center_joint``, resized to ``out_size``:
    the reference crop_hand (load_STB.py:76-96), half-size =
    clip(expand * max(max_coord - center, center - min_coord), min, max),
    joints remapped by (j - [left, top]) * out / 2s.  Returns (affine
    [B,2,3] input px -> crop px, remapped joints).  ``crop_hand_ref``
    (eval.py:89-108) is this with expand 1.5 and min_size 20."""
    img_w = _f32(xp, img_w, like=joints_2d if xp is torch else None)
    img_h = _f32(xp, img_h, like=joints_2d if xp is torch else None)
    center = joints_2d[..., center_joint, :]
    size_vec = xp.stack([img_w, img_h], -1)
    min_coord = xp.clip(xp.amin(joints_2d, -2), 0.0, None)
    max_coord = xp.minimum(xp.amax(joints_2d, -2), size_vec)
    half = xp.maximum(max_coord - center, center - min_coord)
    half = xp.amax(expand * half, -1)
    half = xp.clip(half, min_size, max_size)
    left = center[..., 0] - half
    top = center[..., 1] - half
    scale = out_size / (2.0 * half)
    z = xp.zeros_like(scale)
    M = xp.stack([xp.stack([scale, z, -left * scale], -1),
                  xp.stack([z, scale, -top * scale], -1)], -2)
    ones = xp.ones_like(joints_2d[..., :1])
    joints_out = xp.einsum("...ij,...nj->...ni", M,
                           xp.concatenate([joints_2d, ones], -1))
    return M, joints_out


def rotate_affine_expand(angle_deg, w, h, xp=torch):
    """Rotation about the image centre with canvas expansion (reference
    rotation.py:7-30): (affine, new_w, new_h).  ``w // 2`` of a float32
    is a floor division, as in the reference's integer centre, and the
    expanded canvas is floored."""
    like = angle_deg if xp is torch else None
    w = _f32(xp, w, like)
    h = _f32(xp, h, like)
    M = rotation_matrix_2d(angle_deg, xp.stack([w // 2, h // 2], -1), xp=xp)
    cos = xp.abs(M[..., 0, 0])
    sin = xp.abs(M[..., 0, 1])
    nW = xp.floor(h * sin + w * cos)
    nH = xp.floor(h * cos + w * sin)
    shift = xp.stack([nW / 2 - w // 2, nH / 2 - h // 2], -1)
    M = xp.concatenate([M[..., :2], (M[..., 2] + shift)[..., None]], -1)
    return M, nW, nH


def affine_sample(images: torch.Tensor, M_out_from_in: torch.Tensor,
                  out_h: int, out_w: int, fill: float = 0.0) -> torch.Tensor:
    """Batched bilinear warp: output[b, y, x] = image[b, M^-1 (x, y)].

    ``images`` [B,H,W,C] float; ``M_out_from_in`` [B,2,3] maps input px to
    output px (the label affine); sampling uses its inverse.  The four
    integer corners are gathered, and a corner outside the image reads
    ``fill`` before the blend (PIL's crop pads with black)."""
    B, H, W, C = images.shape
    device = images.device
    Minv = affine_invert(M_out_from_in.float())
    ys = torch.arange(out_h, dtype=torch.float32, device=device)
    xs = torch.arange(out_w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], -1)   # [oh,ow,3]
    src = torch.einsum("bij,hwj->bhwi", Minv, grid)          # [B,oh,ow,2]
    sx, sy = src[..., 0], src[..., 1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = images.reshape(B, H * W, C)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        vals = vals.reshape(B, out_h, out_w, C)
        return torch.where(valid[..., None], vals,
                           torch.full_like(vals, fill))

    top = gather(y0i, x0i) * (1 - fx) + gather(y0i, x0i + 1) * fx
    bot = gather(y0i + 1, x0i) * (1 - fx) + gather(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def normalize_to_unit(images: torch.Tensor) -> torch.Tensor:
    """Pixels in [0, 255] (uint8 or float) -> [-1, 1] (ToTensor +
    Normalize((.5,.5,.5), (.5,.5,.5)), reference load_STB.py:51-52)."""
    return images.to(torch.float32) / 255.0 * 2.0 - 1.0


def fused_crop_pipeline(images: torch.Tensor, joints_2d: torch.Tensor,
                        flip: bool = True,
                        angle_deg: Optional[torch.Tensor] = None,
                        out_size: int = 224
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flip -> (rotate) -> crop -> resize -> normalise in one gather
    (reference load_STB.py:263-274), with the canvas-expanding rotation
    folded into the crop affine so that shapes stay static."""
    B, H, W, C = images.shape
    device = images.device
    joints_2d = joints_2d.to(device, torch.float32)
    M = (flip_affine(torch.full((B,), float(W), device=device)) if flip
         else identity_affine((B,), device))
    ones = torch.ones_like(joints_2d[..., :1])

    def apply(M):
        return torch.einsum("bij,bnj->bni", M,
                            torch.cat([joints_2d, ones], -1))

    joints = apply(M)
    crop_w = torch.full((B,), float(W), device=device)
    crop_h = torch.full((B,), float(H), device=device)
    if angle_deg is not None:
        # after the canvas-expanding rotation the joints live in the
        # expanded nW x nH frame, and the crop clamps against that canvas
        # (reference crop_hand on the rotated image.size)
        R, nW, nH = rotate_affine_expand(angle_deg.to(device, torch.float32),
                                         W, H)
        M = affine_compose(R, M)
        joints = apply(M)
        crop_w, crop_h = nW, nH
    Mc, joints = crop_hand_affine(joints, crop_w, crop_h, out_size)
    M = affine_compose(Mc, M)
    out = affine_sample(normalize_to_unit(images), M, out_size, out_size,
                        fill=-1.0)
    return out, joints


def crop_frames(frames, joints_2d: np.ndarray, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host frames (uint8 [H,W,3] arrays of one size) of right hands
    uploaded to ``device`` and cropped about their 2D joints, no flip:
    the HO-3D, MHP and RHD loaders' pixel work.  Returns (crops [B,224,
    224,3] in [-1, 1], joints in crop pixels [B,21,2])."""
    from scat_tpu_torch.data.prefetch import to_device
    images = to_device(np.stack(frames), device)
    return fused_crop_pipeline(
        images, to_device(np.asarray(joints_2d, np.float32), device),
        flip=False)


def color_jitter(generator: torch.Generator, images: torch.Tensor,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.1) -> torch.Tensor:
    """ColorJitter over a batch in [-1, 1] NHWC on its device (the
    FreiHAND-style train transform, reference
    load_test_dataset.py:72-79), with torchvision's semantics (see
    ``_jitter_apply``); the op order and the factors are drawn from
    ``generator``, which lives on the images' device."""
    B = images.shape[0]
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return (u * (hi - lo) + lo).to(images.device)

    def factor(name, amt):
        return uniform((B, 1, 1, 1), max(0.0, 1.0 - amt), 1.0 + amt)

    def theta(amt):
        return uniform((B, 1, 1), -amt, amt) * 2 * np.pi

    order = torch.randperm(4, generator=generator, device=dev).tolist()
    return _jitter_apply(torch, images, order, factor, theta, brightness,
                         contrast, saturation, hue)


def _jitter_apply(xp, images, order, factor, theta, brightness, contrast,
                  saturation, hue):
    """torchvision-semantics jitter for the device (``xp=torch``) and the
    loader threads (``xp=np``): factors in [max(0, 1-x), 1+x] (hue in
    [-h, h]), the four ops in ``order`` with a clamp to [0, 1] after each,
    contrast and saturation blended against ITU-R 601 luma; hue as a YIQ
    chroma rotation (the one approximation: torchvision goes through
    HSV).  Callers supply the draws, ``factor(name, amount)`` and
    ``theta(amount)``, so that each keeps its own stream."""

    def luma(x):
        return (0.299 * x[..., 0] + 0.587 * x[..., 1]
                + 0.114 * x[..., 2])[..., None]

    def mean_image(x):
        if xp is torch:
            return x.mean(dim=(1, 2, 3), keepdim=True)
        return x.mean(axis=(1, 2, 3), keepdims=True)

    def do_brightness(x):
        return xp.clip(x * factor("brightness", brightness), 0.0, 1.0)

    def do_contrast(x):
        mean = mean_image(luma(x))
        return xp.clip((x - mean) * factor("contrast", contrast) + mean,
                       0.0, 1.0)

    def do_saturation(x):
        grey = luma(x)
        return xp.clip((x - grey) * factor("saturation", saturation) + grey,
                       0.0, 1.0)

    def do_hue(x):
        if hue <= 0:
            return x
        th = theta(hue)
        y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        i = 0.596 * x[..., 0] - 0.274 * x[..., 1] - 0.322 * x[..., 2]
        q = 0.211 * x[..., 0] - 0.523 * x[..., 1] + 0.312 * x[..., 2]
        ir = i * xp.cos(th) - q * xp.sin(th)
        qr = i * xp.sin(th) + q * xp.cos(th)
        r = y + 0.956 * ir + 0.621 * qr
        g = y - 0.272 * ir - 0.647 * qr
        b = y - 1.106 * ir + 1.703 * qr
        return xp.clip(xp.stack([r, g, b], -1), 0.0, 1.0)

    ops = [do_brightness, do_contrast, do_saturation, do_hue]
    x = (images + 1.0) * 0.5
    for idx in order:
        x = ops[int(idx)](x)
    return x * 2.0 - 1.0


def color_jitter_np(rng: np.random.RandomState, images: np.ndarray,
                    brightness: float = 0.5, contrast: float = 0.5,
                    saturation: float = 0.5, hue: float = 0.1) -> np.ndarray:
    """``color_jitter`` in numpy for loader threads, on a
    ``np.random.RandomState``; ``images`` [B,H,W,3] float in [-1, 1]."""
    B = images.shape[0]

    def factor(name, amt):
        return rng.uniform(max(0.0, 1.0 - amt), 1.0 + amt,
                           size=(B, 1, 1, 1)).astype(np.float32)

    def theta(amt):
        return rng.uniform(-amt, amt, size=(B, 1, 1)).astype(
            np.float32) * 2 * np.pi

    out = _jitter_apply(np, images, rng.permutation(4), factor, theta,
                        brightness, contrast, saturation, hue)
    return out.astype(images.dtype, copy=False)
