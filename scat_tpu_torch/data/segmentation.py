"""GrabCut hand segmentation and background inpainting (port of
``scat_tpu/data/segmentation.py``; reference dataset/utils.py:243-322).

GrabCut is seeded with a rectangle about the 2D joints and strokes along
the bones, then the background is Telea-inpainted.  Host-only (cv2,
imported inside the functions), as in the reference: the background
removal experiments run it on frames before they reach the card.
"""

from __future__ import annotations

import numpy as np

# the skeleton's bones, wrist -> each finger (Simple order)
BONES = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
         (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
         (15, 16), (0, 17), (17, 18), (18, 19), (19, 20)]
# the reference seeding's bones, with its (5, 17) palm edge
# (dataset/utils.py:273)
REF_BONES = BONES + [(5, 17)]


def _rgb_array(img) -> np.ndarray:
    return img if isinstance(img, np.ndarray) else np.asarray(
        img.convert("RGB"))


def grabcut(img, gt_joints_2d: np.ndarray, iterations: int = 5,
            margin: int = 15):
    """(image with the background inpainted, foreground mask).  ``img``
    HxWx3 uint8 (or a PIL image), ``gt_joints_2d`` [21,2] pixels."""
    import cv2
    img = _rgb_array(img).copy()
    h, w = img.shape[:2]
    j = np.asarray(gt_joints_2d)
    x0 = int(max(j[:, 0].min() - margin, 0))
    y0 = int(max(j[:, 1].min() - margin, 0))
    x1 = int(min(j[:, 0].max() + margin, w - 1))
    y1 = int(min(j[:, 1].max() + margin, h - 1))
    mask = np.zeros((h, w), np.uint8)
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    rect = (x0, y0, max(x1 - x0, 1), max(y1 - y0, 1))
    cv2.grabCut(img, mask, rect, bgd, fgd, iterations, cv2.GC_INIT_WITH_RECT)
    # definite foreground along the bones (reference utils.py:270-300)
    for a, b in BONES:
        cv2.line(mask, (int(j[a, 0]), int(j[a, 1])),
                 (int(j[b, 0]), int(j[b, 1])), cv2.GC_FGD, 3)
    cv2.grabCut(img, mask, None, bgd, fgd, iterations, cv2.GC_INIT_WITH_MASK)
    fg_mask = np.where((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD),
                       1, 0).astype(np.uint8)
    # Telea-inpaint the background (reference utils.py:305-322)
    bg_mask = ((1 - fg_mask) * 255).astype(np.uint8)
    return cv2.inpaint(img, bg_mask, 3, cv2.INPAINT_TELEA), fg_mask


def grabcut_reference(img, gt_joints_2d: np.ndarray, iterations: int = 5):
    """The reference's grabcut (dataset/utils.py:243-322) as it is, for
    pipelines built on its exact outputs: ``(background_mask [H,W,1],
    inpainted)``, the hand Telea-inpainted out of the original image (a
    background plate) and the mask marking the background.  Its seeding
    differs from ``grabcut``'s: a fixed 10-pixel rectangle with the
    reference's width and height swapped (utils.py:259), wide bone strokes
    that carve definite background, thin ones (width h/25) of definite
    foreground, and the (5, 17) palm bone."""
    import cv2
    img = _rgb_array(img)
    # utils.py:247-251 reverse the channels, then convert RGB to BGR: a
    # double swap, so grabCut runs on the RGB array
    work = cv2.cvtColor(img[:, :, ::-1].copy(), cv2.COLOR_RGB2BGR)
    orig = work.copy()
    h, w = work.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    cv2.grabCut(work, mask, (10, 10, h - 10, w - 10), bgd, fgd, iterations,
                cv2.GC_INIT_WITH_RECT)
    j = np.asarray(gt_joints_2d).reshape(21, 2)
    thin = np.full((h, w), 127, np.uint8)
    wide = np.zeros((h, w), np.uint8)
    for a, b in REF_BONES:
        pa = (int(j[a, 0]), int(j[a, 1]))
        pb = (int(j[b, 0]), int(j[b, 1]))
        cv2.line(thin, pa, pb, (255, 255, 255), int(h / 25))
        cv2.line(wide, pa, pb, (255, 255, 255), int(h / 4))
    mask[wide == 0] = 0    # definite background outside the wide strokes
    mask[thin == 255] = 1  # definite foreground on the bones
    mask, _, _ = cv2.grabCut(work, mask, None, bgd, fgd, iterations,
                             cv2.GC_INIT_WITH_MASK)
    fg = np.where((mask == 2) | (mask == 0), 0, 1).astype(np.uint8)
    inpainted = cv2.inpaint(orig, fg, 3, cv2.INPAINT_TELEA)
    return (1 - fg[:, :, np.newaxis]), inpainted
