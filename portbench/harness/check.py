"""The numbers that decide ``correct``: each is a gap between what the
timed path produced and what the plain reference computes from the same
inputs, and each has its limit in the configuration's ``limits``
(set from the readings that ``PERF.md`` lists).

Served answers: for each output (camera, joints_3d, joints_2d) the
largest gap over the compared crops, over the largest departure of the
reference's answers from their mean over those crops (the part of an
answer that depends on the crop); the number is the largest of the
three.

Training: the first step's predictions of the whole batch, as served
answers are compared; the largest relative gap of the first three
steps' losses; and, by the worst leaf, the gap between the program's and the
reference's norm of the first gradient and of the change after three
steps, over the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone under Adam and
are left out of the change (none in the benchmark's configurations, as
PERF.md records)."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

FIELDS = ("camera", "joints_3d", "joints_2d")
STILL_LEAF = 1e-3


def answer_gap(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
               ) -> float:
    """Served answers against the reference's (see the module doc)."""
    worst = 0.0
    for f in FIELDS:
        g = np.asarray(got[f], np.float64)
        w = np.asarray(want[f], np.float64)
        if g.shape != w.shape or not np.isfinite(g).all():
            return math.inf
        signal = np.abs(w - w.mean(axis=0, keepdims=True)).max()
        worst = max(worst, float(np.abs(g - w).max() / max(signal, 1e-30)))
    return worst


def keypoints(pred) -> Dict[str, np.ndarray]:
    """Camera, joints_3d and joints_2d (weak perspective, 224-pixel crop)
    of [B,66] predictions, as numpy."""
    p = np.asarray(pred.cpu(), np.float64)
    cam, j3d = p[:, :3], p[:, 3:66].reshape(-1, 21, 3)
    j2d = cam[:, None, 0:1] * (j3d[..., :2] + cam[:, None, 1:]) * 112 + 112
    return dict(zip(FIELDS, (cam, j3d, j2d)))


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    if len(got) != len(want):
        return math.inf
    gaps = [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               leaves: Sequence[str]) -> Tuple[float, str]:
    """(largest gap of norms, its leaf) over ``leaves``."""
    if not leaves:
        return math.inf, ""
    med = float(np.median([want[k] for k in leaves]))
    worst, at = 0.0, ""
    for k in leaves:
        if k not in got or not math.isfinite(got[k]):
            return math.inf, k
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def moved_leaves(grad_norms: Dict[str, float]) -> list:
    """The leaves whose reference gradient is at least ``STILL_LEAF`` of
    the median leaf's."""
    med = float(np.median(list(grad_norms.values())))
    return sorted(k for k, v in grad_norms.items() if v >= STILL_LEAF * med)


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    """``got``/``want``: {"pred": the first step's [B,66], "losses": [3],
    "grad_norms": {leaf: norm}, "change_norms": {leaf: norm}}."""
    leaves = sorted(want["grad_norms"])
    if set(got["grad_norms"]) != set(leaves):
        return {k: math.inf for k in ("pred", "loss", "grad", "change")}
    grad, _ = worst_leaf(got["grad_norms"], want["grad_norms"], leaves)
    change, _ = worst_leaf(got["change_norms"], want["change_norms"],
                           moved_leaves(want["grad_norms"]))
    return {"pred": answer_gap(keypoints(got["pred"]),
                               keypoints(want["pred"])),
            "loss": loss_gap(got["losses"], want["losses"]),
            "grad": grad, "change": change}
