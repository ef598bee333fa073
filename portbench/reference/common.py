"""What the reference models share: the numerics of products, the norms,
the mean template, the SCAT loss, Adam with the warmup, and the train
loop that follows a program's first steps.

Departures from the program are none in the arithmetic: the program
computes its products in bf16, the reference in float32 (TF32 off), or,
as the control, with each product's operands rounded to float8 e4m3 at
one scale a tensor (the step below bf16 that would tempt a later
change)."""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TEMPLATE = os.path.join(ROOT, "extra_data", "hand.obj")
# the template vertices of the 21 joints (1-based .obj rows), the
# reference's LOCAL_TREE_BACK (train.py:104-109, outside=True)
TREE_BACK = (188, 142, 87, 290, 216, 316, 402, 200, 585, 630, 285,
             473, 513, 88, 249, 702, 329, 439, 668, 550, 740)
FP8_MAX = 448.0   # the largest float8 e4m3 value


class Numerics:
    """The operands of every convolution, Linear and product: float32, or
    rounded to float8 e4m3 at one scale a tensor (``fp8``), with the
    rounding's gradient passed straight through."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        y = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (y - x).detach()

    def conv(self, x, w, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), None, stride, padding)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


F32 = Numerics(False)
FP8 = Numerics(True)


@contextlib.contextmanager
def strict_float32():
    """IEEE float32 products on the card: TF32 off for cuBLAS and cuDNN."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def layer_norm(x, P, key, eps=1e-6):
    return F.layer_norm(x, (x.shape[-1],), P[key + ".weight"],
                        P[key + ".bias"], eps)


def batch_norm(x, P, key, train: bool, eps=1e-5):
    """Training: the batch's statistics (biased variance); else the
    running ones."""
    if train:
        return F.batch_norm(x, None, None, P[key + ".weight"],
                            P[key + ".bias"], True, 0.0, eps)
    return F.batch_norm(x, P[key + ".running_mean"], P[key + ".running_var"],
                        P[key + ".weight"], P[key + ".bias"], False, 0.0, eps)


def mean_template(device) -> torch.Tensor:
    """The 66-dim mean: camera (5, 0, 0), then the template's 21 joint
    vertices, read from the checkout's ``extra_data/hand.obj``."""
    verts = []
    with open(TEMPLATE) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
    v = torch.tensor(verts, dtype=torch.float32)
    joints = v[torch.tensor(TREE_BACK) - 1].reshape(-1)
    return torch.cat([torch.tensor([5.0, 0.0, 0.0]), joints]).to(device)


def uint8_to_unit(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 127.5 - 1.0


def keypoints(pred: torch.Tensor):
    """[B,66] -> (camera [B,3], joints_3d [B,21,3], joints_2d [B,21,2] in
    224-pixel crop coordinates): weak perspective s * (X_xy + t)."""
    cam = pred[:, :3]
    j3d = pred[:, 3:66].reshape(-1, 21, 3)
    j2d = cam[:, None, 0:1] * (j3d[..., :2] + cam[:, None, 1:])
    return cam, j3d, j2d * 112.0 + 112.0


def valid_rows(images: torch.Tensor, threshold: float = 2000.0):
    """1 for a crop that is not blank (its [-1,1] pixel sum further than
    ``threshold`` from +-H*W*3), else 0."""
    content = images.sum(dim=tuple(range(1, images.dim()))).abs()
    return ((content - images[0].numel()).abs() > threshold).float()


def scat_loss(pred, labels, images, w3d: float, w2d: float,
              rows: slice = slice(None)) -> torch.Tensor:
    """w3d * MSE of the 3D joints + w2d * L1 of the 2D pixel joints, each a
    mean over the valid rows' elements of the batch (105-wide labels):
    ``pred`` is the prediction of the batch's ``rows``, and the result
    their share of the batch's loss."""
    _, j3d, j2d = keypoints(pred)
    valid = valid_rows(images)
    count = valid.sum().clamp(min=1.0)
    labels, valid = labels[rows], valid[rows]
    d3 = (j3d.reshape(-1, 63) - labels[:, :63]) ** 2
    d2 = (j2d.reshape(-1, 42) - labels[:, 63:105]).abs()
    l3d = (d3 * valid[:, None]).sum() / (count * 63)
    l2d = (d2 * valid[:, None]).sum() / (count * 42)
    return w3d * l3d + w2d * l2d


class Adam:
    """torch's Adam (betas 0.9, 0.999, eps 1e-8) with the reference's
    warmup: the lr of step k is lr * min((k // steps_per_epoch + 1) / 15,
    1)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 steps_per_epoch: int, b1=0.9, b2=0.999, eps=1e-8):
        self.p, self.lr, self.spe = params, lr, max(steps_per_epoch, 1)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.k = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        lr = self.lr * min((self.k // self.spe + 1) / 15.0, 1.0)
        self.k += 1
        c1, c2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        for name, p in self.p.items():
            g = grads[name]
            self.m[name].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[name].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[name], denom, value=-lr / c1)


def follow_steps(forward_loss: Callable, weights: Dict[str, torch.Tensor],
                 trainable: Callable[[str], bool], batches: Sequence[dict],
                 draws: Sequence[object], lr: float, steps_per_epoch: int,
                 row_blocks: int = 1) -> dict:
    """Follow a program's first ``len(batches)`` train steps from
    ``weights``: each step's loss, the first step's gradient of every
    trainable leaf, and every trainable leaf's change after the last.
    ``forward_loss(P, images, labels, draw, rows)`` gives the loss over
    the batch's ``rows`` (a slice) as a share of the whole batch's, so
    that ``row_blocks`` blocks of rows sum to it (a model without
    BatchNorm), and those rows' prediction; the first step's predictions
    are returned too."""
    P = {k: v.detach().clone() for k, v in weights.items()}
    names = [k for k in P if trainable(k)]
    params = {k: P[k] for k in names}
    adam = Adam(params, lr, steps_per_epoch)
    losses: List[float] = []
    first_grad, first_pred = None, []
    for batch, draw in zip(batches, draws):
        n = batch["image"].shape[0]
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for b in range(row_blocks):
            rows = slice(b * n // row_blocks, (b + 1) * n // row_blocks)
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            loss, pred = forward_loss({**P, **leaves}, batch["image"],
                                      batch["label"], draw, rows)
            if first_grad is None:
                first_pred.append(pred.detach())
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            for k, g in zip(leaves, got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
            for v in params.values():
                v.requires_grad_(False)
        losses.append(total)
        if first_grad is None:
            first_grad = {k: g.norm().item() for k, g in grads.items()}
        adam.step(grads)
    change = {k: (params[k] - weights[k]).norm().item() for k in names}
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change, "pred": torch.cat(first_pred)}
