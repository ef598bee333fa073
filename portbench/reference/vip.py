"""``--net ViP`` (reference models/vision_performer.py:12-116) as plain
functions of a state_dict in the reference key layout.

NCHW crop -> p x p patches in (C, ph, pw) order, tokens row-major ->
``patch_emb`` -> + ``pos_emb`` -> ``cls_token`` first -> ``depth`` pre-LN
Performer blocks: LN, each head's slice through the shared ``kqv``
Linear (k, q, v in that order), FAVOR+ with the frozen Gaussian ``w``
(phi(x) = exp(w x - |x|^2 / 2) / sqrt(m); y = phi(q) (phi(k)^T v) /
(phi(q) . sum_t phi(k))), ``proj``, dropout, residual; LN, the 4x GELU
MLP, dropout, residual -> the mean over all tokens -> ``iteration``
refinements ``pred += head(cat(feat, pred))`` from the mean template, no
root-centring.  LayerNorm eps 1e-6, exact GELU, dropout 0.1 applied
with the keep-masks a train step draws (kept entries / 0.9)."""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

from reference.common import F32, Numerics, layer_norm

FROZEN = re.compile(r"^mains\.\d+\.w$")


def trainable(key: str) -> bool:
    return not FROZEN.match(key)


def favor(q, k, v, w, num: Numerics):
    """FAVOR+ over [B,H,T,e] float32 operands."""
    def phi(x):
        wx = num.mm(x, w.t())
        return torch.exp(wx - (x * x).sum(-1, keepdim=True) / 2) \
            / math.sqrt(w.shape[0])
    qp, kp = phi(q), phi(k)
    kptv = num.mm(kp.transpose(-1, -2), v)               # [B,H,m,e]
    d = (qp * kp.sum(dim=-2, keepdim=True)).sum(-1, keepdim=True)
    return num.mm(qp, kptv) / d


def block(P, x, i: int, model: dict, masks, num: Numerics):
    b, t, emb = x.shape
    heads, e = model["heads"], model["emb_s"]
    key = f"mains.{i}"
    y = layer_norm(x, P, f"{key}.ln1").view(b, t, heads, e)
    kqv = num.linear(y, P[f"{key}.kqv.weight"], P[f"{key}.kqv.bias"])
    k, q, v = kqv.permute(0, 2, 1, 3).split(e, dim=-1)
    att = favor(q, k, v, P[f"{key}.w"], num).transpose(1, 2).reshape(b, t, emb)
    att = num.linear(att, P[f"{key}.proj.weight"], P[f"{key}.proj.bias"])
    rate = model["dropout"]
    if masks is not None:
        att = torch.where(masks[0], att / (1 - rate), 0)
    x = x + att
    h = F.gelu(num.linear(layer_norm(x, P, f"{key}.ln2"),
                          P[f"{key}.mlp.0.weight"], P[f"{key}.mlp.0.bias"]))
    h = num.linear(h, P[f"{key}.mlp.2.weight"], P[f"{key}.mlp.2.bias"])
    if masks is not None:
        h = torch.where(masks[1], h / (1 - rate), 0)
    return x + h


def forward(P, images, model: dict, train: bool, draw=None,
            num: Numerics = F32, mean=None) -> torch.Tensor:
    """[B,66] prediction of NHWC float ``images`` in [-1, 1]; ``draw``, in
    training, each block's two dropout keep-masks [B,T,emb]."""
    x = images.permute(0, 3, 1, 2)
    b, c, hgt, wid = x.shape
    p = model["patch"]
    patches = x.reshape(b, c, hgt // p, p, wid // p, p).permute(
        0, 2, 4, 1, 3, 5).reshape(b, (hgt // p) * (wid // p), c * p * p)
    tok = num.linear(patches, P["patch_emb.weight"], P["patch_emb.bias"])
    tok = tok + P["pos_emb"]
    tok = torch.cat([P["cls_token"].expand(b, -1, -1), tok], dim=1)
    for i in range(model["depth"]):
        masks = draw[i] if (train and draw is not None) else None
        tok = block(P, tok, i, model, masks, num)
    feat = tok.mean(dim=1)
    pred = mean[:66].expand(b, 66)
    for _ in range(model["iteration"]):
        pred = pred + F.linear(torch.cat([feat, pred], 1), P["head.weight"],
                               P["head.bias"])
    return pred


def draw(gen: torch.Generator, batch: int, model: dict):
    """Each block's two dropout keep-masks [B,T,emb] one train step draws
    on ``gen`` (uniform draws below 1 - rate), or None without dropout."""
    rate = model["dropout"]
    if rate <= 0:
        return None
    shape = (batch, model["tokens"], model["emb_s"] * model["heads"])
    return [tuple(torch.rand(shape, generator=gen, device=gen.device)
                  < 1.0 - rate for _ in range(2))
            for _ in range(model["depth"])]


def slice_draw(draw, rows: slice):
    if draw is None:
        return None
    return [tuple(m[rows] for m in pair) for pair in draw]
