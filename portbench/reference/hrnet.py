"""``--net backbone_hrnet`` served as upstream test.py decodes it
(reference hand_net.py:150-213, hrnet.py:147-261, test.py:332-348,
mano.py:280-391) as plain functions of a state_dict in the reference
key layout.

HRNet-W{c} (BatchNorm: the batch's statistics in training, the running
ones in eval; c read from the weights): a stem of two 3x3 stride-2
convolutions, four bottlenecks, then branches of c, 2c, 4c and 8c
channels added one resolution at a time, each stage module four basic
blocks a branch and a fuse that sums every branch into every output
branch (a 1x1 conv, BatchNorm and a nearest upsample going up, chains
of 3x3 stride-2 conv + BatchNorm going down, ReLU after the sum) -> the
final 1x1 conv to 128 channels at the highest resolution -> that map's
NCHW memory read as 512 channels (56x56x128 -> 28x28x512) -> a 3x3
stride-2 conv to 128 tokens (196 wide at 224 px) -> sinusoidal position
encoding -> in training the learned mask token on the drawn tokens ->
the pyramid 196 -> 98 -> 49 -> 3 (``reference.flagship``'s layers) ->
the tokens' mean [B,3] -> ``iteration`` refinements ``pred +=
Linear(3 + 61 -> 61)(cat(feat, pred))`` from ``mean_mano_params.pkl``'s
61-dim mean -> the MANO decode: camera ``pred[:, :3]``, and the 21
joints of the pose ``pred[:, 3:51]`` and shape ``pred[:, 51:61]``:
blend shapes, joint regression, each joint's rotation as the exponential
of its axis-angle's cross-product matrix, the 16-joint chain as
rotations and translations, pose correctives, linear blend skinning,
the global rotation, the five fingertip vertices, joint 1 at the
origin.  [B, 66] out.

Departures: the refinement's Linear is 3 + 61 wide, as flax infers it
and the port builds it; upstream declares it 196 + 61 wide, a shape it
never ran.  The ``mean`` handed to ``forward`` (the flagship's 66-dim
template) is not used.

MANO's arrays are data, read here from the checkout's ``extra_data``
without the port: ``MANO_RIGHT.pkl`` where it exists, else the seeded
stand-in that the repository uses in its place, drawn here from
``hand.obj`` by the same recipe (one ``RandomState(0)`` stream, in the
same order)."""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import (ROOT, F32, TEMPLATE, Numerics, batch_norm,
                              layer_norm)
from reference.flagship import attention, feed_forward, position_encoding

# (stage, modules, branches, output branches of each module)
STAGES = (("stage2", 2, (2,)), ("stage3", 3, (3, 3, 3, 3)),
          ("stage4", 4, (4, 4, 1)))
BOTTLENECKS = 4
BASIC_BLOCKS = 4
FINGERTIPS = (320, 443, 671, 554, 744)   # frankmocap's vertex ids
VERTS, JOINTS = 778, 16
# the checkout's files, which the port reads by default from the
# checkout's root, where the benchmark runs
MEAN_MANO = os.path.join(ROOT, "extra_data", "mean_mano_params.pkl")
MANO_PKL = os.path.join(ROOT, "extra_data", "MANO_RIGHT.pkl")


def conv_bn(P, x, key, train, num, stride=1, relu=True):
    """``key``.0 a bias-free conv (padding k // 2), ``key``.1 BatchNorm."""
    w = P[f"{key}.0.weight"]
    x = batch_norm(num.conv(x, w, stride, w.shape[-1] // 2), P, f"{key}.1",
                   train)
    return F.relu(x) if relu else x


def bottleneck(P, x, key, train, num):
    y = F.relu(batch_norm(num.conv(x, P[f"{key}.conv1.weight"]), P,
                          f"{key}.bn1", train))
    y = F.relu(batch_norm(num.conv(y, P[f"{key}.conv2.weight"], 1, 1), P,
                          f"{key}.bn2", train))
    y = batch_norm(num.conv(y, P[f"{key}.conv3.weight"]), P, f"{key}.bn3",
                   train)
    if f"{key}.downsample.0.weight" in P:
        x = conv_bn(P, x, f"{key}.downsample", train, num, relu=False)
    return F.relu(y + x)


def basic_block(P, x, key, train, num):
    y = F.relu(batch_norm(num.conv(x, P[f"{key}.conv1.weight"], 1, 1), P,
                          f"{key}.bn1", train))
    y = batch_norm(num.conv(y, P[f"{key}.conv2.weight"], 1, 1), P,
                   f"{key}.bn2", train)
    return F.relu(y + x)


def stage_module(P, xs, key, outputs, train, num):
    """Four basic blocks a branch, then every branch j fused into every
    output branch i < ``outputs``."""
    ys = []
    for j, x in enumerate(xs):
        for b in range(BASIC_BLOCKS):
            x = basic_block(P, x, f"{key}.branches.{j}.{b}", train, num)
        ys.append(x)
    fused = []
    for i in range(outputs):
        acc = ys[i]
        for j, y in enumerate(ys):
            f = f"{key}.fuse_layers.{i}.{j}"
            if j > i:     # up: 1x1 conv, BatchNorm, nearest x 2^(j-i)
                y = batch_norm(num.conv(y, P[f"{f}.0.weight"]), P, f"{f}.1",
                               train)
                acc = acc + F.interpolate(y, scale_factor=2 ** (j - i),
                                          mode="nearest")
            elif j < i:   # down: i - j stride-2 3x3 convs
                for k in range(i - j):
                    y = conv_bn(P, y, f"{f}.{k}", train, num, 2,
                                relu=k < i - j - 1)
                acc = acc + y
        fused.append(F.relu(acc))
    return fused


def hrnet(P, x, train: bool, num: Numerics, pre="main_encoder"):
    """The 128-channel map of the highest resolution of NCHW ``x``."""
    x = F.relu(batch_norm(num.conv(x, P[f"{pre}.conv1.weight"], 2, 1), P,
                          f"{pre}.bn1", train))
    x = F.relu(batch_norm(num.conv(x, P[f"{pre}.conv2.weight"], 2, 1), P,
                          f"{pre}.bn2", train))
    for b in range(BOTTLENECKS):
        x = bottleneck(P, x, f"{pre}.layer1.{b}", train, num)
    # transition1: a branch at full resolution and one at half
    xs = [conv_bn(P, x, f"{pre}.transition1.0", train, num),
          conv_bn(P, x, f"{pre}.transition1.1.0", train, num, 2)]
    for s, (stage, branches, outputs) in enumerate(STAGES):
        if s > 0:   # a new branch from the lowest resolution
            xs.append(conv_bn(P, xs[-1],
                              f"{pre}.transition{s + 1}.{branches - 1}.0",
                              train, num, 2))
        for m, out in enumerate(outputs):
            xs = stage_module(P, xs, f"{pre}.{stage}.{m}", out, train, num)
    return num.conv(xs[0], P[f"{pre}.final_layer.weight"]) + \
        P[f"{pre}.final_layer.bias"][None, :, None, None]


def _dense(x) -> np.ndarray:
    return np.asarray(x.todense() if hasattr(x, "todense") else x,
                      dtype=np.float64).astype(np.float32)


def _mano_pkl(path: str) -> dict:
    """MANO_RIGHT.pkl's arrays; each joint's parent from its kinematic
    tree's columns."""
    with open(path, "rb") as f:
        dd = pickle.load(f, encoding="latin1")
    tree = np.asarray(dd["kintree_table"])
    column = {int(tree[1, i]): i for i in range(tree.shape[1])}
    regressor = _dense(dd["J_regressor"])
    return {"v_template": _dense(dd["v_template"]),
            "shapedirs": _dense(dd["shapedirs"]),
            "posedirs": _dense(dd["posedirs"]),
            "J_regressor": regressor.T if regressor.shape[0] == VERTS
            else regressor,
            "weights": _dense(dd["weights"]),
            "hands_mean": _dense(dd["hands_mean"]),
            "parents": (0,) + tuple(column[int(tree[0, i])]
                                    for i in range(1, tree.shape[1]))}


def _mano_stand_in() -> dict:
    """The seeded stand-in: ``hand.obj``'s vertices, blend shapes drawn
    small, each joint a Gaussian average of the vertices about a drawn
    anchor, skinning weights soft over the nearest joints, a drawn mean
    pose."""
    rng = np.random.RandomState(0)
    v = []
    with open(TEMPLATE) as f:
        for line in f:
            if line.startswith("v "):
                v.append([float(t) for t in line.split()[1:4]])
    v = np.asarray(v, dtype=np.float32)
    shapedirs = rng.randn(VERTS, 3, 10).astype(np.float32) * 1e-3
    posedirs = rng.randn(VERTS, 3, 135).astype(np.float32) * 1e-4
    anchor = rng.choice(VERTS, JOINTS, replace=False)
    d2 = np.sum((v[None] - v[anchor][:, None]) ** 2, axis=-1)
    regressor = np.exp(-d2 / 2e-4)
    regressor = (regressor / regressor.sum(1, keepdims=True)).astype(
        np.float32)
    dj = np.sum((v[:, None] - (regressor @ v)[None]) ** 2, axis=-1)
    weights = np.exp(-dj / 1e-3)
    weights /= weights.sum(axis=1, keepdims=True)
    rng.randn(45, 45)   # the PCA basis: drawn, in the stream's order; unused
    return {"v_template": v, "shapedirs": shapedirs, "posedirs": posedirs,
            "J_regressor": regressor,
            "weights": weights.astype(np.float32),
            "hands_mean": (rng.randn(45) * 0.1).astype(np.float32),
            "parents": (0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)}


def _mean_mano() -> np.ndarray:
    """The 61-dim mean: camera scale 5, the pose's 45 local dofs of
    ``mean_mano_params.pkl``'s ``mean_pose[3:48]``, zero global rotation
    and shape (reference eval.py:404-426)."""
    mean = np.zeros((61,), dtype=np.float32)
    mean[0] = 5.0
    with open(MEAN_MANO, "rb") as f:
        pose = np.asarray(pickle.load(f, encoding="latin1")["mean_pose"],
                          dtype=np.float32).reshape(-1)
    mean[6:51] = pose[3:48]
    return mean


@functools.lru_cache(maxsize=None)
def mano_arrays(device: str):
    """MANO's arrays and the 61-dim mean, float32 on ``device``."""
    data = _mano_pkl(MANO_PKL) if os.path.exists(MANO_PKL) \
        else _mano_stand_in()

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    return {"v_template": t(data["v_template"]),
            "shapedirs": t(data["shapedirs"]),          # [778, 3, 10]
            "posedirs": t(data["posedirs"]),            # [778, 3, 135]
            "J_regressor": t(data["J_regressor"]),      # [16, 778]
            "weights": t(data["weights"]),              # [778, 16]
            "hands_mean": t(data["hands_mean"]).reshape(15, 3),
            "parents": data["parents"],
            "mean": t(_mean_mano())}


def rotation(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> [..., 3, 3]: the matrix exponential of its
    cross-product matrix."""
    x, y, z = r.unbind(-1)
    zero = torch.zeros_like(x)
    skew = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1)
    return torch.linalg.matrix_exp(skew.reshape(r.shape[:-1] + (3, 3)))


def mano_joints(M: dict, rot, pose, shape) -> torch.Tensor:
    """The 21 joints [B, 21, 3] of MANO at global rotation ``rot`` [B,3],
    pose ``pose`` [B,45] (added to the mean hand) and shape ``shape``
    [B,10], joint 1 at the origin."""
    b = rot.shape[0]
    v_shaped = M["v_template"] + torch.einsum("vck,bk->bvc", M["shapedirs"],
                                              shape)
    J = torch.einsum("jv,bvc->bjc", M["J_regressor"], v_shaped)
    local = rotation(M["hands_mean"] + pose.reshape(b, 15, 3))  # [B,15,3,3]
    eye = torch.eye(3, device=rot.device)
    v_posed = v_shaped + torch.einsum(
        "vck,bk->bvc", M["posedirs"], (local - eye).reshape(b, 135))
    # the chain: world rotation and translation of each joint, the root
    # unrotated
    R = [eye.expand(b, 3, 3)]
    t = [J[:, 0]]
    for i in range(1, 16):
        p = M["parents"][i]
        R.append(R[p] @ local[:, i - 1])
        t.append(t[p] + (R[p] @ (J[:, i] - J[:, p])[..., None])[..., 0])
    R, t = torch.stack(R, 1), torch.stack(t, 1)       # [B,16,3,3], [B,16,3]
    # skinning: each joint's rigid motion of the rest pose
    shift = t - (R @ J[..., None])[..., 0]
    Rv = torch.einsum("vj,bjxy->bvxy", M["weights"], R)
    tv = torch.einsum("vj,bjx->bvx", M["weights"], shift)
    verts = (Rv @ v_posed[..., None])[..., 0] + tv
    joints = torch.cat([t, verts[:, list(FINGERTIPS)]], dim=1)
    joints = (rotation(rot)[:, None] @ joints[..., None])[..., 0]
    return joints - joints[:, 1:2]


def forward(P, images, model: dict, train: bool, draw=None,
            num: Numerics = F32, mean=None) -> torch.Tensor:
    """[B,66] camera + joints of NHWC float ``images`` in [-1, 1];
    ``draw``, in training, the bool [128] flags of the masked tokens."""
    fmap = hrnet(P, images.permute(0, 3, 1, 2), train, num)
    w = P["conv1x1_channel_reduction.weight"]
    b, c, h, wd = fmap.shape
    side = int(round((c * h * wd / w.shape[1]) ** 0.5))
    fmap = fmap.reshape(b, w.shape[1], side, side)   # NCHW memory, re-read
    tok = num.conv(fmap, w, 2, 1).flatten(2)
    n, d = tok.shape[1:]
    if model["pos_embed"]:
        tok = tok + position_encoding(n, d, tok.device)
    if train and draw is not None:
        tok = torch.where(draw[None, :, None], P["mask_token"], tok)
    depth = model["depth"]
    for i in range(depth):
        key = f"transformer.layers.{i}"
        tok = tok + attention(P, layer_norm(tok, P, f"{key}.0.fn.norm"),
                              f"{key}.0.fn.fn", model["heads"],
                              model["dim_head"], num)
        if i < depth - 1:
            tok = feed_forward(P, layer_norm(tok, P, f"{key}.1.norm"),
                               f"{key}.1.fn", num)
        else:
            tok = feed_forward(P, tok, f"{key}.1", num)
    feat = tok.mean(dim=1)                           # [B,3]
    M = mano_arrays(str(images.device))
    pred = M["mean"].expand(b, 61)
    for _ in range(model["iteration"]):
        pred = pred + F.linear(torch.cat([feat, pred], 1),
                               P["regressor.0.weight"], P["regressor.0.bias"])
    joints = mano_joints(M, pred[:, 3:6], pred[:, 6:51], pred[:, 51:61])
    return torch.cat([pred[:, :3], joints.reshape(b, 63)], dim=1)
