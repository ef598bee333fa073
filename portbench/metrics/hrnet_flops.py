"""The model FLOPs of one crop's served forward of ``--net
backbone_hrnet`` (``portbench/configs/hrnet.json``), which
``harness/yardstick.forward_flops`` does not know: HRNet-W{c}'s
convolutions, the 3x3 stride-2 reduction to the tokens, the pyramid
(the attention's four Linears and two products, the feed-forward), the
refinements of the 61 MANO parameters and the MANO decode's products;
2 FLOPs a multiply-add, reckoned from shapes (BatchNorm, ReLU, the
upsampling and the softmax are not counted, as in the flagship's
count).  Read by ``mfu.serve.hrnet``; pinned against the port's module
by ``tests/test_portbench_hrnet.py``."""

from __future__ import annotations

from typing import List, Tuple

BOTTLENECKS = 4
BASIC_BLOCKS = 4
# (branches, output branches of each module) of stages 2-4
STAGES = ((2, (2,)), (3, (3, 3, 3, 3)), (4, (4, 4, 1)))
MANO_VERTS, MANO_JOINTS, SHAPES, POSE_FEATURES = 778, 16, 10, 135


def _out(side: int, k: int, stride: int) -> int:
    return (side + 2 * (k // 2) - k) // stride + 1


def _conv(side: int, cin: int, cout: int, k: int, stride: int = 1
          ) -> Tuple[int, int]:
    """(multiply-adds, output side) of a bias-free k x k conv, padding
    k // 2."""
    out = _out(side, k, stride)
    return out * out * cout * cin * k * k, out


def hrnet_macs(size: int, c: int, joints: int) -> Tuple[int, int]:
    """(multiply-adds of HRNet-W``c``'s convolutions at ``size``^2, the
    side of its ``joints``-channel output map)."""
    macs, side = _conv(size, 3, 64, 3, 2)
    m, side = _conv(side, 64, 64, 3, 2)
    macs += m
    cin = 64
    for b in range(BOTTLENECKS):
        macs += side * side * (64 * cin + 64 * 64 * 9 + 256 * 64)
        if b == 0:
            macs += side * side * 256 * cin          # downsample
        cin = 256
    sides: List[int] = [side, _out(side, 3, 2)]
    widths = [c, 2 * c]
    macs += side * side * c * 256 * 9 + sides[1] ** 2 * 2 * c * 256 * 9
    for branches, outputs in STAGES:
        if branches > len(sides):                    # a new branch
            m, s = _conv(sides[-1], widths[-1], 2 * widths[-1], 3, 2)
            macs += m
            sides.append(s)
            widths.append(2 * widths[-1])
        for out in outputs:
            for s, w in zip(sides, widths):
                macs += BASIC_BLOCKS * 2 * s * s * w * w * 9
            for i in range(out):
                for j in range(branches):
                    if j > i:                        # 1x1 up
                        macs += sides[j] ** 2 * widths[i] * widths[j]
                    for k in range(i - j):           # 3x3/2 down
                        cout = widths[j] if k < i - j - 1 else widths[i]
                        macs += sides[j + k + 1] ** 2 * cout * widths[j] * 9
    return macs + side * side * joints * c, side


def pyramid_macs(model: dict, n: int, d: int) -> int:
    """The pyramid over ``n`` tokens of width ``d``: each layer's qkv,
    two attention products and output Linear, and its feed-forward."""
    inner = model["heads"] * model["dim_head"]
    macs = 0
    for i in range(model["depth"]):
        hidden = (d * 3) // 4
        out = 3 if i == model["depth"] - 1 else d // 2
        macs += n * d * 3 * inner + 2 * n * n * inner + n * inner * d
        macs += n * d * hidden + n * hidden * out
        d = out
    return macs


def mano_macs() -> int:
    """The decode of one crop's parameters: blend shapes, joint
    regression, pose correctives, the 15 links of the chain (a 3x3
    rotation and a translation each) and the rest-pose offsets, the
    skinning weights' blend of the 16 transforms (12 numbers each), each
    vertex's transform, and the global rotation of 21 joints and 778
    vertices."""
    v3 = MANO_VERTS * 3
    return (v3 * SHAPES + MANO_JOINTS * v3 + v3 * POSE_FEATURES
            + (MANO_JOINTS - 1) * (27 + 9) + MANO_JOINTS * 9
            + MANO_VERTS * MANO_JOINTS * 12 + MANO_VERTS * 12
            + (21 + MANO_VERTS) * 9)


def forward_flops(config: dict) -> float:
    """FLOPs of one crop's served forward of ``config``."""
    model, size = config["model"], config["image_size"]
    macs, side = hrnet_macs(size, model["hrnet_width"],
                            model["joint_channels"])
    # the map read as tokens_in channels, then the 3x3/2 reduction
    tokens_in = 4 * model["tokens"]
    read_side = int(round((model["joint_channels"] * side * side
                           / tokens_in) ** 0.5))
    m, tok_side = _conv(read_side, tokens_in, model["tokens"], 3, 2)
    macs += m
    macs += pyramid_macs(model, model["tokens"], tok_side * tok_side)
    p = model["mano_params"]
    macs += model["iteration"] * (3 + p) * p
    return 2.0 * (macs + mano_macs())
