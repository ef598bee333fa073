"""Written FreiHAND, HO-3D, MHP and RHD trees for the tests (no file of
these datasets is in the repository), beside ``stb_tree.write_stb_tree``:
smooth frames, which encode and decode fast, and labels whose hands
project inside them.  Each writer lays its dataset out under ``root`` as
the loaders find it beside an STB tree at ``root/STB``.  Imports neither
JAX nor the JAX package, so the card tests use it too."""

import json
import os
import pickle

import numpy as np

from stb_tree import _smooth


def _ramp(h, w, k):
    """A frame of gentle ramps, without the steep edges of ``_smooth``'s
    wrap-around."""
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x * 200 // w + k, y * 200 // h + k,
                     (x + y) * 100 // (w + h) + 2 * k], -1).astype(np.uint8)


def _save(img, path, **kw):
    from PIL import Image
    Image.fromarray(img).save(path, **kw)


def write_frei_tree(root, n=8, size=64, seed=0):
    """``root/FreiHAND``: ``training/rgb/%08d.jpg`` frames of ``size`` and
    ``training_{K,xyz,mano}.json``; the hands about 0.5 m away project
    near the frame's centre."""
    rng = np.random.RandomState(seed)
    frei = os.path.join(root, "FreiHAND")
    rgb = os.path.join(frei, "training", "rgb")
    os.makedirs(rgb)
    K = np.tile(np.array([[2.0 * size, 0, size / 2],
                          [0, 2.0 * size, size / 2], [0, 0, 1]]), (n, 1, 1))
    xyz = rng.uniform(-0.04, 0.04, (n, 21, 3)) + np.array([0, 0, 0.5])
    mano = rng.randn(n, 1, 58) * 0.1
    for name, arr in (("K", K), ("xyz", xyz), ("mano", mano)):
        with open(os.path.join(frei, f"training_{name}.json"), "w") as f:
            json.dump(arr.tolist(), f)
    for i in range(n):
        _save(_smooth(size, size, i), os.path.join(rgb, f"{i:08d}.jpg"))
    return frei


def write_ho3d_tree(root, seqs=("ABF10",), frames=4, width=128, height=96,
                    split="train", labeled=True, seed=0):
    """``root/HO3D/{split}/{seq}/{rgb,meta}``: PNG frames and meta pickles
    with MANO-order joints in OpenGL camera coordinates (y up, the hand
    at negative depth) and a camMat that projects them into the frame;
    ``labeled=False`` writes handJoints3D None, as the public evaluation
    split does."""
    rng = np.random.RandomState(seed)
    ho3d = os.path.join(root, "HO3D")
    K = np.array([[float(width), 0, width / 2], [0, float(width), height / 2],
                  [0, 0, 1]])
    for s, seq in enumerate(seqs):
        rgb = os.path.join(ho3d, split, seq, "rgb")
        meta_dir = os.path.join(ho3d, split, seq, "meta")
        os.makedirs(rgb)
        os.makedirs(meta_dir)
        for i in range(frames):
            xyz = rng.uniform(-0.05, 0.05, (21, 3)) + np.array([0, 0, -0.55])
            meta = {"handJoints3D": xyz if labeled else None,
                    "handPose": rng.randn(48) * 0.1,
                    "handBeta": rng.randn(10) * 0.05, "camMat": K}
            with open(os.path.join(meta_dir, f"{i:04d}.pkl"), "wb") as f:
                pickle.dump(meta, f)
            _save(_smooth(height, width, 10 * s + i),
                  os.path.join(rgb, f"{i:04d}.png"))
    return ho3d


def write_mhp_tree(root, seq="data_15", cams=(1,), frames=4, width=128,
                   height=96, intrinsics=True, seed=0, frame=_smooth):
    """``root/MHP``: ``annotated_frames/{seq}/{i}_webcam_{c}.jpg`` and
    ``{i}_joints.txt`` (world millimetres, rows led by the joint index),
    ``calibrations/{seq}/webcam_{c}/{rvec,tvec}.pkl`` and, with
    ``intrinsics``, an ``intrinsics.pkl`` that projects the hands into
    the frame (else the loader's DEFAULT_K); ``frame(h, w, k)`` draws
    the frames."""
    rng = np.random.RandomState(seed)
    mhp = os.path.join(root, "MHP")
    frames_dir = os.path.join(mhp, "annotated_frames", seq)
    os.makedirs(frames_dir)
    for cam in cams:
        calib = os.path.join(mhp, "calibrations", seq, f"webcam_{cam}")
        os.makedirs(calib)
        values = {"rvec": rng.randn(3).astype(np.float32) * 0.05,
                  "tvec": np.array([0, 0, 50.0 * cam], np.float32)}
        if intrinsics:
            values["intrinsics"] = np.array(
                [[float(width), 0, width / 2], [0, float(width), height / 2],
                 [0, 0, 1]], np.float32)
        for name, value in values.items():
            with open(os.path.join(calib, f"{name}.pkl"), "wb") as f:
                pickle.dump(value, f)
    for i in range(frames):
        for cam in cams:
            _save(frame(height, width, i + 10 * cam),
                  os.path.join(frames_dir, f"{i}_webcam_{cam}.jpg"))
        joints = rng.randn(21, 3) * 30.0 + np.array([0, 0, 600.0])
        with open(os.path.join(frames_dir, f"{i}_joints.txt"), "w") as f:
            for j, (x, y, z) in enumerate(joints):
                f.write(f"{j} {x} {y} {z}\n")
    return mhp


def write_rhd_tree(root, n=4, size=64, split="training", seed=0):
    """``root/RHD_published_v2/{split}``: ``color/%05d.png`` and
    ``anno_{split}.pickle`` ({'xyz' [42,3] m, 'uv_vis' [42,3], 'K'}); odd
    frames show only the right hand, even ones both."""
    rng = np.random.RandomState(seed)
    rhd = os.path.join(root, "RHD_published_v2")
    color = os.path.join(rhd, split, "color")
    os.makedirs(color)
    anno = {}
    for i in range(n):
        _save(_smooth(size, size, i), os.path.join(color, f"{i:05d}.png"))
        xyz = rng.randn(42, 3) * 0.03 + np.array([0, 0, 0.6])
        uv = rng.uniform(0.2 * size, 0.8 * size, (42, 2))
        vis = np.ones((42, 1))
        if i % 2:
            vis[:21] = 0.0
        anno[i] = {"xyz": xyz.astype(np.float32),
                   "uv_vis": np.concatenate([uv, vis], 1).astype(np.float32),
                   "K": np.eye(3, dtype=np.float32)}
    with open(os.path.join(rhd, split, f"anno_{split}.pickle"), "wb") as f:
        pickle.dump(anno, f)
    return rhd
