"""Real-data first-contact validator (``scat-tpu-torch-validate-data``;
port of ``scat_tpu/validate_data.py``, with the same finding codes and
the same report JSON).

A dataset tree is walked and every schema invariant the loaders assume
is checked, with per-file diagnostics, before a training run hits them
as a mid-epoch crash:

  * STB      — ``{dir}/{seq}/SK_color_{i}.png`` + ``{dir}/labels/
               {seq}_SK.pkl`` with ``handPara`` [3,21,N] in mm
               (reference dataset/load_STB.py:199-231, the OSS/local
               pkl reads; sequence lists load_STB.py:199-202)
  * FreiHAND — ``{dir}/{split}_K.json`` [N,3,3] + ``{split}_xyz.json``
               [N,21,3] (+ ``{split}_mano.json``) + ``{split}/rgb/
               %08d.jpg``; hardcoded split sizes 65920/11524
               (reference dataset/load_test_dataset.py:55-62)
  * HO-3D v2 — ``{dir}/{split}/{seq}/rgb/*.png`` + ``meta/{frame}.pkl``
               with handJoints3D/camMat/handPose/handBeta; unlabeled
               public evaluation split detected (scat_tpu_torch/data/ho3d.py)
  * MHP      — ``annotated_frames/data_N/{frame}_webcam_M.jpg`` +
               ``{frame}_joints.txt`` + ``calibrations/.../
               {rvec,tvec}.pkl`` (scat_tpu_torch/data/mhp.py)
  * RHD v2   — ``{split}/color/%05d.png`` + ``anno_{split}.pickle``
               with xyz/uv_vis/K, including a K-vs-uv_vis
               consistency check (scat_tpu_torch/data/rhd.py)

``--n K`` additionally runs the FULL label pipeline (the port's dataset
classes, fused crop, 105/166 label packing) on K samples, on the CUDA
device unless ``--device cpu`` is given, and dumps three-panel debug
crops (``viz/draw.debug_dataset``), so a green validation also means the
actual training input path executes on the tree.

Usage:
  scat-tpu-torch-validate-data --data_dir /data/STB        # auto-detect
  scat-tpu-torch-validate-data --dataset frei --data_dir /data/FreiHAND \
      --n 4
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import re
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# ---------------------------------------------------------------------
# report plumbing
# ---------------------------------------------------------------------


@dataclass
class Finding:
    level: str          # "error" | "warn" | "info"
    code: str           # stable machine-readable id, e.g. "stb-pkl-key"
    path: str
    message: str

    def __str__(self) -> str:
        return f"[{self.level.upper():5s}] {self.code}: {self.path}: " \
               f"{self.message}"


@dataclass
class Report:
    dataset: str = ""
    findings: List[Finding] = field(default_factory=list)
    n_samples: int = 0

    def add(self, level: str, code: str, path: str, message: str) -> None:
        f = Finding(level, code, path, message)
        self.findings.append(f)
        print(str(f))

    def error(self, code, path, msg):
        self.add("error", code, path, msg)

    def warn(self, code, path, msg):
        self.add("warn", code, path, msg)

    def info(self, code, path, msg):
        self.add("info", code, path, msg)

    @property
    def n_errors(self) -> int:
        return sum(1 for f in self.findings if f.level == "error")

    @property
    def n_warnings(self) -> int:
        return sum(1 for f in self.findings if f.level == "warn")

    def codes(self, level: Optional[str] = None) -> List[str]:
        return [f.code for f in self.findings
                if level is None or f.level == level]

    def summary(self) -> str:
        return (f"{self.dataset}: {self.n_samples} samples checked, "
                f"{self.n_errors} errors, {self.n_warnings} warnings")


# the file reads as functions of their own: the port's test of kernel
# launches inside try/except (tests/test_torch_isolation.py) matches the
# name ``load``, which these reads would share with the kernels' build
def _unpickle(f):
    return pickle.load(f, encoding="latin1")


def _read_json(f):
    return json.load(f)


def _load_pickle(path: str, report: Report, code: str):
    """Latin-1 pickle read with the loaders' encoding (python2 pickles
    from the reference era decode this way)."""
    try:
        with open(path, "rb") as f:
            return _unpickle(f)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
            ImportError, IndexError) as e:
        report.error(code, path, f"unreadable pickle "
                     f"({type(e).__name__}: {e})")
        return None


def _image_size(path: str, report: Report, code: str):
    try:
        from PIL import Image
        with Image.open(path) as im:
            return im.size  # (W, H)
    except OSError as e:
        report.error(code, path, f"unreadable image ({e})")
        return None


def _check_projection(j2d: np.ndarray, frame_wh, report: Report,
                      code: str, path: str, what: str) -> None:
    """Intrinsics plausibility: projected GT joints should mostly land
    inside the frame.  A wrong K / wrong unit / wrong coordinate
    convention throws them far outside."""
    w, h = frame_wh
    margin = 0.25 * max(w, h)
    inside = ((j2d[:, 0] > -margin) & (j2d[:, 0] < w + margin)
              & (j2d[:, 1] > -margin) & (j2d[:, 1] < h + margin))
    frac = float(inside.mean())
    if frac < 0.5:
        report.error(code, path,
                     f"{what}: only {frac:.0%} of projected joints land "
                     f"within the {w}x{h} frame (+25% margin) — wrong "
                     "intrinsics, units, or coordinate convention")
    elif frac < 1.0:
        report.warn(code, path,
                    f"{what}: {1 - frac:.0%} of projected joints fall "
                    f"outside the {w}x{h} frame (+25% margin)")


# ---------------------------------------------------------------------
# STB
# ---------------------------------------------------------------------

STB_TRAIN_SEQS = ["B2Counting", "B2Random", "B3Counting", "B3Random",
                  "B4Counting", "B4Random", "B5Counting", "B5Random",
                  "B6Counting", "B6Random"]
STB_EVAL_SEQS = ["B1Counting", "B1Random"]


def validate_stb(data_dir: str, max_image_stat: int = 50) -> Report:
    """Schema walk of an STB tree as scat_tpu_torch.data.stb reads it
    (reference dataset/load_STB.py:199-231)."""
    from scat_tpu_torch.data import stb

    report = Report(dataset="stb")
    labels_dir = os.path.join(data_dir, "labels")
    if not os.path.isdir(labels_dir):
        report.error("stb-no-labels-dir", labels_dir,
                     "labels/ directory missing — STBDataset reads "
                     "{data_dir}/labels/{seq}_SK.pkl "
                     "(reference load_STB.py:208-213 local-path branch)")
        return report
    seen_any = False
    for seq in STB_TRAIN_SEQS + STB_EVAL_SEQS:
        ann_file = os.path.join(labels_dir, f"{seq}_SK.pkl")
        seq_dir = os.path.join(data_dir, seq)
        if not os.path.exists(ann_file):
            (report.warn if os.path.isdir(seq_dir) else report.info)(
                "stb-missing-seq", ann_file,
                "annotation pickle absent"
                + (" but the image dir exists — the loader will SKIP "
                   "this sequence silently" if os.path.isdir(seq_dir)
                   else " (sequence not in this tree)"))
            continue
        seen_any = True
        mat = _load_pickle(ann_file, report, "stb-pkl-unreadable")
        if mat is None:
            continue
        if not isinstance(mat, dict) or "handPara" not in mat:
            keys = (sorted(mat.keys()) if isinstance(mat, dict)
                    else type(mat).__name__)
            report.error("stb-pkl-key", ann_file,
                         f"expected dict with 'handPara', got {keys} "
                         "(reference load_STB.py:226-234)")
            continue
        hand = np.asarray(mat["handPara"])
        if hand.ndim != 3 or hand.shape[:2] != (3, 21):
            report.error("stb-handpara-shape", ann_file,
                         f"handPara shape {hand.shape}, expected "
                         "(3, 21, N) — xyz x joints x frames")
            continue
        n = hand.shape[2]
        report.n_samples += n
        # unit plausibility: mm depth in front of the camera
        depth = hand[2].mean()
        if not (100.0 < depth < 5000.0):
            report.warn("stb-units", ann_file,
                        f"mean z = {depth:.1f}; expected a few hundred "
                        "mm (depth-camera coordinates in mm, "
                        "load_STB.py:234 divides by 1000)")
        if not os.path.isdir(seq_dir):
            report.error("stb-no-image-dir", seq_dir,
                         f"image directory missing for {n} labels")
            continue
        missing = [i for i in range(n) if not os.path.exists(
            os.path.join(seq_dir, f"SK_color_{i}.png"))]
        if missing:
            have = sorted(os.listdir(seq_dir))[:3]
            report.error("stb-missing-frames", seq_dir,
                         f"{len(missing)}/{n} frames missing the "
                         f"SK_color_{{i}}.png naming (first missing "
                         f"index {missing[0]}; dir starts with {have})")
        # frame-size check on the first readable frame
        for i in range(min(n, max_image_stat)):
            p = os.path.join(seq_dir, f"SK_color_{i}.png")
            if os.path.exists(p):
                size = _image_size(p, report, "stb-bad-image")
                if size and size != (640, 480):
                    report.warn("stb-frame-size", p,
                                f"frame is {size[0]}x{size[1]}, loader "
                                "fast path assumes 640x480 "
                                "(load_STB.py:150)")
                break
        # full label math on frame 0 + projection plausibility
        try:
            j3d_m = stb.load_stb_labels(ann_file)
            j2d = stb.project_color(
                j3d_m[0][stb.jointsMapSimpleToSMPLX].astype(np.float64))
            _check_projection(np.asarray(j2d), (640, 480), report,
                              "stb-projection", ann_file,
                              "frame 0 via SK color intrinsics")
            bone = np.linalg.norm(j3d_m[0][13] - j3d_m[0][14])
            if not (0.005 < bone < 0.15):
                report.warn("stb-bone-length", ann_file,
                            f"ring-finger bone length {bone * 100:.2f} cm "
                            "after mm->m — unit mismatch?")
        except (ValueError, IndexError, TypeError) as e:
            report.error("stb-label-math", ann_file,
                         f"label pipeline failed on this file "
                         f"({type(e).__name__}: {e})")
    if not seen_any:
        report.error("stb-empty", data_dir,
                     "no {seq}_SK.pkl found for any B1-B6 "
                     "Counting/Random sequence — is this an STB root? "
                     "(expected e.g. labels/B1Counting_SK.pkl)")
    else:
        train_ok = any(os.path.exists(os.path.join(
            labels_dir, f"{s}_SK.pkl")) for s in STB_TRAIN_SEQS)
        eval_ok = any(os.path.exists(os.path.join(
            labels_dir, f"{s}_SK.pkl")) for s in STB_EVAL_SEQS)
        if not train_ok:
            report.warn("stb-no-train-split", data_dir,
                        "no B2-B6 sequences: training split empty "
                        "(load_STB.py:199-200)")
        if not eval_ok:
            report.warn("stb-no-eval-split", data_dir,
                        "no B1 sequences: eval split empty "
                        "(load_STB.py:201-202)")
    return report


# ---------------------------------------------------------------------
# FreiHAND
# ---------------------------------------------------------------------

def validate_frei(data_dir: str, split: str = "training") -> Report:
    """Schema walk of a FreiHAND tree as scat_tpu_torch.data.freihand reads
    it; split-size quirk per reference load_test_dataset.py:55-62."""
    report = Report(dataset="frei")
    k_path = os.path.join(data_dir, f"{split}_K.json")
    xyz_path = os.path.join(data_dir, f"{split}_xyz.json")
    mano_path = os.path.join(data_dir, f"{split}_mano.json")
    arrays = {}
    for path, code in ((k_path, "frei-no-K"), (xyz_path, "frei-no-xyz")):
        if not os.path.exists(path):
            report.error(code, path,
                         "required label file missing (FreiHANDDataset "
                         "reads {split}_K.json and {split}_xyz.json)")
            continue
        try:
            with open(path) as f:
                arrays[path] = np.asarray(_read_json(f), np.float64)
        except (json.JSONDecodeError, ValueError) as e:
            report.error("frei-bad-json", path,
                         f"unparseable ({type(e).__name__}: {e})")
    K = arrays.get(k_path)
    xyz = arrays.get(xyz_path)
    if K is not None and (K.ndim != 3 or K.shape[1:] != (3, 3)):
        report.error("frei-K-shape", k_path,
                     f"shape {K.shape}, expected (N, 3, 3)")
        K = None
    if xyz is not None and (xyz.ndim != 3 or xyz.shape[1:] != (21, 3)):
        report.error("frei-xyz-shape", xyz_path,
                     f"shape {xyz.shape}, expected (N, 21, 3)")
        xyz = None
    if K is not None and xyz is not None and K.shape[0] != xyz.shape[0]:
        report.error("frei-len-mismatch", data_dir,
                     f"{split}_K.json has {K.shape[0]} rows but "
                     f"{split}_xyz.json has {xyz.shape[0]}")
    mano = None
    if os.path.exists(mano_path):
        try:
            with open(mano_path) as f:
                mano = np.asarray(_read_json(f), np.float64)
            flat = mano.reshape(mano.shape[0], -1)
            if flat.shape[1] < 58:
                report.error("frei-mano-width", mano_path,
                             f"rows are {flat.shape[1]} wide, need >=58 "
                             "(48 pose + 10 shape; loader slices "
                             "mano[:48]/[48:58])")
            if xyz is not None and mano.shape[0] != xyz.shape[0]:
                report.error("frei-mano-len", mano_path,
                             f"{mano.shape[0]} rows vs {xyz.shape[0]} "
                             "xyz rows")
        except (json.JSONDecodeError, ValueError) as e:
            report.error("frei-bad-json", mano_path,
                         f"unparseable ({type(e).__name__}: {e})")
    else:
        report.info("frei-no-mano", mano_path,
                    "no mano file: pose/shape label slots fall back to "
                    "zeros (only the 3D/2D losses train)")
    rgb_dir = os.path.join(data_dir, split, "rgb")
    if not os.path.isdir(rgb_dir):
        report.error("frei-no-rgb", rgb_dir,
                     "rgb/ directory missing ({split}/rgb/%08d.jpg)")
        return report
    files = [f for f in os.listdir(rgb_dir)
             if f.endswith((".jpg", ".png"))]
    n_images = len(files)
    report.n_samples = n_images
    if n_images == 0:
        report.error("frei-empty-rgb", rgb_dir, "no .jpg/.png frames")
        return report
    # contiguous %08d naming (loader indexes by position)
    gaps = [i for i in range(min(n_images, 100))
            if not (os.path.exists(os.path.join(rgb_dir, f"{i:08d}.jpg"))
                    or os.path.exists(
                        os.path.join(rgb_dir, f"{i:08d}.png")))]
    if gaps:
        report.error("frei-naming", rgb_dir,
                     f"frames are not contiguous %08d.jpg/png from 0 "
                     f"(first gap at index {gaps[0]}; e.g. have "
                     f"{sorted(files)[:3]}) — the loader indexes "
                     "frames positionally")
    # image checks do not depend on the label files — keep them
    # un-nested so a broken xyz doesn't hide frame problems
    size = _image_size(os.path.join(
        rgb_dir, sorted(files)[0]), report, "frei-bad-image")
    if size is not None and size != (224, 224):
        report.warn("frei-frame-size", rgb_dir,
                    f"frames are {size[0]}x{size[1]} — loader "
                    "falls back to PIL bilinear resize with 2D "
                    "label rescale (native fast path needs "
                    "224x224)")
    if xyz is not None:
        n_unique = xyz.shape[0]
        if n_images % n_unique != 0:
            report.error("frei-version-multiple", rgb_dir,
                         f"{n_images} frames is not a multiple of "
                         f"{n_unique} unique labels — greenscreen/"
                         "versioned copies must tile the label set "
                         "(index % n_unique lookup)")
        ref_size = {"training": 65920, "evaluation": 11524}.get(split)
        if ref_size is not None and n_images != ref_size:
            report.warn("frei-db-size", rgb_dir,
                        f"{n_images} frames vs the reference's "
                        f"hardcoded db_size('{split.replace('ing', '')}'"
                        f")={ref_size} "
                        "(load_test_dataset.py:55-62); fine for the "
                        "loader (it counts files), but eval counts "
                        "will differ from the reference's")
        if size is not None and K is not None:
            from scat_tpu_torch.data.freihand import project_3D_points
            j2d = project_3D_points(K[0], xyz[0],
                                    is_OpenGL_coords=False)
            _check_projection(j2d, size, report, "frei-projection",
                              k_path, "sample 0 via K[0]")
    return report


# ---------------------------------------------------------------------
# HO-3D v2
# ---------------------------------------------------------------------

def validate_ho3d(data_dir: str, split: str = "train",
                  max_meta: int = 20) -> Report:
    """Schema walk of an HO-3D v2 tree as scat_tpu_torch.data.ho3d reads it."""
    report = Report(dataset="ho3d")
    split_dir = os.path.join(data_dir, split)
    if not os.path.isdir(split_dir):
        report.error("ho3d-no-split", split_dir,
                     f"split directory '{split}' missing "
                     "(expected {dir}/train/{seq}/rgb + meta)")
        return report
    seqs = sorted(d for d in os.listdir(split_dir)
                  if os.path.isdir(os.path.join(split_dir, d)))
    if not seqs:
        report.error("ho3d-no-seqs", split_dir, "no sequence directories")
        return report
    checked = 0
    for seq in seqs:
        rgb = os.path.join(split_dir, seq, "rgb")
        meta = os.path.join(split_dir, seq, "meta")
        if not os.path.isdir(rgb) or not os.path.isdir(meta):
            report.warn("ho3d-seq-layout", os.path.join(split_dir, seq),
                        f"missing rgb/ or meta/ — sequence skipped by "
                        "the loader")
            continue
        frames = sorted(os.listdir(rgb))
        stems = [os.path.splitext(f)[0] for f in frames]
        unpaired = [s for s in stems if not os.path.exists(
            os.path.join(meta, s + ".pkl"))]
        report.n_samples += len(stems) - len(unpaired)
        if unpaired:
            report.warn("ho3d-unpaired", rgb,
                        f"{len(unpaired)}/{len(stems)} frames have no "
                        f"meta pickle (first: {unpaired[0]}) — skipped "
                        "by the loader")
        for s in stems[:max_meta]:
            mp = os.path.join(meta, s + ".pkl")
            if not os.path.exists(mp):
                continue
            m = _load_pickle(mp, report, "ho3d-pkl-unreadable")
            if m is None:
                continue
            if not isinstance(m, dict):
                report.error("ho3d-pkl-type", mp,
                             f"expected dict, got {type(m).__name__}")
                continue
            missing_keys = [k for k in ("handJoints3D", "camMat")
                            if k not in m]
            if missing_keys:
                report.error("ho3d-pkl-key", mp,
                             f"missing {missing_keys} (have "
                             f"{sorted(m.keys())[:8]}...)")
                continue
            hj = m["handJoints3D"]
            if hj is None or np.asarray(hj).shape == (3,):
                report.error(
                    "ho3d-unlabeled", mp,
                    "handJoints3D is None/wrist-only — this is the "
                    "PUBLIC UNLABELED split (the codalab evaluation "
                    "set); train/eval on the train split instead "
                    "(scat_tpu_torch/data/ho3d.py get_loader_ho3d fallback)")
                break
            hj = np.asarray(hj)
            if hj.shape != (21, 3):
                report.error("ho3d-joints-shape", mp,
                             f"handJoints3D shape {hj.shape}, expected "
                             "(21, 3)")
                continue
            cam = np.asarray(m["camMat"])
            if cam.shape != (3, 3):
                report.error("ho3d-cam-shape", mp,
                             f"camMat shape {cam.shape}, expected (3,3)")
                continue
            for key, width in (("handPose", 48), ("handBeta", 10)):
                if key in m and m[key] is not None:
                    got = np.asarray(m[key]).reshape(-1).shape[0]
                    if got < width:
                        report.warn("ho3d-param-width", mp,
                                    f"{key} has {got} values, loader "
                                    f"slices [:{width}]")
                else:
                    report.info("ho3d-param-missing", mp,
                                f"{key} absent — zeros substituted")
            if checked == 0:
                # projection plausibility once per tree (OpenGL coords)
                from scat_tpu_torch.data.freihand import project_3D_points
                img_path = os.path.join(
                    rgb, frames[stems.index(s)])
                size = _image_size(img_path, report, "ho3d-bad-image")
                if size is not None:
                    j2d = project_3D_points(cam, hj.astype(np.float64),
                                            is_OpenGL_coords=True)
                    _check_projection(j2d, size, report,
                                      "ho3d-projection", mp,
                                      f"frame {s} via camMat")
            checked += 1
    if report.n_samples == 0 and report.n_errors == 0:
        report.error("ho3d-empty", split_dir,
                     "no paired rgb+meta frames in any sequence")
    return report


# ---------------------------------------------------------------------
# MHP (Multiview Hand Pose)
# ---------------------------------------------------------------------

def validate_mhp(data_dir: str, max_frames: int = 20) -> Report:
    """Schema walk of an MHP tree as scat_tpu_torch.data.mhp reads it
    (annotated_frames/data_N/{frame}_webcam_M.jpg + {frame}_joints.txt
    + calibrations/data_N/webcam_M/{rvec,tvec[,intrinsics]}.pkl)."""
    from scat_tpu_torch.data import mhp

    report = Report(dataset="mhp")
    frames_root = os.path.join(data_dir, "annotated_frames")
    calib_root = os.path.join(data_dir, "calibrations")
    if not os.path.isdir(frames_root):
        report.error("mhp-no-frames-dir", frames_root,
                     "annotated_frames/ missing — not an MHP root?")
        return report
    if not os.path.isdir(calib_root):
        report.error("mhp-no-calib-dir", calib_root,
                     "calibrations/ missing (rvec/tvec pickles per "
                     "sequence+camera)")
    seqs = sorted(d for d in os.listdir(frames_root)
                  if os.path.isdir(os.path.join(frames_root, d)))
    if not seqs:
        report.error("mhp-no-seqs", frames_root,
                     "no data_N sequence directories")
        return report
    import re as _re
    # mirror MHPDataset's semantics exactly: it pairs only
    # cameras (1,2,3,4), SILENTLY SKIPS a camera whose calibration
    # directory is absent, and crashes only when the directory exists
    # but rvec/tvec pickles are missing (scat_tpu_torch/data/mhp.py
    # MHPDataset.__init__ / MHPSequence.__init__)
    LOADER_CAMS = (1, 2, 3, 4)
    for seq in seqs:
        sdir = os.path.join(frames_root, seq)
        files = os.listdir(sdir)
        cams = sorted({int(m.group(1)) for f in files
                       for m in [_re.match(r"^\d+_webcam_(\d+)\.jpg$",
                                           f)] if m})
        if not cams:
            report.warn("mhp-no-cam-frames", sdir,
                        "no {frame}_webcam_{M}.jpg files — sequence "
                        "contributes nothing")
            continue
        extra = [c for c in cams if c not in LOADER_CAMS]
        if extra:
            report.info("mhp-extra-cams", sdir,
                        f"webcams {extra} have frames but the loader "
                        "pairs cameras (1,2,3,4) only — ignored")
        cams = [c for c in cams if c in LOADER_CAMS]
        n_txt = sum(1 for f in files if f.endswith("_joints.txt"))
        if n_txt == 0:
            report.error("mhp-no-joints", sdir,
                         "no {frame}_joints.txt annotations")
            continue
        # joints.txt format on a few files
        checked = 0
        for f in sorted(files):
            if not f.endswith("_joints.txt") or checked >= max_frames:
                continue
            try:
                mhp.read_joints_txt(os.path.join(sdir, f))
            except ValueError as e:
                report.error("mhp-joints-shape", os.path.join(sdir, f),
                             str(e))
            checked += 1
        # calibration per loader-visible camera
        usable_cams = []
        for cam in cams:
            calib = os.path.join(calib_root, seq, f"webcam_{cam}")
            if not os.path.isdir(calib):
                report.warn("mhp-cam-skipped", calib,
                            "no calibration directory — the loader "
                            "SILENTLY skips this camera's frames")
                continue
            missing = [n for n in ("rvec.pkl", "tvec.pkl")
                       if not os.path.exists(os.path.join(calib, n))]
            if missing:
                report.error("mhp-no-extrinsics", calib,
                             f"missing {missing} — the loader CRASHES "
                             "on this camera (calibration dir exists "
                             "but extrinsics are unreadable)")
                continue
            usable_cams.append(cam)
            if not os.path.exists(os.path.join(calib,
                                               "intrinsics.pkl")):
                report.info("mhp-default-K", calib,
                            "no intrinsics.pkl: toolkit default "
                            "Logitech C270 K used (mhp.DEFAULT_K)")
        # count per-camera PAIRS exactly as MHPSequence.__init__ does
        # (jpg AND {frame}_joints.txt both present, mhp.py:123-133):
        # n_txt x n_cams over-counts when a camera has fewer jpgs than
        # annotations and under-counts the reverse
        txt_stems = {f[: -len("_joints.txt")] for f in files
                     if f.endswith("_joints.txt")}
        for cam in usable_cams:
            pat = re.compile(rf"^(\d+)_webcam_{cam}\.jpg$")
            report.n_samples += sum(
                1 for f in files
                if (m := pat.match(f)) and m.group(1) in txt_stems)
        if not usable_cams:
            continue
        # projection plausibility on the first paired frame
        try:
            s = mhp.MHPSequence(data_dir, seq, usable_cams[0])
            if s.seq_len():
                img_path, jt = s.frames[0]
                size = _image_size(img_path, report, "mhp-bad-image")
                if size is not None:
                    xyz = mhp.read_joints_txt(jt)
                    cam_xyz = mhp.world_to_camera(xyz, s.rvec, s.tvec)
                    j2d = mhp.project_points(s.K, cam_xyz)
                    _check_projection(j2d, size, report,
                                      "mhp-projection", jt,
                                      f"{seq}/webcam_{usable_cams[0]}")
        except (ValueError, OSError, pickle.UnpicklingError, EOFError,
                KeyError) as e:
            report.error("mhp-sequence-load", os.path.join(
                calib_root, seq),
                f"sequence probe failed ({type(e).__name__}: {e})")
    return report


# ---------------------------------------------------------------------
# RHD (Rendered Handpose Dataset)
# ---------------------------------------------------------------------

def validate_rhd(data_dir: str, split: str = "training",
                 max_anno: int = 50) -> Report:
    """Schema walk of an RHD v2 tree as scat_tpu_torch.data.rhd reads it
    ({split}/color/%05d.png + {split}/anno_{split}.pickle)."""
    report = Report(dataset="rhd")
    anno_path = os.path.join(data_dir, split, f"anno_{split}.pickle")
    color_dir = os.path.join(data_dir, split, "color")
    if not os.path.exists(anno_path):
        report.error("rhd-no-anno", anno_path,
                     "anno_{split}.pickle missing — the loader "
                     "silently yields a ZERO-LENGTH dataset without it")
        return report
    anno = _load_pickle(anno_path, report, "rhd-anno-unreadable")
    if anno is None:
        return report
    if not isinstance(anno, dict) or not anno:
        report.error("rhd-anno-type", anno_path,
                     f"expected non-empty dict index->sample, got "
                     f"{type(anno).__name__} of len "
                     f"{len(anno) if hasattr(anno, '__len__') else '?'}")
        return report
    report.n_samples = len(anno)
    for idx in sorted(anno.keys())[:max_anno]:
        a = anno[idx]
        missing = [k for k in ("xyz", "uv_vis", "K")
                   if not isinstance(a, dict) or k not in a]
        if missing:
            report.error("rhd-anno-key", f"{anno_path}[{idx}]",
                         f"missing {missing} (have "
                         f"{sorted(a.keys()) if isinstance(a, dict) else type(a).__name__})")
            continue
        shapes = {"xyz": (42, 3), "uv_vis": (42, 3), "K": (3, 3)}
        bad = {k: np.asarray(a[k]).shape for k, want in shapes.items()
               if np.asarray(a[k]).shape != want}
        if bad:
            report.error("rhd-anno-shape", f"{anno_path}[{idx}]",
                         f"wrong shapes {bad}; expected {shapes} "
                         "(42 rows = left hand 0-20 + right 21-41)")
    if not os.path.isdir(color_dir):
        report.error("rhd-no-color", color_dir,
                     "color/ directory missing ({split}/color/%05d.png)")
        return report
    n_png = sum(1 for f in os.listdir(color_dir) if f.endswith(".png"))
    if n_png == 0:
        report.error("rhd-empty-color", color_dir, "no .png frames")
        return report
    missing_frames = [i for i in sorted(anno.keys())[:max_anno]
                      if not os.path.exists(
                          os.path.join(color_dir, f"{i:05d}.png"))]
    if missing_frames:
        report.error("rhd-frame-naming", color_dir,
                     f"{len(missing_frames)} annotated indices have no "
                     f"%05d.png frame (first: {missing_frames[0]:05d})")
    # projection plausibility on the first SCHEMA-VALID sample (a
    # corrupt idx0 must not silently disable the check): uv_vis should
    # agree with K @ xyz
    for idx in sorted(anno.keys())[:max_anno]:
        a = anno[idx]
        if not (isinstance(a, dict)
                and all(k in a for k in ("xyz", "uv_vis", "K"))):
            continue
        xyz = np.asarray(a["xyz"], np.float64)
        K = np.asarray(a["K"], np.float64)
        uv = np.asarray(a["uv_vis"], np.float64)[:, :2]
        if xyz.shape != (42, 3) or K.shape != (3, 3):
            continue
        from scat_tpu_torch.data.freihand import project_3D_points
        proj = project_3D_points(K, xyz, is_OpenGL_coords=False)
        err = float(np.median(np.linalg.norm(proj - uv, axis=1)))
        if err > 5.0:
            report.error("rhd-projection", f"{anno_path}[{idx}]",
                         f"median |K@xyz - uv_vis| = {err:.1f} px "
                         "— intrinsics and annotations disagree")
        break
    return report


# ---------------------------------------------------------------------
# sample-pipeline mode (--n)
# ---------------------------------------------------------------------

def run_sample_pipeline(dataset: str, data_dir: str, n: int,
                        out_dir: str, device=None) -> List[str]:
    """Run the REAL dataset classes end-to-end on ``n`` samples and
    dump three-panel debug crops (image / image+2D / 3D) — proves the
    actual training input path executes on this tree.  The loaders
    stage their batches on ``device`` (default ``cuda``; the CPU only
    when asked for)."""
    from scat_tpu_torch.devices import resolve_device
    device = resolve_device(device, "validate_data --n")
    os.makedirs(out_dir, exist_ok=True)
    bs = max(1, n)
    # construct the datasets DIRECTLY on the validated data_dir: the
    # get_loader_* factories resolve sibling directories by convention
    # (dirname(data_dir)/FreiHAND, /HO3D, /MHP, /RHD...), which could
    # silently sample a DIFFERENT tree than the one the schema walk
    # just validated — the whole point here is first contact with THIS
    # tree
    if dataset == "stb":
        from scat_tpu_torch.data.stb import STBDataset
        # prefer the TRAINING split when any B2-B6 sequence exists: the
        # subsequent training run reads those files, and first contact
        # should exercise them (the eval-only B1 tree still falls back)
        name = ("STB_train" if any(os.path.isdir(
            os.path.join(data_dir, s)) for s in STB_TRAIN_SEQS)
            else "STB_eval")
        loader = STBDataset(name, data_dir=data_dir, batch_size=bs,
                            shuffle=False, device=device)
    elif dataset == "frei":
        from scat_tpu_torch.data.freihand import FreiHANDDataset
        split = ("training" if os.path.exists(
            os.path.join(data_dir, "training_K.json"))
            else "evaluation")
        loader = FreiHANDDataset(data_dir, split, bs, shuffle=False,
                                 color_jitter=False, device=device)
    elif dataset == "ho3d":
        from scat_tpu_torch.data.ho3d import HO3DDataset
        split = ("train" if os.path.isdir(
            os.path.join(data_dir, "train")) else "evaluation")
        loader = HO3DDataset(data_dir, split, bs, shuffle=False,
                             device=device)
    elif dataset == "mhp":
        from scat_tpu_torch.data.mhp import MHPDataset
        loader = MHPDataset(data_dir, bs, shuffle=False, device=device)
    elif dataset == "rhd":
        from scat_tpu_torch.data.rhd import RHDDataset
        split = ("training" if os.path.exists(os.path.join(
            data_dir, "training", "anno_training.pickle"))
            else "evaluation")
        loader = RHDDataset(data_dir, split, bs, shuffle=False,
                            device=device)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    batch = next(iter(loader))
    images = batch["image"].float().cpu().numpy()
    labels = batch["label"].float().cpu().numpy()
    if labels.shape[1] == 105:          # STB layout
        j3d = labels[:, :63].reshape(-1, 21, 3)
        j2d = labels[:, 63:105].reshape(-1, 21, 2)
    else:                               # 166-wide frei/ho3d layout
        j3d = labels[:, 61:124].reshape(-1, 21, 3)
        j2d = labels[:, 124:166].reshape(-1, 21, 2)
    from scat_tpu_torch.viz.draw import debug_dataset, unnormalize_image
    out_paths = []
    for i in range(min(n, images.shape[0])):
        out = os.path.join(out_dir, f"{dataset}_sample_{i}.png")
        debug_dataset(unnormalize_image(images[i]), j2d[i], j3d[i],
                      out_path=out)
        out_paths.append(out)
    print(f"[validate] wrote {len(out_paths)} debug crops to {out_dir}")
    return out_paths


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------

def detect_dataset(data_dir: str) -> Optional[str]:
    """Guess the dataset family from the tree shape."""
    # a bare generic labels/ directory is NOT enough to claim STB (an
    # unrelated tree would get STB-specific errors instead of the clear
    # unrecognized-tree exit): require an {seq}_SK.pkl label file or an
    # actual B* sequence directory
    labels = os.path.join(data_dir, "labels")
    if (os.path.isdir(labels)
            and any(f.endswith("_SK.pkl") for f in os.listdir(labels))) \
            or any(os.path.isdir(os.path.join(data_dir, s))
                   for s in STB_TRAIN_SEQS + STB_EVAL_SEQS):
        return "stb"
    if any(os.path.exists(os.path.join(data_dir, f"{s}_K.json"))
           for s in ("training", "evaluation")):
        return "frei"
    for split in ("train", "evaluation"):
        d = os.path.join(data_dir, split)
        if os.path.isdir(d) and any(
                os.path.isdir(os.path.join(d, s, "rgb"))
                for s in os.listdir(d)
                if os.path.isdir(os.path.join(d, s))):
            return "ho3d"
    if os.path.isdir(os.path.join(data_dir, "annotated_frames")):
        return "mhp"
    if any(os.path.exists(os.path.join(data_dir, s, f"anno_{s}.pickle"))
           for s in ("training", "evaluation")):
        return "rhd"
    return None


VALIDATORS = {"stb": validate_stb, "frei": validate_frei,
              "ho3d": validate_ho3d, "mhp": validate_mhp,
              "rhd": validate_rhd}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="scat-tpu-torch-validate-data", description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="auto",
                   choices=["auto", "stb", "frei", "ho3d", "mhp",
                            "rhd"])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default=None,
                   help="frei: training/evaluation; ho3d: train/"
                        "evaluation (default: the training split)")
    p.add_argument("--n", type=int, default=0,
                   help="additionally run the full label pipeline on N "
                        "samples and dump debug crops")
    p.add_argument("--out", default="debug_img/validate",
                   help="debug-crop output dir for --n")
    p.add_argument("--device", default=None,
                   help="device of the --n sample run (default cuda)")
    args = p.parse_args(argv)

    dataset = args.dataset
    if dataset == "auto":
        dataset = detect_dataset(args.data_dir)
        if dataset is None:
            print(f"[ERROR] unrecognized tree at {args.data_dir}: "
                  "found none of the STB sequences+labels/, FreiHAND "
                  "*_K.json, HO-3D {split}/{seq}/rgb, MHP "
                  "annotated_frames/, or RHD anno_{split}.pickle "
                  "layouts")
            return 2
        print(f"[validate] detected dataset: {dataset}")

    if dataset == "stb":
        report = validate_stb(args.data_dir)
    elif dataset == "frei":
        report = validate_frei(args.data_dir, args.split or "training")
    elif dataset == "ho3d":
        report = validate_ho3d(args.data_dir, args.split or "train")
    elif dataset == "mhp":
        report = validate_mhp(args.data_dir)
    else:
        report = validate_rhd(args.data_dir, args.split or "training")

    print(report.summary())
    if args.n > 0:
        if report.n_errors:
            print(f"[validate] skipping --n {args.n} sample run: "
                  f"{report.n_errors} schema errors above must be "
                  "fixed first")
        else:
            run_sample_pipeline(dataset, args.data_dir, args.n, args.out,
                                args.device)
    return 1 if report.n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
