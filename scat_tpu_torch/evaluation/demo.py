"""The video demo (port of ``scat_tpu/evaluation/demo.py``; reference
``Trainer.demo``, eval.py:587-786).

Per frame (at most 200): the crop pinned to frame 0's joints
(``crop_hand_ref``, eval.py:89-108: expand 1.5, at least 20 pixels) on
the card -> the forward in eval mode -> the feature-map tiles -> the
acceleration and its error over a sliding 16-frame window -> PCK, AUC
and MPJPE -> the three-panel plot; at the end the video, ``PCK.png`` and
the final MPJPE, ACC and AUC.  The pictures (tiles, plots, video) need
cv2 and matplotlib and are skipped with a message where either is
missing; the metrics never are.

The reference's demo loaders (``MHP_eval``, ``STB_VIBE_demo``,
``ho3d_VIBE_demo``) are missing from its snapshot; their call sites
give the protocol ``seq_len()`` and ``get_sample(i) -> (image, kp_2d,
kp_3d)`` (eval.py:616,634), which ``SequenceLoader`` serves from arrays
and ``data/mhp.MHPSequence`` from an MHP tree.

``DemoRunner(opt, device=None)`` runs on the CUDA device unless the
caller asks for another; weights load from ``--checkpoint_path_eval``
(partially where the file holds part of the model, as the JAX package
loads it: ``utils/checkpoint.load_pth``; or a seeded fresh init for ""),
as the Evaluator loads them, or from an injected ``state_dict``.
"""

from __future__ import annotations

import importlib.util
import os
import time
from typing import Optional

import numpy as np
import torch

from scat_tpu_torch.config import BaseOptions, Options
from scat_tpu_torch.data import preprocess
from scat_tpu_torch.data.common import sibling_root
from scat_tpu_torch.data.prefetch import to_device
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.evaluation.evaluator import save_pck_curve
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models.factory import check_keypoint_head, compute_dtype
from scat_tpu_torch.ops import metrics as metrics_lib
from scat_tpu_torch.ops.geometry import batch_orth_proj_idrot, project_2d
from scat_tpu_torch.utils import checkpoint as ckpt_lib
from scat_tpu_torch.viz import draw

RNGE = np.arange(20, 51, 5)
MAX_FRAMES = 200
ACCEL_WINDOW = 16
# --eval_dataset -> the reference's demo sequence (eval.py:601-614)
DEMO_SEQS = {"MHP": "data_15_cam_1", "STB": "B1Counting", "ho3d": "GPMF11"}


class SequenceLoader:
    """The demo-loader protocol over arrays: ``seq_len()`` and
    ``get_sample(i)``."""

    def __init__(self, images: np.ndarray, joints_2d: np.ndarray,
                 joints_3d: np.ndarray):
        self.images = images
        self.joints_2d = joints_2d
        self.joints_3d = joints_3d

    def seq_len(self) -> int:
        return len(self.images)

    def get_sample(self, i: int):
        return self.images[i], self.joints_2d[i], self.joints_3d[i]


def stb_vibe_demo(seq_name: str, opt: Options) -> SequenceLoader:
    """The ``STB_VIBE_demo`` stand-in (reference eval.py:47): the first
    200 frames of one STB evaluation sequence, in order."""
    from scat_tpu_torch.data import stb as stb_lib
    ds = stb_lib.STBDataset("STB_eval", data_dir=opt.data_dir, batch_size=1,
                            shuffle=False, opt=opt, use_native=False,
                            device="cpu")
    keep = [i for i, p in enumerate(ds.image_paths) if seq_name in p]
    images, j2d, j3d = [], [], []
    for i in keep[:MAX_FRAMES]:
        a, b = ds.sample_labels(i)
        images.append(ds._load_image(ds.image_paths[i]))
        j3d.append(a)
        j2d.append(b)
    return SequenceLoader(np.stack(images), np.stack(j2d), np.stack(j3d))


def ho3d_vibe_demo(seq_name: str, opt: Options) -> SequenceLoader:
    """The ``ho3d_VIBE_demo`` stand-in (reference eval.py:48): the first
    200 frames of one HO-3D training sequence, in order."""
    from scat_tpu_torch.data import ho3d as ho3d_lib
    ds = ho3d_lib.HO3DDataset(sibling_root(opt.data_dir, "HO3D"), "train",
                              batch_size=1, shuffle=False, seed=opt.seed,
                              device="cpu")
    keep = [(r, m) for r, m in ds.samples if seq_name in r][:MAX_FRAMES]
    images, j2d, j3d = [], [], []
    for rgb_path, meta_path in keep:
        label, kp2 = ds.sample_labels(meta_path)
        images.append(ds._load_image(rgb_path))
        j3d.append(label[61:124].reshape(21, 3))
        j2d.append(kp2)
    return SequenceLoader(np.stack(images), np.stack(j2d).astype(np.float32),
                          np.stack(j3d).astype(np.float32))


def demo_loader(eval_set: str, opt: Options):
    """The demo sequence of ``eval_set`` ('STB', 'MHP' or 'ho3d')."""
    if eval_set not in DEMO_SEQS:
        # --eval_dataset frei is legal for the Evaluator but has no video
        # demo sequence (reference eval.py:601-614)
        raise ValueError(f"no demo sequence for eval_set={eval_set!r}; "
                         f"choose one of {sorted(DEMO_SEQS)} or inject a "
                         "loader")
    seq = DEMO_SEQS[eval_set]
    if eval_set == "STB":
        return stb_vibe_demo(seq, opt)
    if eval_set == "ho3d":
        return ho3d_vibe_demo(seq, opt)
    from scat_tpu_torch.data.mhp import mhp_eval
    return mhp_eval(seq, opt)


def pictures_available() -> bool:
    """cv2 and matplotlib, which the tiles, plots and video need."""
    return all(importlib.util.find_spec(m) is not None
               for m in ("cv2", "matplotlib"))


def _auc(pck_curve: np.ndarray) -> float:
    return float(metrics_lib.area_under_curve(
        torch.as_tensor(RNGE / RNGE.max(), dtype=torch.float32),
        torch.as_tensor(pck_curve, dtype=torch.float32)))


class DemoRunner:
    """``DemoRunner(opt).demo(eval_set)`` (reference eval.py:587-786)."""

    def __init__(self, opt: Options, state_dict: Optional[dict] = None,
                 loader=None, image_size: int = 224, device=None):
        self.opt = opt
        self.device = resolve_device(device, "DemoRunner")
        self.image_size = image_size
        self.result_dir = opt.result_dir
        for sub in ("fm", "3d", "img"):
            os.makedirs(os.path.join(self.result_dir, sub), exist_ok=True)
        model, self.mean_params = build_model(opt, image_size)
        check_keypoint_head(model, "DemoRunner")
        if state_dict is None:
            ckpt_lib.load_weights(model, opt.checkpoint_path_eval,
                                  seed=opt.seed)
        else:
            ckpt_lib.load_state_dict(model, state_dict)
        model = model.to(self.device, memory_format=torch.channels_last)
        self.model = model.cast_compute(compute_dtype(opt)).eval()
        self.loader = loader
        self.pictures = pictures_available()

    def _forward(self, crop: torch.Tensor):
        """(feature map [H,W,C] or None, 3D joints [21,3], 2D joints
        [21,2]) on the host: one read a frame."""
        with torch.no_grad():
            pred, fmap = self.model(crop.permute(0, 3, 1, 2))[:2]
            j3d = pred[:, 3:66].reshape(-1, 21, 3)
            j2d = project_2d(batch_orth_proj_idrot(j3d, pred[:, :3]))
        fm = (fmap[0].permute(1, 2, 0)
              if self.pictures and fmap.dim() == 4 else None)
        return [t.float().cpu().numpy() if t is not None else None
                for t in (fm, j3d[0], j2d[0])]

    def _crop(self, img: np.ndarray, kp_2d_ref: np.ndarray) -> torch.Tensor:
        """The frame cropped about frame 0's joints (eval.py:636-641)."""
        dev = self.device
        M, _ = preprocess.crop_hand_affine(
            to_device(kp_2d_ref[None], dev), img.shape[1], img.shape[0],
            self.image_size, expand=1.5, min_size=20.0)
        return preprocess.affine_sample(
            preprocess.normalize_to_unit(to_device(np.array(img[None]),
                                                   dev)),
            M, self.image_size, self.image_size, fill=-1.0)

    def demo(self, eval_set: Optional[str] = None) -> dict:
        """The demo over ``eval_set`` ('STB', 'MHP' or 'ho3d', by default
        ``opt.eval_dataset``); an injected ``loader`` is the sequence, so
        a name beside it is an error."""
        opt = self.opt
        loader = self.loader
        if loader is not None and eval_set is not None:
            raise ValueError("DemoRunner was constructed with an injected "
                             "loader; demo(eval_set=...) would be ignored")
        if loader is None:
            loader = demo_loader(eval_set or opt.eval_dataset, opt)
        if not self.pictures:
            print("cv2 or matplotlib unavailable, skipping the feature-map "
                  "tiles, frame plots and video; the metrics are computed")
        time_seq = min(loader.seq_len(), MAX_FRAMES)
        mpjpe = np.zeros(time_seq)
        pck_all = np.zeros((len(RNGE), 22))
        accelerate_avg = 0.0
        acc_list, tar_list = [], []
        kp_2d_ref = None
        n = 0
        for i in range(time_seq):
            t0 = time.time()
            img, kp_2d, kp_3d = loader.get_sample(i)
            n += 1
            if kp_2d_ref is None:
                kp_2d_ref = np.asarray(kp_2d, np.float32)
            crop = self._crop(img, kp_2d_ref)
            fm, pred_3d, pred_2d = self._forward(crop)
            if fm is not None:
                # inverted grey tiles (eval.py:651-665)
                import cv2
                tiles = 255 - draw.feature_map_tiles(
                    np.clip(fm * 127.5 + 127.5, 0, 255) / 255.0)
                cv2.imwrite(os.path.join(self.result_dir, f"fm/{n:03d}.png"),
                            tiles)
            gt_3d = np.asarray(kp_3d, np.float32).reshape(21, 3)
            # the sliding 16-frame acceleration window (eval.py:679-695)
            if len(acc_list) == ACCEL_WINDOW:
                acc_list.pop(0)
                tar_list.pop(0)
            acc_list.append(pred_3d)
            tar_list.append(gt_3d)
            if len(acc_list) == ACCEL_WINDOW:
                pred_seq = torch.from_numpy(np.stack(acc_list))
                accel = float(metrics_lib.compute_accel(pred_seq).mean()) \
                    * 1000
                print("acceleration: " + str(accel))
                accelerate_avg += accel
                accel_err = float(metrics_lib.compute_error_accel(
                    torch.from_numpy(np.stack(tar_list)), pred_seq).mean()) \
                    * 1000
                print("acceleration error (compare with gt): "
                      + str(accel_err))
            fps = 1.0 / (time.time() - t0)
            print(f"FPS: {fps:.2f}")
            pck = metrics_lib.cal_pck(
                torch.from_numpy(pred_3d)[None], torch.from_numpy(gt_3d)[None],
                tuple(int(r) for r in RNGE),
                flat_compat=opt.compat_pck_flat).numpy()
            pck_all += pck
            print("AUC: {}.".format(_auc(pck[:, -1])))
            print("@50: {}.".format(pck[-1, -1]))
            if self.pictures:
                self._plot_frame(crop[0].float().cpu().numpy(), gt_3d,
                                 pred_3d, pred_2d, n)
            mpjpe[i] = np.sqrt(((pred_3d - gt_3d) ** 2).sum(-1)).mean()
        if self.pictures:
            draw.generate_video(os.path.join(self.result_dir, "3d"),
                                self.result_dir)
        pck_all /= max(n, 1)
        auc = _auc(pck_all[:, -1])
        save_pck_curve(RNGE, pck_all[:, -1],
                       os.path.join(self.result_dir, "PCK.png"))
        print("*** Final Results ***")
        print()
        print("MPJPE: " + str(1000 * mpjpe.mean()))
        print("ACC:" + str(accelerate_avg / time_seq))
        print("AUC: " + str(auc))
        return {"mpjpe_mm": 1000 * mpjpe.mean(),
                "acc": accelerate_avg / time_seq, "auc": auc,
                "frames": time_seq}

    def _plot_frame(self, crop, gt_3d, pred_3d, pred_2d, n):
        """The three panels (ground truth 3D, predicted 3D, the crop with
        the predicted 2D joints) and the raw crop (eval.py:709-742)."""
        import cv2
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        remap = draw.jointsMapSMPLXToSimple
        fig = plt.figure()
        fig.set_size_inches(1500 / fig.dpi, 500 / fig.dpi, forward=True)
        ax1 = fig.add_subplot(131, projection="3d")
        ax2 = fig.add_subplot(132, projection="3d")
        ax3 = fig.add_subplot(133)
        image_save = draw.unnormalize_image(crop)
        ax3.imshow(image_save)
        draw.plot_3d_hand(ax1, gt_3d[remap])
        ax1.set_xlabel("ground truth 3d joints", fontsize=10)
        draw.plot_3d_hand(ax2, pred_3d[remap])
        ax2.set_xlabel("predict 3d joints", fontsize=10)
        draw.plot_2d_hand(ax3, pred_2d[remap], order="uv")
        fig.savefig(os.path.join(self.result_dir, f"3d/gt_pred_{n:03d}.png"))
        cv2.imwrite(os.path.join(self.result_dir, f"img/{n:03d}.png"),
                    image_save[:, :, ::-1])
        plt.close(fig)


def main(argv=None):
    """``scat-tpu-torch-demo`` / ``python -m scat_tpu_torch.demo``: the
    demo of ``--eval_dataset`` (STB, MHP or ho3d), the flow the
    reference's shipped ``__main__`` runs (eval.py:1073-1076)."""
    opt = BaseOptions().parse(argv)
    # as the JAX package's main: every other name runs HO-3D's sequence
    name = {"stb": "STB", "mhp": "MHP"}.get(opt.eval_dataset.lower(), "ho3d")
    DemoRunner(opt).demo(name)


if __name__ == "__main__":
    main()
