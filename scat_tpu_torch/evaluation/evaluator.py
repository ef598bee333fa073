"""The evaluation loop (port of ``scat_tpu/evaluation/evaluator.py``),
the reference ``eval.py`` benchmark flow (Trainer.eval, eval.py:788-1053).

Per batch: forward in eval mode, projection, PA-Procrustes, the PCK at
20..50 mm, the batch's AUC and an FPS print, the per-sample MPJPE (one
host read of the metrics a batch); at the end the PCK averaged over the
batches, its AUC, ``PCK.png``, the MPJPE and AUC prints, and
``{result_dir}/eval_metrics.csv``.

``Evaluator(opt, device=None).eval()`` runs on the CUDA device unless
the caller asks for another (the tests pass ``device="cpu"``).  The
model is built with ``for_keypoints=True``, as the JAX package's is:
``--net frankmocap`` evaluates through ``H3DWJointsEncoder`` (its MANO
decode in the forward); the 61-dim 128-token heads are refused.  Weights
come from ``--checkpoint_path_eval`` (a reference-keyed ``.pth``, loaded
as the JAX package loads it, ``utils/checkpoint.load_pth``: a partial
file warns, a ViP file carries its frozen ``mains.{i}.w``) or from an
injected ``state_dict``.  With ``--net reg_transformer_coarse --debug
True`` each batch also writes the attention dump (reference
eval.py:834,864-944): the last layer's head-0 attention of the batch's
sample 1 (sample 0 in a batch of one), drawn per finger about its
ground-truth 2D landmarks as ``{result_dir}/attn/{finger}/NNN.png``; the
attention comes from the batch's one forward, and where cv2 is missing
the dump is skipped with a message.  ``--tensorboard True`` mirrors
``eval_metrics.csv`` as tensorboardX events under ``{result_dir}/tb``.

Under ``torchrun`` (one process a device, ``--mesh_shape``;
``parallel/mesh.py``) every rank evaluates its rows of the ``data``
axis (a loader reads only those, ``data/common``; of an injected
dataset's global batch the rank takes them), and the Procrustes-aligned
joints, labels and valid flags are gathered (JAX ``evaluator.py:127-128,
177-185``), so the per-batch PCK,
the per-sample MPJPE and the final numbers are those of the global batch
on every rank, computed once; process 0 prints, logs and draws.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from scat_tpu_torch.config import BaseOptions, Options
from scat_tpu_torch.data.prefetch import map_batch, prefetch_to_device, \
    to_device
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models.factory import check_keypoint_head, compute_dtype
from scat_tpu_torch.ops import metrics as metrics_lib
from scat_tpu_torch.parallel import mesh as mesh_lib
from scat_tpu_torch.training import steps
from scat_tpu_torch.training.trainer import make_dataset
from scat_tpu_torch.utils import checkpoint as ckpt_lib
from scat_tpu_torch.utils.logging import MetricsLogger

RNGE = np.arange(20, 51, 5)


def save_pck_curve(rnge: np.ndarray, pck_curve: np.ndarray, path: str):
    """PCK.png (reference eval.py:1031-1047); skipped, with a message,
    where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"matplotlib unavailable, skipping PCK.png: {e}")
        return
    plt.figure(figsize=(7, 7))
    plt.plot(rnge, pck_curve, label="PCK", linewidth=2)
    plt.xlim(20, 50)
    plt.xticks(np.arange(20, 51, 5))
    plt.yticks(np.arange(0, 101.0, 10.0))
    plt.ylabel("Detection rate, %")
    plt.xlabel("Error Thresholds (mm)")
    plt.grid()
    legend = plt.legend(loc=4)
    legend.get_frame().set_facecolor("white")
    plt.savefig(path)
    plt.close()


def _auc(pck_curve: np.ndarray) -> float:
    x = torch.as_tensor(RNGE / RNGE.max(), dtype=torch.float32)
    return float(metrics_lib.area_under_curve(
        x, torch.as_tensor(pck_curve, dtype=torch.float32)))


class Evaluator:
    """``Evaluator(opt).eval(eval_dataset)``, the reference eval
    surface."""

    def __init__(self, opt: Options, image_size: int = 224,
                 dataset: Optional[Iterable] = None,
                 state_dict: Optional[dict] = None, device=None):
        self.opt = opt
        self.device = resolve_device(device, "the Evaluator")
        self.mesh = mesh_lib.make_mesh(mesh_lib.mesh_axes(opt),
                                       device_type=self.device.type)
        if self.mesh is not None and self.device.type == "cuda":
            self.device = mesh_lib.rank_device("cuda")
        self.is_main = mesh_lib.is_main_process()
        self.batch_size = opt.batch_size
        self.result_dir = opt.result_dir
        os.makedirs(self.result_dir, exist_ok=True)
        model, self.mean_params = build_model(opt, image_size,
                                              for_keypoints=True)
        check_keypoint_head(model, "the Evaluator")
        if state_dict is None:
            ckpt_lib.load_weights(model, opt.checkpoint_path_eval,
                                  seed=opt.seed)
        else:
            ckpt_lib.load_state_dict(model, state_dict)
        model = model.to(self.device, memory_format=torch.channels_last)
        self.model = model.cast_compute(compute_dtype(opt)).eval()
        self.dataset = dataset
        self.want_attn = opt.net == "reg_transformer_coarse" and opt.debug
        self.draw_attn = (self.want_attn
                          and importlib.util.find_spec("cv2") is not None)
        self.eval_step = steps.make_eval_step(
            self.model, pck_range=tuple(int(r) for r in RNGE),
            flat_compat=opt.compat_pck_flat, return_attn=self.want_attn)

    def _eval_global(self, batch: dict) -> dict:
        """The eval step under a mesh on this rank's rows (a loader's
        batch, or its rows of an injected global batch), then the aligned
        joints, labels and valid flags of every rank gathered and the
        metrics of the global batch."""
        group = self.mesh.data_group
        if self.dataset is None:
            n = batch["label"].shape[0] * self.mesh.size("data")
        else:
            n = batch["label"].shape[0]
            batch = mesh_lib.shard_batch(self.mesh, batch)
        valid = batch.get("valid")
        if valid is None:
            valid = metrics_lib.valid_sample_mask(batch["image"])
        out = self.eval_step(batch)
        aligned, label, valid = (
            mesh_lib.gather_rows(group, t)[:n]
            for t in (out["pred_joints_3d"], batch["label"], valid.float()))
        pck, err = steps.keypoint_metrics(
            aligned, label, valid,
            pck_range=tuple(int(r) for r in RNGE),
            flat_compat=self.opt.compat_pck_flat)
        return dict(out, pck=pck, mpjpe_per_sample=err, valid=valid,
                    pred_joints_3d=aligned)

    def _maybe_dump_attention(self, batch: dict, out: dict, n: int) -> None:
        """The coarse head's attention dump of batch ``n`` (the JAX
        package's ``evaluator.py:99-134``): one sample's [H,N,N] and its
        label row reach the host."""
        if not self.draw_attn or not self.is_main:
            return
        attn = out["attn"]
        idx = min(1, attn.shape[0] - 1)   # the reference samples index 1
        label = batch["label"][idx].float().cpu().numpy()
        gt_lmk = (label[63:] if label.shape[0] == 105
                  else label[124:]).reshape(21, 2)
        from scat_tpu_torch.viz.draw import save_attention_maps
        save_attention_maps(attn[idx].float().cpu().numpy(), gt_lmk,
                            self.result_dir, n)

    def eval(self, eval_dataset: Optional[str] = None) -> dict:
        """Evaluate on ``eval_dataset`` ('STB', 'frei' or 'ho3d'), by
        default ``opt.eval_dataset``.  An injected
        ``dataset`` is the data: a name beside it is an error."""
        if self.dataset is not None:
            if eval_dataset is not None:
                raise ValueError(
                    "Evaluator was constructed with an injected dataset; "
                    "eval(eval_dataset=...) would be ignored")
            loader = self.dataset
        else:
            opt = (self.opt if eval_dataset is None
                   else dataclasses.replace(self.opt,
                                            eval_dataset=eval_dataset))
            loader = prefetch_to_device(
                make_dataset(opt, 224, training=False, device=self.device),
                self.device)
        if self.want_attn and not self.draw_attn:
            print("cv2 unavailable, skipping the attention dump; the "
                  "metrics are computed")
        main = self.is_main
        logger = MetricsLogger(self.result_dir if main else None,
                               filename="eval_metrics.csv",
                               tensorboard=self.opt.tensorboard)
        n_cols = len(RNGE) * 22
        pck_all = np.zeros((len(RNGE), 22))
        mpjpe_chunks = []
        n = 0
        for batch in loader:
            n += 1
            t0 = time.time()
            batch = map_batch(batch, lambda t: to_device(t, self.device))
            if self.mesh is None:
                out = self.eval_step(batch)
            else:
                out = self._eval_global(batch)
            self._maybe_dump_attention(batch, out, n)
            # the one host read of the batch: PCK, per-sample MPJPE, valid
            host = torch.cat([out["pck"].reshape(-1).float(),
                              out["mpjpe_per_sample"].float(),
                              out["valid"].float()]).cpu().numpy()
            pck = host[:n_cols].reshape(len(RNGE), 22).astype(np.float64)
            err, valid = np.split(host[n_cols:], 2)
            valid = valid.astype(bool)
            fps = self.batch_size / (time.time() - t0)
            pck_all += pck
            auc = _auc(pck[:, -1])
            if main:
                print(f"FPS: {fps:.2f}")
                print("AUC: {}.".format(auc))
                print("@50: {}.".format(pck[-1, -1]))
            logger.log(n, {"fps": fps, "auc": auc, "pck_at_50": pck[-1, -1],
                           "mpjpe_mm": (1000 * err[valid].mean()
                                        if valid.any() else float("nan"))})
            mpjpe_chunks.append(err[valid])
        pck_all /= max(n, 1)
        errs = (np.concatenate(mpjpe_chunks) if mpjpe_chunks
                else np.zeros((0,), np.float32))
        mpjpe_mean = float(errs.mean()) if errs.size else 0.0
        auc = _auc(pck_all[:, -1])
        if main:
            save_pck_curve(RNGE, pck_all[:, -1],
                           os.path.join(self.result_dir, "PCK.png"))
            print("*** Final Results ***")
            print()
            print("MPJPE: " + str(1000 * mpjpe_mean))
            print("AUC: " + str(auc))
        logger.log(n, {"fps": float("nan"), "auc": auc,
                       "pck_at_50": pck_all[-1, -1],
                       "mpjpe_mm": 1000 * mpjpe_mean})
        logger.close()
        return {"mpjpe_mm": 1000 * mpjpe_mean, "auc": auc, "pck": pck_all}


def main(argv=None):
    opt = BaseOptions().parse(argv)
    Evaluator(opt).eval(eval_dataset=opt.eval_dataset)


if __name__ == "__main__":
    main()
