"""The FrankMocap/MANO inference flow (port of
``scat_tpu/evaluation/tester.py:32-140``; reference test.py:162-439).

For each RGB crop of a folder, one at a time (``data/testset``, resized
to 224 and normalised on the device): the H3DW encoder (``--net
frankmocap``, always) -> camera (3), pose (48), shape (10) -> the MANO
decode (``rot_pose_beta_to_mesh``: 21 joints and 778 vertices, float32)
-> the weak-perspective projection to crop pixels -> ``{stem}_params.txt``
(the 61 parameters) and ``{stem}_overlay.png`` (the crop with its 2D
skeleton in the Simple joint order) under ``--result_dir``.  Without
matplotlib the overlay is skipped with a message, as ``PCK.png`` is.

``--hand_choice`` other than ``mano`` is refused: the reference's SMPL-X
decode is commented out (test.py:343) and crashes as shipped.
``Tester(opt, device=None)`` runs on the CUDA device unless the caller
asks for another; weights come from ``--checkpoint_path_eval`` (a
reference-keyed H3DW ``.pth``, loaded by ``utils/checkpoint.load_pth``;
"" for a fresh init seeded with ``--seed``) or an injected
``state_dict``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from scat_tpu_torch.config import BaseOptions, Options
from scat_tpu_torch.data.testset import get_loader_test
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models import mano as mano_lib
from scat_tpu_torch.models.factory import compute_dtype
from scat_tpu_torch.ops.geometry import batch_orth_proj_idrot, project_2d
from scat_tpu_torch.utils import checkpoint as ckpt_lib
from scat_tpu_torch.viz import draw


class Tester:
    """``Tester(opt).test(test_dir)`` (reference test.py:162-439)."""

    def __init__(self, opt: Options, image_size: int = 224,
                 state_dict: Optional[dict] = None, device=None):
        if opt.hand_choice != "mano":
            raise ValueError(
                f"--hand_choice {opt.hand_choice!r}: only 'mano' is "
                "functional (the reference's smplx decode is commented out "
                "at test.py:343 and crashes as shipped)")
        self.opt = opt
        self.device = resolve_device(device, "the Tester")
        self.image_size = image_size
        self.result_dir = opt.result_dir
        os.makedirs(self.result_dir, exist_ok=True)
        model, self.mean_params = build_model(
            dataclasses.replace(opt, net="frankmocap"), image_size)
        if state_dict is None:
            ckpt_lib.load_weights(model, opt.checkpoint_path_eval,
                                  seed=opt.seed)
        else:
            ckpt_lib.load_state_dict(model, state_dict)
        model = model.to(self.device, memory_format=torch.channels_last)
        self.model = model.cast_compute(compute_dtype(opt)).eval()
        self.mano = mano_lib.ManoModel.from_data(device=self.device)

    def forward(self, images: torch.Tensor):
        """NHWC crops [B,S,S,3] in [-1,1] -> (pred_params [B,61], joints_3d
        [B,21,3], verts [B,778,3], joints_2d [B,21,2]), float32."""
        with torch.no_grad():
            _, pred = self.model(images.permute(0, 3, 1, 2))
            out = mano_lib.rot_pose_beta_to_mesh(
                self.mano, pred[:, 3:6], pred[:, 6:51], pred[:, 51:61])
            joints, verts = out[:, :21], out[:, 21:]
            j2d = project_2d(batch_orth_proj_idrot(joints, pred[:, :3]))
        return pred, joints, verts, j2d

    def test(self, test_dir: str = "./rgb/") -> list:
        """Every image of ``test_dir``, in name order: writes its files
        and returns a dict a crop (``name``, ``pred_params``,
        ``joints_3d``, ``verts``, ``joints_2d``, numpy)."""
        results = []
        overlays = True
        for image, _, _, name in get_loader_test(test_dir, self.opt,
                                                 device=self.device):
            outs = [t[0].float().cpu().numpy()
                    for t in self.forward(image[None])]
            pred, joints, verts, j2d = outs
            stem = os.path.splitext(name)[0]
            if overlays:
                overlays = self._save_overlay(image.float().cpu().numpy(),
                                              j2d, stem)
            np.savetxt(os.path.join(self.result_dir, f"{stem}_params.txt"),
                       pred)
            results.append({"name": name, "pred_params": pred,
                            "joints_3d": joints, "verts": verts,
                            "joints_2d": j2d})
        return results

    def _save_overlay(self, image_float: np.ndarray, j2d: np.ndarray,
                      stem: str) -> bool:
        """The crop with its skeleton; False (after a message) where
        matplotlib is missing."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            print(f"matplotlib unavailable, skipping the overlays: {e}")
            return False
        fig = plt.figure()
        ax = fig.add_subplot(111)
        ax.imshow(draw.unnormalize_image(image_float))
        draw.plot_2d_hand(ax, j2d[draw.jointsMapSMPLXToSimple], order="uv")
        fig.savefig(os.path.join(self.result_dir, f"{stem}_overlay.png"))
        plt.close(fig)
        return True


def main(argv=None):
    Tester(BaseOptions().parse(argv)).test()


if __name__ == "__main__":
    main()
