"""Dataset zipping and the training-stage mixes (port of
``scat_tpu/data/multi.py``; reference dataset/MultiDataset.py).

``ConcatDataset`` yields a tuple of one batch from each member, and the
trainer takes one step per member (reference train.py:136-138).  Every
stage of the reference is wired to its loaders; FreiHAND, HO-3D, MHP and
RHD are the JAX package's re-derivations of the modules the reference
imports but does not ship (``freihand.py``, ``ho3d.py``, ``mhp.py``,
``rhd.py``).  FreiHAND and HO-3D batches carry 166-float labels, STB,
MHP and RHD batches 105-float ones; the train step dispatches on the
width (``models/losses.split_labels``).
"""

from __future__ import annotations

import pickle
from typing import Iterator, Tuple

from scat_tpu_torch.config import Options


class ConcatDataset:
    """N batch iterables zipped into tuples of batches, cut to the
    shortest (reference MultiDataset.py:4-12).  An empty member is
    refused: the zip would make the mix empty, and the trainer would
    finish untrained after zero steps an epoch."""

    def __init__(self, *datasets):
        for d in datasets:
            if not len(d):
                raise ValueError(
                    f"ConcatDataset member {type(d).__name__} is empty (no "
                    "samples found on disk?): the zip would produce zero "
                    "training batches")
        self.datasets = datasets

    def __len__(self) -> int:
        return min(len(d) for d in self.datasets)

    def __iter__(self) -> Iterator[Tuple]:
        iters = [iter(d) for d in self.datasets]
        for _ in range(len(self)):
            yield tuple(next(it) for it in iters)


def concat_dataset(batch_size: int, opt: Options, device=None
                   ) -> ConcatDataset:
    """The mix of ``opt.stage`` (reference MultiDataset.py:14-78)."""
    if opt.stage not in (1, 2, 3, 4, 5, 6):
        raise ValueError("stage must fall in 1, 2, 3, 4, 5, 6")
    from scat_tpu_torch.data.freihand import get_loader_frei
    from scat_tpu_torch.data.ho3d import get_loader_ho3d
    from scat_tpu_torch.data.mhp import get_loader_MHP
    from scat_tpu_torch.data.rhd import get_loader_RHD
    from scat_tpu_torch.data.stb import get_loader_STB

    def member(factory):
        return factory("training", batch_size, opt, device=device)

    if opt.stage == 1:
        print("[STAGE][1] pretrain, use Freihand&ho3d dataset.")
        return ConcatDataset(member(get_loader_frei), member(get_loader_ho3d))
    if opt.stage == 2:
        print("[STAGE][2] finetune, use RHD, STB, freiHand, STB, MHP.")
        members = [member(get_loader_frei), member(get_loader_ho3d),
                   member(get_loader_STB)]
        # MHP and RHD join only where their trees read: the zip is cut to
        # its shortest member, so an empty one would empty the stage, and
        # a partial tree (a calibration pickle missing) must not fail it
        for name, factory in (("MHP", get_loader_MHP),
                              ("RHD", get_loader_RHD)):
            try:
                extra = member(factory)
            except (OSError, EOFError, KeyError, ValueError,
                    pickle.UnpicklingError) as e:
                # a missing or corrupt calibration or annotation file
                print(f"[STAGE][2] {name} tree present but unreadable, "
                      f"skipping it: {e}")
                continue
            if len(extra):
                members.append(extra)
        return ConcatDataset(*members)
    if opt.stage == 3:
        print("[STAGE][3] finish, finetune.")
        return ConcatDataset(member(get_loader_STB))
    if opt.stage == 4:
        print("[STAGE][4] Ablation Study on freiHand.")
        return ConcatDataset(member(get_loader_frei))
    if opt.stage == 5:
        print("[STAGE][5] Ablation Study on Ho-3D.")
        return ConcatDataset(member(get_loader_ho3d))
    print("[STAGE][6] Ablation Study on MHP.")
    mhp = member(get_loader_MHP)
    if not len(mhp):
        # a sole empty member would train zero steps an epoch
        raise FileNotFoundError(
            "[STAGE][6] no MHP data found (expected annotated_frames/ and "
            "calibrations/ under the MHP root beside --data_dir); see "
            "scat_tpu_torch/data/mhp.py for the tree")
    return ConcatDataset(mhp)
