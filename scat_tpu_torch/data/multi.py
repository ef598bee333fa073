"""Dataset zipping and the training-stage mixes (port of
``scat_tpu/data/multi.py``; reference dataset/MultiDataset.py).

``ConcatDataset`` yields a tuple of one batch from each member, and the
trainer takes one step per member (reference train.py:136-138).  Stage 3
(STB alone, the canonical run of script/ablation_pose.sh) is ported; the
stages that mix FreiHAND, HO-3D, MHP or RHD wait for their loaders
(ROADMAP.md queue 1 item 15).
"""

from __future__ import annotations

from typing import Iterator, Tuple

from scat_tpu_torch.config import Options

# stage -> what its mix needs (reference MultiDataset.py:14-78)
UNPORTED_STAGES = {
    1: "FreiHAND and HO-3D",
    2: "RHD, FreiHAND, HO-3D and MHP",
    4: "FreiHAND",
    5: "HO-3D",
    6: "MHP",
}


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
    if opt.stage in UNPORTED_STAGES:
        raise NotImplementedError(
            f"--stage {opt.stage} mixes {UNPORTED_STAGES[opt.stage]}, whose "
            "loaders are not ported to scat_tpu_torch yet (ROADMAP.md queue "
            "1 item 15); --stage 3 trains on STB")
    from scat_tpu_torch.data.stb import get_loader_STB
    print("[STAGE][3] finish, finetune.")
    return ConcatDataset(get_loader_STB("training", batch_size, opt,
                                        device=device))
