"""CLI entry: ``python -m scat_tpu_torch.train_coarse`` (port of
``scat_tpu/train_coarse.py``; reference train_coarse.py:248-253), on the
CUDA device.

The trainer of ``python -m scat_tpu_torch.train``, but the net switch's
default ``--net ViT`` trains the attention-returning coarse head
``reg_transformer_coarse`` (reference train_coarse.py:47-58), e.g.
``--batch_size 96 --lr 5e-4 --l_weight_3d 100000 --l_weight_2d 10
--vit_heads 8 --mask_rate 0.2 --synthetic_data True --debug False``.
"""

from scat_tpu_torch.config import BaseOptions
from scat_tpu_torch.training.trainer import Trainer


def parse(argv=None):
    """The options of ``argv``, the default ``--net ViT`` read as
    ``reg_transformer_coarse``."""
    opt = BaseOptions().parse(argv)
    if opt.net == "ViT":  # the reference's default routes to the coarse head
        opt.net = "reg_transformer_coarse"
    return opt


def main(argv=None):
    Trainer(parse(argv)).train()


if __name__ == "__main__":
    main()
