"""CLI entry: ``python -m scat_tpu_torch.train`` (reference
train.py:248-253), on the CUDA device.

Takes the reference flag line, e.g. the canonical run
(script/ablation_pose.sh) on the synthetic task:
``--net reg_transformer --batch_size 96 --lr 5e-4 --epoch 40
--l_weight_3d 100000 --l_weight_2d 10 --vit_heads 8 --iteration 3
--pos_embed True --mask_rate 0.2 --synthetic_data True --debug False``.
"""

from scat_tpu_torch.training.trainer import main

if __name__ == "__main__":
    main()
