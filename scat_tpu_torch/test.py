"""``python -m scat_tpu_torch.test``: the FrankMocap/MANO inference flow
over a folder of RGB crops (reference test.py:444-446) on the CUDA
device.

``--checkpoint_path_eval <H3DW .pth, or "" for a seeded fresh init>
--result_dir <dir>``; the crops are read from ``./rgb/``.
"""

from scat_tpu_torch.evaluation.tester import main

if __name__ == "__main__":
    main()
