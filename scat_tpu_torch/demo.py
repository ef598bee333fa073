"""``python -m scat_tpu_torch.demo``: the video demo (reference eval.py's
shipped ``__main__``, eval.py:1073-1076) on the CUDA device.

``--eval_dataset STB|MHP|ho3d --data_dir <STB tree> --checkpoint_path_eval
<hand_net_final.pth> --result_dir <dir>``; the MHP and HO-3D trees sit
beside the STB tree (``MHP``, ``HO3D``).
"""

from scat_tpu_torch.evaluation.demo import main

if __name__ == "__main__":
    main()
