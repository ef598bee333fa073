"""``python -m scat_tpu_torch.eval``: the benchmark evaluation
(reference eval.py:1056-1062 ``main()``) on the CUDA device.

``--eval_dataset STB --data_dir <STB tree> --checkpoint_path_eval
<hand_net_final.pth> --result_dir <dir>``
"""

from scat_tpu_torch.evaluation.evaluator import main

if __name__ == "__main__":
    main()
