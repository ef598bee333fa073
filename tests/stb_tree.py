"""A written STB tree for the tests (no STB file is in the repository):
smooth frames, which encode and decode fast, and label pickles whose
hands project inside them.  Imports neither JAX nor the JAX package, so
the card tests use it too."""

import os
import pickle

import numpy as np

from scat_tpu_torch.data import stb

TRAIN_SEQS = ("B2Counting", "B2Random")
EVAL_SEQS = ("B1Counting", "B1Random")


def _smooth(h, w, k):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 3 + 7 * k) % 256, (y * 5 + 11 * k) % 256,
                     (x + y + 13 * k) % 256], -1).astype(np.uint8)


def write_stb_tree(root, seqs=TRAIN_SEQS + EVAL_SEQS, n=4, height=96,
                   width=128, seed=0):
    """An STB tree under ``root``: ``n`` smooth ``height`` x ``width``
    frames a sequence and label pickles {"handPara": [3,21,n]} of hands
    about 500 mm from the camera whose joints project inside the frames
    (the colour camera's K, SK_TRANS_VEC undone)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    k = 0
    for seq in seqs:
        os.makedirs(os.path.join(root, seq), exist_ok=True)
        z = 500.0 + 50.0 * rng.rand(1, 21, n)
        u = width / 2 + width / 5 * rng.uniform(-1, 1, (1, 21, n))
        v = height / 2 + height / 5 * rng.uniform(-1, 1, (1, 21, n))
        x = (u - stb.SK_TX_COLOR) / stb.SK_FX_COLOR * z
        y = (v - stb.SK_TY_COLOR) / stb.SK_FY_COLOR * z
        hand = np.concatenate([x, y, z]) + np.asarray(
            stb.SK_TRANS_VEC)[:, None, None]
        with open(os.path.join(root, "labels", f"{seq}_SK.pkl"), "wb") as f:
            pickle.dump({"handPara": hand}, f)
        for i in range(n):
            Image.fromarray(_smooth(height, width, k)).save(
                os.path.join(root, seq, f"SK_color_{i}.png"))
            k += 1
    return str(root)
