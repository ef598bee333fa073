"""Asset lookup and the 66-dim mean-parameter template (the port's own
copy of ``scat_tpu/assets.py:48-73,94-125,271-286``).

The mean vector is camera scale 5.0, zero translation, then the 21
template-vertex picks of the MANO mean hand (reference
train.py:94-109).  ``MANO_RIGHT.pkl`` is not redistributable: when it is
absent the template comes from ``extra_data/hand.obj``, which holds the
same 778-vertex ``v_template``.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

# Back-of-hand / palm template vertex ids (1-indexed Blender picks),
# reference train.py:94-99, in the 21-joint order the regressor predicts.
LOCAL_TREE_BACK = [188, 142, 87, 290, 216, 316, 402, 200, 585, 630, 285,
                   473, 513, 88, 249, 702, 329, 439, 668, 550, 740]
LOCAL_TREE_PALM = [35, 168, 47, 337, 283, 353, 449, 591, 599, 637, 139,
                   467, 560, 5, 121, 707, 329, 439, 668, 550, 740]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def find_asset(name: str) -> str:
    """Resolve an asset file by name; the first existing path wins:

      1. ``$SCAT_EXTRA_DATA/<name>``,
      2. ``./extra_data/<name>`` (beside the user's run, the reference's
         layout),
      3. ``<checkout>/extra_data/<name>``.

    When none exists, returns the checkout path so that error messages
    name a meaningful location.
    """
    cands = []
    env = os.environ.get("SCAT_EXTRA_DATA")
    if env:
        cands.append(os.path.join(env, name))
    cands.append(os.path.join(os.getcwd(), "extra_data", name))
    cands.append(os.path.join(_REPO_ROOT, "extra_data", name))
    for c in cands:
        if os.path.exists(c):
            return c
    return cands[-1]


def load_obj_vertices(path: Optional[str] = None) -> np.ndarray:
    """Vertex rows of a Wavefront .obj -> float32 [V,3]."""
    path = find_asset("hand.obj") if path is None else path
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
    return np.asarray(verts, dtype=np.float32)


def _mano_v_template(path: str) -> np.ndarray:
    """``v_template`` of a MANO_RIGHT.pkl (a user-supplied file)."""
    with open(path, "rb") as f:
        dd = pickle.load(f, encoding="latin1")
    return np.asarray(dd["v_template"], dtype=np.float64).astype(np.float32)


def build_mean_params(v_template: np.ndarray, outside: bool = True
                      ) -> np.ndarray:
    """66-dim mean vector: camera scale 5.0, zeros for tx/ty, then the 21
    template-vertex xyz picks (reference train.py:104-109)."""
    tree = LOCAL_TREE_BACK if outside else LOCAL_TREE_PALM
    idx = np.asarray(tree, dtype=np.int64) - 1  # blender ids are 1-based
    mean = np.zeros((66,), dtype=np.float32)
    mean[0] = 5.0
    mean[3:] = v_template[idx].reshape(-1)
    return mean


def load_mean_params(outside: bool = True,
                     mano_path: Optional[str] = None,
                     obj_path: Optional[str] = None) -> np.ndarray:
    """Mean 66-dim parameter vector from whichever template source exists."""
    mano_path = find_asset("MANO_RIGHT.pkl") if mano_path is None \
        else mano_path
    obj_path = find_asset("hand.obj") if obj_path is None else obj_path
    if os.path.exists(mano_path):
        v_template = _mano_v_template(mano_path)
    elif os.path.exists(obj_path):
        v_template = load_obj_vertices(obj_path)
    else:
        raise FileNotFoundError(
            f"neither {mano_path} nor {obj_path} present; "
            "cannot build the mean template")
    return build_mean_params(v_template, outside)
