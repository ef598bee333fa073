"""Asset lookup, the 66-dim mean-parameter template, the 61-dim mean
MANO parameters and the MANO model data (the port's own copy of
``scat_tpu/assets.py:35-41,48-73,94-303``).

The mean vector is camera scale 5.0, zero translation, then the 21
template-vertex picks of the MANO mean hand (reference
train.py:94-109).  ``MANO_RIGHT.pkl`` is not redistributable: when it is
absent the template comes from ``extra_data/hand.obj``, which holds the
same 778-vertex ``v_template``, and the MANO model falls back to
``synthetic_mano``: a seeded stand-in on that template, the JAX
package's draws exactly.
"""

from __future__ import annotations

import dataclasses
import json
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

# Fingertip vertex ids of the two MANO joint conventions of the reference
# (models/mano.py:88 and :374-378).
FINGERTIP_VERTS_MANOHAND = [734, 333, 443, 555, 678]
FINGERTIP_VERTS_FRANKMOCAP = [320, 443, 671, 554, 744]

NUM_VERTS = 778
NUM_JOINTS_MANO = 16
NUM_SHAPE_BASIS = 10
NUM_POSE_BASIS = 135  # (16-1) * 9

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


def load_obj_faces(path: Optional[str] = None) -> np.ndarray:
    """Face rows of a Wavefront .obj -> int32 [F,3], 0-based."""
    path = find_asset("hand.obj") if path is None else path
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("f "):
                faces.append([int(t.split("/")[0]) - 1
                              for t in line.split()[1:4]])
    return np.asarray(faces, dtype=np.int32)


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
        v_template = load_mano_pkl(mano_path).v_template
    elif os.path.exists(obj_path):
        v_template = load_obj_vertices(obj_path)
    else:
        raise FileNotFoundError(
            f"neither {mano_path} nor {obj_path} present; "
            "cannot build the mean template")
    return build_mean_params(v_template, outside)


def load_mean_mano_pose(path: Optional[str] = None) -> np.ndarray:
    """61-dim mean MANO parameters (cam 3 + pose 48 + shape 10) of the
    128-token heads: camera scale 5.0; the pose's global orient zero and
    its 45 local dofs ``mean_pose[3:48]`` of ``mean_mano_params.pkl``;
    zero shape (reference eval.py:404-426).  A missing file leaves the
    pose zero, as in the JAX package."""
    path = find_asset("mean_mano_params.pkl") if path is None else path
    mean = np.zeros((61,), dtype=np.float32)
    mean[0] = 5.0
    if os.path.exists(path):
        with open(path, "rb") as f:
            dd = pickle.load(f, encoding="latin1")
        mean_pose = np.asarray(dd["mean_pose"], dtype=np.float32).reshape(-1)
        mean[6:51] = mean_pose[3:48]
    return mean


@dataclasses.dataclass
class ManoModelData:
    """The numeric payload of MANO_RIGHT.pkl as float32 numpy arrays."""

    v_template: np.ndarray        # [778, 3]
    shapedirs: np.ndarray         # [778, 3, 10]
    posedirs: np.ndarray          # [778, 3, 135]
    J_regressor: np.ndarray       # [16, 778]
    weights: np.ndarray           # [778, 16]
    kintree_parents: np.ndarray   # [16] (parents[0] unused)
    hands_mean: np.ndarray        # [45]
    hands_components: np.ndarray  # [45, 45] PCA basis
    faces: Optional[np.ndarray] = None  # [F, 3]
    synthetic: bool = False

    @property
    def parents(self) -> np.ndarray:
        return self.kintree_parents


def _dense(x) -> np.ndarray:
    if hasattr(x, "todense"):
        x = np.asarray(x.todense())
    return np.asarray(x, dtype=np.float64).astype(np.float32)


def _regressor(j_regressor) -> np.ndarray:
    """[16, 778], whichever way round the file stores it."""
    r = _dense(j_regressor)
    return r.T if r.shape[0] == NUM_VERTS else r


def load_mano_pkl(path: Optional[str] = None) -> ManoModelData:
    """A user-supplied MANO_RIGHT.pkl (layout per reference
    models/mano.py:220-232)."""
    path = find_asset("MANO_RIGHT.pkl") if path is None else path
    with open(path, "rb") as f:
        dd = pickle.load(f, encoding="latin1")
    kintree = np.asarray(dd["kintree_table"])
    id_to_col = {int(kintree[1, i]): i for i in range(kintree.shape[1])}
    parents = np.zeros((kintree.shape[1],), dtype=np.int32)
    for i in range(1, kintree.shape[1]):
        parents[i] = id_to_col[int(kintree[0, i])]
    return ManoModelData(
        v_template=_dense(dd["v_template"]),
        shapedirs=_dense(dd["shapedirs"]),
        posedirs=_dense(dd["posedirs"]),
        J_regressor=_regressor(dd["J_regressor"]),
        weights=_dense(dd["weights"]),
        kintree_parents=parents,
        hands_mean=_dense(dd["hands_mean"]),
        hands_components=_dense(np.vstack(dd["hands_components"][:])),
        faces=np.asarray(dd["f"], dtype=np.int32) if "f" in dd else None,
    )


def load_mano_json(path: str) -> ManoModelData:
    """A JSON-serialized MANO model (the format of the reference's
    ``ManoHand``, models/mano.py:92-133: plain lists under the pickle's
    keys)."""
    with open(path) as f:
        dd = json.load(f)
    return ManoModelData(
        v_template=_dense(dd["v_template"]),
        shapedirs=_dense(dd["shapedirs"]),
        posedirs=_dense(dd["posedirs"]),
        J_regressor=_regressor(dd["J_regressor"]),
        weights=_dense(dd["weights"]),
        kintree_parents=np.asarray(dd["kintree_table"])[0].astype(np.int32),
        hands_mean=_dense(dd["hands_mean"]),
        hands_components=_dense(np.vstack(dd["hands_components"])),
        faces=np.asarray(dd["f"], dtype=np.int32) if "f" in dd else None,
    )


def synthetic_mano(seed: int = 0,
                   v_template: Optional[np.ndarray] = None) -> ManoModelData:
    """The deterministic stand-in MANO where the pickle is absent: the
    template of ``hand.obj`` (so the kinematic scale is a hand's), seeded
    blend shapes, a J_regressor averaging a local cluster of vertices per
    joint, skinning weights soft over the nearest joints (rows summing to
    1) and an orthonormal PCA basis.  The draws are the JAX package's
    (``scat_tpu/assets.py:174-226``), one ``RandomState(seed)`` stream in
    the same order, so both packages build the same arrays."""
    rng = np.random.RandomState(seed)
    hand_obj = find_asset("hand.obj")
    if v_template is None:
        if os.path.exists(hand_obj):
            v_template = load_obj_vertices(hand_obj)
        else:
            v_template = rng.randn(NUM_VERTS, 3).astype(np.float32) * 0.03
    shapedirs = rng.randn(NUM_VERTS, 3, NUM_SHAPE_BASIS).astype(
        np.float32) * 1e-3
    posedirs = rng.randn(NUM_VERTS, 3, NUM_POSE_BASIS).astype(
        np.float32) * 1e-4
    J_regressor = np.zeros((NUM_JOINTS_MANO, NUM_VERTS), dtype=np.float32)
    anchor = rng.choice(NUM_VERTS, NUM_JOINTS_MANO, replace=False)
    d2 = np.sum((v_template[None, :, :] -
                 v_template[anchor][:, None, :]) ** 2, axis=-1)
    for j in range(NUM_JOINTS_MANO):
        w = np.exp(-d2[j] / 2e-4)
        J_regressor[j] = w / w.sum()
    joints = J_regressor @ v_template
    dj = np.sum((v_template[:, None, :] - joints[None, :, :]) ** 2, axis=-1)
    weights = np.exp(-dj / 1e-3)
    weights /= weights.sum(axis=1, keepdims=True)
    parents = np.array([0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14],
                       dtype=np.int32)
    comp = rng.randn(45, 45).astype(np.float32)
    comp, _ = np.linalg.qr(comp)
    return ManoModelData(
        v_template=np.asarray(v_template, dtype=np.float32),
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=J_regressor,
        weights=weights.astype(np.float32),
        kintree_parents=parents,
        hands_mean=(rng.randn(45) * 0.1).astype(np.float32),
        hands_components=comp.astype(np.float32),
        faces=load_obj_faces(hand_obj) if os.path.exists(hand_obj) else None,
        synthetic=True,
    )


def load_mano(path: Optional[str] = None, allow_synthetic: bool = True
              ) -> ManoModelData:
    """MANO from ``path`` (default: ``MANO_RIGHT.pkl`` by ``find_asset``;
    ``.json`` or a pickle), else ``synthetic_mano()`` where allowed."""
    path = find_asset("MANO_RIGHT.pkl") if path is None else path
    if os.path.exists(path):
        if path.endswith(".json"):
            return load_mano_json(path)
        return load_mano_pkl(path)
    if allow_synthetic:
        return synthetic_mano()
    raise FileNotFoundError(
        f"MANO model not found at {path}; place MANO_RIGHT.pkl there (or "
        "point $SCAT_EXTRA_DATA at its folder), or pass "
        "allow_synthetic=True for the synthetic stand-in")
