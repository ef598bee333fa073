"""The MANO hand model (port of ``scat_tpu/models/mano.py:42-233``;
reference models/mano.py).

Both reference paths:

  * ``mano_hand_forward``, the ``ManoHand`` module (mano.py:83-201): PCA
    pose (12 components) -> full 45-dof pose, blend shapes, joint
    regression, per-joint quaternion Rodrigues, pose-corrective blend
    shapes, the kinematic chain, LBS; joints = J_regressor of the skinned
    vertices ++ fingertip vertices [734, 333, 443, 555, 678].
  * ``rot_pose_beta_to_mesh``, the functional path (mano.py:280-391):
    45-dof pose added to hands_mean, zero root rotation in the chain,
    guarded Rodrigues, LBS, the global rotation applied after skinning,
    fingertips at the frankmocap ids [320, 443, 671, 554, 744],
    root-centred on joint 1; returns ``cat(joints21, verts778)``.

Precision.  The JAX package runs every MANO product at
``Precision.HIGHEST``.  Here ``mano_hand_forward`` and
``rot_pose_beta_to_mesh`` cast their inputs to float32 and compute with
autocast off and the float32 matmul precision "highest" (no TF32),
whatever the caller's compute dtype: the decode of a bf16 encoder's
parameters is float32, as in the JAX package.  ``ManoDecode`` is that
decode as a module, the one that the served forward of a 61-dim head
(``serving.ServingForward``) and ``H3DWJointsEncoder`` run.

The 16-joint chain composes its 4x4 transforms one joint at a time, as
the JAX package does: 15 small batched matmuls, each a launch on the
card.  No step copies from the host: the homogeneous row is filled on
the device and the fingertips are gathered as slices, no index tensor,
so the decode never waits for the work queued before it (a pageable
host-to-device copy would), and ``torch.export`` records no tensor made
while it traces.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from scat_tpu_torch import assets
from scat_tpu_torch.ops.geometry import (batch_rodrigues, float32_exact,
                                         rodrigues_guarded)
from scat_tpu_torch.utils.profiling import span

NUM_JOINTS = 16
NUM_VERTS = 778


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """MANO's parameters as float32 tensors on one device."""

    v_template: torch.Tensor        # [778, 3]
    shapedirs_flat: torch.Tensor    # [10, 778*3]  (beta @ -> offsets)
    posedirs_flat: torch.Tensor     # [135, 778*3]
    J_regressor: torch.Tensor       # [16, 778]
    weights: torch.Tensor           # [778, 16]
    hands_mean: torch.Tensor        # [45]
    hands_components: torch.Tensor  # [45, 45]
    parents: Tuple[int, ...]        # length 16, parents[0] unused

    @classmethod
    def from_data(cls, data: Optional[assets.ManoModelData] = None,
                  device=None) -> "ManoModel":
        """From ``data`` (default: ``assets.load_mano()``, which falls back
        to the synthetic MANO), on ``device`` (default the CPU)."""
        if data is None:
            data = assets.load_mano()

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)
        return cls(
            v_template=t(data.v_template),
            shapedirs_flat=t(data.shapedirs.reshape(
                -1, data.shapedirs.shape[-1]).T),
            posedirs_flat=t(data.posedirs.reshape(
                -1, data.posedirs.shape[-1]).T),
            J_regressor=t(data.J_regressor),
            weights=t(data.weights),
            hands_mean=t(data.hands_mean.reshape(-1)),
            hands_components=t(data.hands_components),
            parents=tuple(int(p) for p in data.kintree_parents))

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "ManoModel":
        """The same model with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "parents"})


def _gather_verts(verts: torch.Tensor, ids: Sequence[int]) -> torch.Tensor:
    """Rows ``ids`` of [B,V,3] ``verts``: one slice a vertex, one copy."""
    return torch.cat([verts[:, i:i + 1] for i in ids], dim=1)


def blend_shapes(model: ManoModel, beta: torch.Tensor) -> torch.Tensor:
    """``v_template + beta @ shapedirs`` -> [B,778,3] (mano.py:167)."""
    offs = (beta @ model.shapedirs_flat).reshape(-1, NUM_VERTS, 3)
    return offs + model.v_template


def regress_joints(model: ManoModel, verts: torch.Tensor) -> torch.Tensor:
    """J_regressor applied per coordinate -> [B,16,3] (mano.py:171-175)."""
    return torch.einsum("jv,bvc->bjc", model.J_regressor, verts)


def global_rigid_transform(Rs: torch.Tensor, Js: torch.Tensor,
                           parents: Tuple[int, ...]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics over the 16-joint chain: ``(new_J [B,16,3],
    A [B,16,4,4])``, A the skinning transform (the world transform less
    the rest-pose bone offset, mano.py:40-73)."""
    # the homogeneous row [0, 0, 0, 1], filled on the device
    bottom = torch.cat([torch.zeros_like(Js[:, :1]),
                        torch.ones_like(Js[:, :1, :1])], dim=2)  # [B,1,4]

    def make_A(R, t):
        return torch.cat([torch.cat([R, t[:, :, None]], dim=2), bottom],
                         dim=1)

    results = [make_A(Rs[:, 0], Js[:, 0])]
    for i in range(1, NUM_JOINTS):
        j_rel = Js[:, i] - Js[:, parents[i]]
        results.append(results[parents[i]] @ make_A(Rs[:, i], j_rel))
    world = torch.stack(results, dim=1)  # [B,16,4,4]
    new_J = world[:, :, :3, 3]
    # world @ [J; 0]: the rest-pose bone position, removed so that LBS
    # transforms displacements (mano.py:68-71)
    Js_h = torch.cat([Js, torch.zeros_like(Js[..., :1])], dim=2)
    init_bone = torch.einsum("bjxy,bjy->bjx", world, Js_h)
    A = torch.cat([world[..., :3], (world[..., 3] - init_bone)[..., None]],
                  dim=3)
    return new_J, A


def linear_blend_skinning(model: ManoModel, v_posed: torch.Tensor,
                          A: torch.Tensor) -> torch.Tensor:
    """Per-vertex blended transforms applied to the posed vertices
    (mano.py:181-187)."""
    T = torch.einsum("vj,bjxy->bvxy", model.weights, A)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=2)
    return torch.einsum("bvxy,bvy->bvx", T, v_h)[..., :3]


def pca_to_full_pose(model: ManoModel, theta: torch.Tensor,
                     pose_param_count: int = 12) -> torch.Tensor:
    """[B, 3+P] (global rotation + PCA coefficients) -> [B, 48]
    (mano.py:152-155)."""
    g_rot, coeffs = theta[:, :3], theta[:, 3:]
    full = coeffs @ model.hands_components[:pose_param_count]
    return torch.cat([g_rot, full + model.hands_mean], dim=1)


def _lbs_core(model: ManoModel, beta: torch.Tensor, full_pose: torch.Tensor,
              rodrigues_fn) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The shared LBS pipeline: (verts, chain joints, Rs)."""
    B = full_pose.shape[0]
    v_shaped = blend_shapes(model, beta)
    J = regress_joints(model, v_shaped)
    Rs = rodrigues_fn(full_pose.reshape(-1, 3)).reshape(B, NUM_JOINTS, 3, 3)
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    pose_feature = (Rs[:, 1:] - eye).reshape(B, -1)  # [B,135]
    v_posed = ((pose_feature @ model.posedirs_flat).reshape(B, NUM_VERTS, 3)
               + v_shaped)
    new_J, A = global_rigid_transform(Rs, J, model.parents)
    return linear_blend_skinning(model, v_posed, A), new_J, Rs


def mano_hand_forward(model: ManoModel, beta: torch.Tensor,
                      theta: torch.Tensor, pose_param_count: int = 12,
                      get_skin: bool = False):
    """``ManoHand.forward`` (mano.py:151-201): ``beta`` [B,10], ``theta``
    [B, 3+pose_param_count] -> joints [B,21,3] (and with ``get_skin``
    ``(verts, joints, Rs)``)."""
    with float32_exact(theta.device.type):
        full_pose = pca_to_full_pose(model, theta.float(), pose_param_count)
        verts, _, Rs = _lbs_core(model, beta.float(), full_pose,
                                 batch_rodrigues)
        joints = torch.cat([regress_joints(model, verts), _gather_verts(
            verts, assets.FINGERTIP_VERTS_MANOHAND)], dim=1)
    if get_skin:
        return verts, joints, Rs
    return joints


def rot_pose_beta_to_mesh(model: ManoModel, rots: torch.Tensor,
                          poses: torch.Tensor, betas: torch.Tensor,
                          fingertip_ids=None) -> torch.Tensor:
    """The functional path (mano.py:280-391): [B,799,3] = 21 joints ++
    778 verts, root-centred on joint 1.  ``rots`` [B,3] the global
    rotation applied after skinning; ``poses`` [B,45] local dofs added to
    hands_mean; ``betas`` [B,10]."""
    if fingertip_ids is None:
        fingertip_ids = assets.FINGERTIP_VERTS_FRANKMOCAP
    with float32_exact(rots.device.type):
        rots, poses, betas = rots.float(), poses.float(), betas.float()
        B = rots.shape[0]
        local = (model.hands_mean + poses).reshape(B, NUM_JOINTS - 1, 3)
        root = torch.zeros_like(local[:, :1])  # root_rot = 0 (mano.py:234)
        full_pose = torch.cat([root, local], dim=1).reshape(B, -1)
        # as the reference, the chain joints regress from v_shaped and the
        # pose correctives move the vertices only (mano.py:302)
        verts, chain_joints, _ = _lbs_core(model, betas, full_pose,
                                           rodrigues_guarded)
        joints = torch.cat([chain_joints,
                            _gather_verts(verts, fingertip_ids)], dim=1)
        Rots = rodrigues_guarded(rots)
        verts = torch.einsum("bxy,bvy->bvx", Rots, verts)
        joints = torch.einsum("bxy,bjy->bjx", Rots, joints)
        center = joints[:, 1:2]
        return torch.cat([joints - center, verts - center], dim=1)


class ManoDecode(nn.Module):
    """The decode of the 61 MANO parameters that ``--net backbone_hrnet``,
    ``backbone_incepv3`` and ``frankmocap`` predict (camera 3, global
    rotation 3, pose 45, shape 10) to the 66-dim camera + 21x3 joints
    contract, as upstream test.py:332-348 decodes them: the camera
    ``params[:, :3]``, the joints the first 21 rows of
    ``rot_pose_beta_to_mesh(params[:, 3:6], params[:, 6:51],
    params[:, 51:61])``, in float32 whatever the compute dtype.

    MANO's arrays are non-persistent buffers: they move with the module,
    no state_dict (a checkpoint, an artifact's ``weights.npz``) carries
    them, and ``torch.export`` records them as program constants."""

    def __init__(self, data: Optional[assets.ManoModelData] = None):
        super().__init__()
        model = ManoModel.from_data(data)
        for f in dataclasses.fields(ManoModel):
            if f.name != "parents":
                self.register_buffer(f.name, getattr(model, f.name),
                                     persistent=False)
        self.parents = model.parents

    @property
    def mano(self) -> ManoModel:
        """The arrays in float32, whatever dtype the module was cast to."""
        return ManoModel(parents=self.parents, **{
            f.name: getattr(self, f.name).float()
            for f in dataclasses.fields(ManoModel) if f.name != "parents"})

    def forward(self, params: torch.Tensor) -> torch.Tensor:
        with span("scat.model.mano"):
            out = rot_pose_beta_to_mesh(self.mano, params[:, 3:6],
                                        params[:, 6:51], params[:, 51:61])
            return torch.cat([params[:, :3].float(),
                              out[:, :21].reshape(-1, 63)], dim=1)


def save_obj(verts, faces, obj_mesh_name: str) -> None:
    """A mesh as Wavefront .obj (reference mano.py:139-149)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    with open(obj_mesh_name, "w") as fp:
        for v in verts:
            fp.write("v %f %f %f\n" % (v[0], v[1], v[2]))
        for f in faces:
            fp.write("f %d %d %d\n" % (f[0] + 1, f[1] + 1, f[2] + 1))
