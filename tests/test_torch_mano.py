"""The port's MANO path against the JAX package's, in float32 on the CPU:
the synthetic MANO's arrays, every stage of the MANO model (blend
shapes, joint regression, the kinematic chain, skinning, both reference
forwards, a zero rotation through the guarded Rodrigues), the H3DW
encoders (resnet18 at 32 px) with their weights carried by
``utils.weights``, the SMPL-X glue, the Tester on written crops and the
Evaluator on ``--net frankmocap``.

The JAX trees come from ``jax.eval_shape`` of each init, filled with
seeded numpy draws (``flax_trees``); inputs come from a seeded numpy
RandomState and go to both sides."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.config as jconfig
import scat_tpu.evaluation.evaluator as jevaluator
import scat_tpu.evaluation.tester as jtester
import scat_tpu.models.hand_net as jhand_net
from scat_tpu import assets as jassets
from scat_tpu.models import mano as jmano
from scat_tpu.utils import smplx_glue as jglue
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.evaluation import evaluator, tester
from scat_tpu_torch.models import mano
from scat_tpu_torch.models.factory import build_model
from scat_tpu_torch.models.hand_net import H3DWEncoder, H3DWJointsEncoder
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint, smplx_glue
from scat_tpu_torch.utils.weights import h3dw_state_dict_from_flax

from flax_trees import variables as flax_variables

IMG, BS = 32, 4
ATOL_MANO = 1e-5
ATOL_MODEL = 1e-4
FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
          "kintree_parents", "hands_mean", "hands_components", "faces")


@pytest.fixture(scope="module")
def models():
    data = assets.synthetic_mano(0)
    return (jmano.ManoModel.from_data(jassets.synthetic_mano(0)),
            mano.ManoModel.from_data(data))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_synthetic_mano_equals_jax():
    """One RandomState stream in the same order and the same hand.obj:
    every array bit-identical."""
    want, got = jassets.synthetic_mano(0), assets.synthetic_mano(0)
    assert got.synthetic and got.faces is not None
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert assets.load_mano().synthetic    # MANO_RIGHT.pkl is absent


def test_load_mano_json_matches_jax(tmp_path):
    d = assets.synthetic_mano(3)
    path = str(tmp_path / "mano.json")
    with open(path, "w") as f:
        json.dump({"v_template": d.v_template.tolist(),
                   "shapedirs": d.shapedirs.tolist(),
                   "posedirs": d.posedirs.tolist(),
                   "J_regressor": d.J_regressor.T.tolist(),
                   "weights": d.weights.tolist(),
                   "kintree_table": [d.kintree_parents.tolist(),
                                     list(range(16))],
                   "hands_mean": d.hands_mean.tolist(),
                   "hands_components": d.hands_components.tolist(),
                   "f": d.faces.tolist()}, f)
    got, want = assets.load_mano(path), jassets.load_mano(path)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.J_regressor, d.J_regressor)


def test_missing_mano_names_no_download(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        assets.load_mano(str(tmp_path / "MANO_RIGHT.pkl"),
                         allow_synthetic=False)
    assert "download" not in str(e.value).lower()


def _pose_inputs(rng, b=5, zero_first=True):
    rots = rng.randn(b, 3).astype(np.float32) * 0.5
    poses = rng.randn(b, 45).astype(np.float32) * 0.3
    betas = rng.randn(b, 10).astype(np.float32)
    if zero_first:   # the guarded Rodrigues' Taylor branch
        rots[0] = 0.0
        poses[0] = -np.asarray(assets.synthetic_mano(0).hands_mean)
    return rots, poses, betas


def test_mano_stages_match_jax(models, rng):
    """Blend shapes, joint regression, Rodrigues, the 16-joint chain and
    LBS, each on the same inputs: within 1e-5."""
    jm, tm = models
    _, poses, betas = _pose_inputs(rng)
    b = poses.shape[0]
    full = np.concatenate([np.zeros((b, 3), np.float32), poses], 1)
    v = jmano.blend_shapes(jm, jnp.asarray(betas))
    np.testing.assert_allclose(mano.blend_shapes(tm, _t(betas)).numpy(),
                               np.asarray(v), atol=ATOL_MANO)
    np.testing.assert_allclose(
        mano.regress_joints(tm, _t(v)).numpy(),
        np.asarray(jmano.regress_joints(jm, v)), atol=ATOL_MANO)
    from scat_tpu.ops.geometry import rodrigues_guarded as jrod
    from scat_tpu_torch.ops.geometry import rodrigues_guarded
    Rs = jrod(jnp.asarray(full.reshape(-1, 3))).reshape(b, 16, 3, 3)
    np.testing.assert_allclose(
        rodrigues_guarded(_t(full.reshape(-1, 3))).reshape(
            b, 16, 3, 3).numpy(), np.asarray(Rs), atol=ATOL_MANO)
    J = jmano.regress_joints(jm, v)
    jnew, jA = jmano.global_rigid_transform(Rs, J, jm.parents)
    tnew, tA = mano.global_rigid_transform(_t(Rs), _t(J), tm.parents)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew),
                               atol=ATOL_MANO)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=ATOL_MANO)
    np.testing.assert_allclose(
        mano.linear_blend_skinning(tm, _t(v), _t(jA)).numpy(),
        np.asarray(jmano.linear_blend_skinning(jm, v, jA)), atol=ATOL_MANO)
    theta = rng.randn(b, 15).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        mano.pca_to_full_pose(tm, _t(theta)).numpy(),
        np.asarray(jmano.pca_to_full_pose(jm, jnp.asarray(theta))),
        atol=ATOL_MANO)


def test_rot_pose_beta_to_mesh_matches_jax(models, rng):
    """The functional path, joints and vertices within 1e-5, sample 0 at
    a zero rotation and zero pose; root-centred on joint 1."""
    jm, tm = models
    rots, poses, betas = _pose_inputs(rng)
    want = np.asarray(jmano.rot_pose_beta_to_mesh(
        jm, jnp.asarray(rots), jnp.asarray(poses), jnp.asarray(betas)))
    got = mano.rot_pose_beta_to_mesh(tm, _t(rots), _t(poses), _t(betas))
    assert got.shape == (5, 799, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_MANO)
    assert np.all(got[:, 1].numpy() == 0)
    # bf16 inputs decode in float32
    got16 = mano.rot_pose_beta_to_mesh(tm, _t(rots).bfloat16(),
                                       _t(poses).bfloat16(),
                                       _t(betas).bfloat16())
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("get_skin", [False, True])
def test_mano_hand_forward_matches_jax(models, rng, get_skin):
    jm, tm = models
    b = 4
    beta = rng.randn(b, 10).astype(np.float32)
    theta = rng.randn(b, 15).astype(np.float32) * 0.4
    theta[0] = 0.0
    want = jmano.mano_hand_forward(jm, jnp.asarray(beta),
                                   jnp.asarray(theta), get_skin=get_skin)
    got = mano.mano_hand_forward(tm, _t(beta), _t(theta), get_skin=get_skin)
    want = want if get_skin else (want,)
    got = got if get_skin else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_MANO)
    joints = got[1] if get_skin else got[0]
    assert joints.shape == (b, 21, 3)


def test_save_obj(tmp_path, models):
    _, tm = models
    path = str(tmp_path / "hand.obj")
    faces = assets.load_obj_faces()
    mano.save_obj(tm.v_template.numpy(), faces, path)
    np.testing.assert_allclose(assets.load_obj_vertices(path),
                               tm.v_template.numpy(), atol=1e-6)
    np.testing.assert_array_equal(assets.load_obj_faces(path), faces)


def _h3dw_pair(joints: bool, rng):
    mean = assets.load_mean_mano_pose()
    jcls = jhand_net.H3DWJointsEncoder if joints else jhand_net.H3DWEncoder
    jm = jcls(mean_params=jnp.asarray(mean), backbone="resnet18")
    v = flax_variables(jm, rng, np.zeros((1, IMG, IMG, 3), np.float32),
                       train=False)
    tcls = H3DWJointsEncoder if joints else H3DWEncoder
    tm = tcls(mean_params=torch.from_numpy(mean), backbone="resnet18")
    tm.load_state_dict(h3dw_state_dict_from_flax(v["params"],
                                                 v["batch_stats"]),
                       strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("joints", [False, True],
                         ids=["H3DWEncoder", "H3DWJointsEncoder"])
def test_h3dw_encoders_match_jax(joints, rng):
    """Eval mode on carried weights, loaded strictly: feat and the 61
    parameters (H3DWEncoder) or the 66-dim decode (H3DWJointsEncoder)
    within 1e-4."""
    jm, v, tm = _h3dw_pair(joints, rng)
    x = rng.uniform(-1, 1, (2, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=ATOL_MODEL)
    if joints:
        assert got[0].shape == (2, 66)
        assert np.all(got[0][:, 6:9].numpy() == 0)   # joint 1 is the root
    else:
        assert got[1].shape == (2, 61)


def test_factory_frankmocap_and_its_refusals(tmp_path):
    """``--net frankmocap`` builds H3DWEncoder (61) and, for the keypoint
    contract, H3DWJointsEncoder (66) with the same keys (the decode's
    MANO arrays are none of them); the trainer refuses the 61-dim head,
    and the predictor serves it through the same decode as
    H3DWJointsEncoder's forward."""
    opt = Options(net="frankmocap", checkpoint_path_eval="")
    m, mean = build_model(opt)
    mj, _ = build_model(opt, for_keypoints=True)
    assert isinstance(m, H3DWEncoder) and not isinstance(m, H3DWJointsEncoder)
    assert isinstance(mj, H3DWJointsEncoder) and mean.shape == (61,)
    assert m.state_dict().keys() == mj.state_dict().keys()
    with pytest.raises(ValueError, match="61-dim"):
        Trainer(dataclasses.replace(opt, checkpoint_folder=str(tmp_path),
                                    debug=False), device="cpu")
    checkpoint.init_weights(m, seed=0)
    mj.load_state_dict(m.state_dict())
    x = np.random.RandomState(9).randint(0, 256, (3, 64, 64, 3)).astype(
        np.uint8)
    got = HandPosePredictor(model=m, image_size=64, device="cpu").predict(x)
    with torch.no_grad():
        want = mj.eval()(torch.from_numpy(x).float().permute(0, 3, 1, 2)
                         / 127.5 - 1.0)[0]
    np.testing.assert_allclose(got["camera"], want[:, :3].numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["joints_3d"].reshape(3, 63),
                               want[:, 3:].numpy(), atol=1e-6, rtol=0)


def test_smplx_glue_matches_jax(rng):
    """convert_smpl_to_bbox (both orders), convert_bbox_to_oriIm and
    extract_hand_output ("ave", "long", none) within 1e-6, on numpy and
    on tensors."""
    data = rng.randn(2, 21, 3).astype(np.float32)
    trans = rng.randn(2).astype(np.float32)
    for first in (False, True):
        want = np.asarray(jglue.convert_smpl_to_bbox(data, 1.3, trans,
                                                     first))
        for x in (data, torch.from_numpy(data)):
            got = smplx_glue.convert_smpl_to_bbox(x, 1.3, trans, first)
            np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)
    want = np.asarray(jglue.convert_bbox_to_oriIm(data, 0.7, [10.0, 20.0],
                                                  640, 480))
    for x in (data, torch.from_numpy(data)):
        got = smplx_glue.convert_bbox_to_oriIm(x, 0.7, [10.0, 20.0], 640,
                                               480)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)
    verts = rng.randn(2, 300, 3).astype(np.float32)
    joints = rng.randn(2, 55, 3).astype(np.float32)
    info = {}
    for side in ("left", "right"):
        info[f"{side}_hand_verts_idx"] = rng.choice(300, 120, replace=False)
        info[f"{side}_top_finger_long_vert_idx"] = rng.choice(300, 5)
        info[f"{side}_top_finger_ave_vert_idx"] = [
            rng.choice(120, 4, replace=False) for _ in range(5)]
        info[f"{side}_top_finger_ave_vert_weight"] = [
            rng.dirichlet(np.ones(4)) for _ in range(5)]
    for side in ("left", "right"):
        for kind in ("ave", "long", ""):
            want = jglue.extract_hand_output(jnp.asarray(verts),
                                             jnp.asarray(joints), side,
                                             info, kind)
            for v_, j_ in ((verts, joints), (torch.from_numpy(verts),
                                             torch.from_numpy(joints))):
                got = smplx_glue.extract_hand_output(v_, j_, side, info,
                                                     kind)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_allclose(
                        np.asarray(got[k]), np.asarray(want[k]), atol=1e-6,
                        err_msg=f"{side} {kind} {k}")
    with pytest.raises(ValueError):
        smplx_glue.extract_hand_output(verts, joints, "both", info)


def _write_crops(folder, rng, n=3):
    from PIL import Image
    os.makedirs(folder)
    for i, (w, h) in enumerate([(64, 48), (224, 224), (100, 130)][:n]):
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(folder, f"crop_{i}.png"))


@pytest.fixture
def small_h3dw(monkeypatch):
    """Both packages' factories build the resnet18 H3DW heads."""
    mean = assets.load_mean_mano_pose()

    def port(opt, image_size=224, for_keypoints=False):
        cls = H3DWJointsEncoder if for_keypoints else H3DWEncoder
        return cls(torch.from_numpy(mean), backbone="resnet18"), mean

    def jax_side(opt, image_size=224, for_keypoints=False):
        cls = (jhand_net.H3DWJointsEncoder if for_keypoints
               else jhand_net.H3DWEncoder)
        return cls(mean_params=jnp.asarray(mean), backbone="resnet18"), mean
    for mod in (tester, evaluator):
        monkeypatch.setattr(mod, "build_model", port)
    for mod in (jtester, jevaluator):
        monkeypatch.setattr(mod, "build_model", jax_side)


def test_tester_matches_jax(tmp_path, rng, small_h3dw, capsys):
    """The same crops and weights through both Testers (224 px, one
    image at a time): pred_params, joints_3d, verts within 1e-4, and
    joints_2d within 1e-4 of the 112-pixel half crop (its unit); the
    parameter files and the overlays (or the skip message)."""
    crops = str(tmp_path / "rgb")
    _write_crops(crops, rng)
    jm = jhand_net.H3DWEncoder(
        mean_params=jnp.asarray(assets.load_mean_mano_pose()),
        backbone="resnet18")
    v = flax_variables(jm, rng, np.zeros((1, IMG, IMG, 3), np.float32),
                       train=False)
    want = jtester.Tester(jconfig.Options(
        net="frankmocap", compute_dtype="float32",
        result_dir=str(tmp_path / "jax")), variables=v).test(crops)
    opt = Options(net="frankmocap", compute_dtype="float32",
                  result_dir=str(tmp_path / "port"))
    t = tester.Tester(opt, device="cpu",
                      state_dict=h3dw_state_dict_from_flax(
                          v["params"], v["batch_stats"]))
    got = t.test(crops)
    out = capsys.readouterr().out
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        for k, scale in (("pred_params", 1), ("joints_3d", 1), ("verts", 1),
                         ("joints_2d", 112.0)):
            assert np.isfinite(g[k]).all()
            np.testing.assert_allclose(g[k] / scale, w[k] / scale,
                                       atol=ATOL_MODEL, err_msg=k)
        stem = os.path.splitext(g["name"])[0]
        np.testing.assert_allclose(
            np.loadtxt(os.path.join(opt.result_dir, f"{stem}_params.txt")),
            g["pred_params"], rtol=1e-6)
        assert (os.path.exists(os.path.join(opt.result_dir,
                                            f"{stem}_overlay.png"))
                or "skipping the overlays" in out)


def test_tester_refuses_smplx_and_needs_cuda(tmp_path):
    opt = Options(hand_choice="smplx", result_dir=str(tmp_path))
    with pytest.raises(ValueError, match="smplx"):
        tester.Tester(opt, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tester.Tester(Options(checkpoint_path_eval="",
                                  result_dir=str(tmp_path)))


def test_evaluator_frankmocap_matches_jax(tmp_path, rng, small_h3dw):
    """``--net frankmocap`` through both Evaluators (H3DWJointsEncoder,
    the same weights and batches): MPJPE within 1%, AUC within 1e-3 (the
    bounds of test_torch_eval.py's)."""
    jm = jhand_net.H3DWJointsEncoder(
        mean_params=jnp.asarray(assets.load_mean_mano_pose()),
        backbone="resnet18")
    v = flax_variables(jm, rng, np.zeros((1, IMG, IMG, 3), np.float32),
                       train=False)
    sd = h3dw_state_dict_from_flax(v["params"], v["batch_stats"])
    tm, _ = evaluator.build_model(None, IMG, for_keypoints=True)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    batches = []
    for _ in range(2):
        img = rng.uniform(-1, 1, (BS, IMG, IMG, 3)).astype(np.float32)
        with torch.no_grad():
            pred = tm(torch.from_numpy(img).permute(0, 3, 1, 2))[0]
        j3d = pred[:, 3:].numpy() + rng.randn(BS, 63).astype(
            np.float32) * 0.01
        label = np.concatenate([j3d, rng.rand(BS, 42).astype(np.float32)
                                * 224], 1)
        batches.append({"image": img, "label": label,
                        "valid": np.ones(BS, np.float32)})
    want = jevaluator.Evaluator(
        jconfig.Options(net="frankmocap", batch_size=BS,
                        compute_dtype="float32",
                        result_dir=str(tmp_path / "jax")),
        image_size=IMG, variables=v, dataset=batches).eval()
    got = evaluator.Evaluator(
        Options(net="frankmocap", batch_size=BS, compute_dtype="float32",
                result_dir=str(tmp_path / "port")), image_size=IMG,
        dataset=[{k: torch.from_numpy(a) for k, a in b.items()}
                 for b in batches], state_dict=sd, device="cpu").eval()
    assert np.isfinite(got["mpjpe_mm"]) and 0 < got["auc"] <= 100
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-2)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-3)


def test_h3dw_checkpoint_roundtrip(tmp_path):
    """A reference-keyed H3DW .pth (the state_dict torch.save'd) loads
    strictly into both encoders through ``load_weights``."""
    m = H3DWEncoder(torch.from_numpy(assets.load_mean_mano_pose()),
                    backbone="resnet18")
    checkpoint.init_weights(m, seed=3)
    path = str(tmp_path / "h3dw.pth")
    torch.save({"state_dict": m.state_dict()}, path)
    for cls in (H3DWEncoder, H3DWJointsEncoder):
        n = cls(torch.from_numpy(assets.load_mean_mano_pose()),
                backbone="resnet18")
        checkpoint.load_weights(n, path)
        for k, val in m.state_dict().items():
            assert torch.equal(n.state_dict()[k], val), k
