"""The port's coarse head, ``--net reg_transformer_coarse``, against the
JAX package's, in float32 on the CPU: the attention block, the
attention-returning pyramid, the whole head in eval and train mode, the
train step (with the path-length probe), the eval step's attention, the
Evaluator's attention dump, ``train_coarse``, the factory and the
Trainer.

One small EncoderTransformerCoarse (resnet18, 64x64 crops, 2 heads) is
initialised once in flax and carried into the port by
``state_dict_from_flax(..., coarse=True)``; inputs come from a seeded
numpy RandomState and go to both sides.  Token masks are injected on
both sides (the JAX package draws them from jax.random)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.models.hand_net as jhand_net
from scat_tpu.models import transformer as jtransformer
from scat_tpu.training import schedule as jschedule
from scat_tpu.training import steps as jsteps
from scat_tpu.training.state import TrainState as JState
from scat_tpu.utils.torch_import import export_torch_encoder_transformer
from scat_tpu_torch import assets, train_coarse
from scat_tpu_torch.config import Options
from scat_tpu_torch.evaluation import evaluator
from scat_tpu_torch.models import transformer
from scat_tpu_torch.models.factory import build_model
from scat_tpu_torch.models.hand_net import EncoderTransformerCoarse
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.training import schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.utils.weights import state_dict_from_flax

IMG, BS = 64, 2
W3D, W2D = 1e5, 10.0   # script/ablation_pose.sh
FLAGS = np.zeros(21, bool)
FLAGS[[2, 7, 11, 19]] = True


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.array(tree)


def _randomize_bn(tree, rng):
    for k, sub in tree.items():
        if k == "mean":
            tree[k] = rng.uniform(-0.1, 0.1, sub.shape).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)
        else:
            _randomize_bn(sub, rng)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _jmodel(**kw):
    return jhand_net.EncoderTransformerCoarse(
        mean_params=jnp.asarray(assets.load_mean_params()), heads=2,
        token_dim=(IMG // 8) ** 2, backbone="resnet18", **kw)


def _tmodel(**kw):
    return EncoderTransformerCoarse(
        mean_params=torch.from_numpy(assets.load_mean_params()), heads=2,
        token_dim=(IMG // 8) ** 2, backbone="resnet18", **kw)


@pytest.fixture(scope="module")
def flax_init():
    """(params, batch_stats) of one flax init of the small coarse head,
    with non-trivial running statistics."""
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    v = jax.jit(lambda x: _jmodel().init(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, x,
        train=False))(x)
    bs = _unfreeze(v["batch_stats"])
    _randomize_bn(bs, np.random.RandomState(5))
    return _unfreeze(v["params"]), bs


def _ported(params, bs, **kw):
    tm = _tmodel(**kw)
    tm.load_state_dict(state_dict_from_flax(params, bs, coarse=True),
                       strict=True)
    return tm


def _images(rng, n=BS):
    return (rng.randn(n, IMG, IMG, 3) * 0.5).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _batch(rng):
    """Root-centred 3D targets near the mean template, pixel 2D."""
    offsets = assets.load_mean_params()[3:66].reshape(21, 3)
    j3d = (offsets[None] + rng.randn(BS, 21, 3) * 0.02).astype(np.float32)
    j3d -= j3d[:, 1:2]
    j2d = (rng.rand(BS, 21, 2) * 180 + 22).astype(np.float32)
    return _images(rng), np.concatenate([j3d.reshape(BS, 63),
                                         j2d.reshape(BS, 42)], 1)


def test_attention_block_returns_the_softmax(rng):
    """A bare Attention with return_attn, against the JAX package's: the
    output and the softmax matrix within 1e-5; rows of P sum to 1."""
    x = rng.randn(2, 21, 64).astype(np.float32)
    jm = jtransformer.Attention(dim=64, heads=2)
    params = _unfreeze(jm.init(jax.random.key(1), x)["params"])
    want, want_attn = jm.apply({"params": params}, x, None,
                               return_attn=True)
    tm = transformer.Attention(64, heads=2)
    tm.load_state_dict({
        "to_qkv.weight": torch.from_numpy(params["to_qkv"]["kernel"].T),
        "to_out.0.weight": torch.from_numpy(params["to_out"]["kernel"].T),
        "to_out.0.bias": torch.from_numpy(params["to_out"]["bias"])},
        strict=True)
    with torch.no_grad():
        got, attn = tm(torch.from_numpy(x), return_attn=True)
        plain = tm(torch.from_numpy(x))
    assert attn.shape == (2, 2, 21, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn),
                               atol=1e-5)
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, atol=1e-5)
    torch.testing.assert_close(plain, got, atol=0, rtol=0)


def test_pyramid_transformer_attn_matches_jax(rng):
    """The post-norm pyramid against PyramidTransformerAttn: the output
    [B,21,3] and the last layer's attention within 1e-5."""
    x = rng.randn(2, 21, 64).astype(np.float32)
    jm = jtransformer.PyramidTransformerAttn(dim=64, depth=3, heads=2)
    params = _unfreeze(jm.init(jax.random.key(2), x)["params"])
    want, want_attn = jm.apply({"params": params}, x)
    tm = transformer.PyramidTransformerAttn(dim=64, depth=3, heads=2)
    tm.load_state_dict(_strip(state_dict_from_flax(
        {"transformer": params}, coarse=True), "transformer."), strict=True)
    with torch.no_grad():
        got, attn = tm(torch.from_numpy(x))
    assert got.shape == (2, 21, 3) and attn.shape == (2, 2, 21, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn),
                               atol=1e-5)


def test_state_dict_keys_are_the_reference_layout(flax_init):
    """The port's keys are the JAX package's export with coarse=True (the
    reference's vision_transformer_attn nesting), loaded strictly."""
    params, bs = flax_init
    want = set(export_torch_encoder_transformer(params, bs, coarse=True))
    sd = state_dict_from_flax(params, bs, coarse=True)
    assert set(sd) == want
    assert set(_tmodel().state_dict()) == want
    assert "transformer.layers.0.0.to_qkv.weight" in want
    assert "transformer.layers.1.1.norm.weight" in want
    assert "transformer.layers.2.2.net.0.weight" in want


def test_coarse_head_matches_jax_in_eval_mode(flax_init, rng):
    """The whole head in eval mode: pred (camera from its own regressor,
    root-centred joints), the 21-channel map and the attention, within
    ATOL 1e-3 (tests/test_full_model_parity.py's bar)."""
    params, bs = flax_init
    x = _images(rng)
    jm = _jmodel()
    want = jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=False))(params, bs, x)
    tm = _ported(params, bs).eval()
    with torch.no_grad():
        got = tm(_nchw(x))
    assert len(got) == 3
    pred, fmap, attn = got
    assert pred.shape == (BS, 66) and attn.shape == (BS, 2, 21, 21)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want[0]), atol=1e-3)
    np.testing.assert_allclose(fmap.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want[1]), atol=1e-3)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want[2]), atol=1e-3)
    assert torch.all(pred[:, 6:9] == 0), "joint 1 is the root"


def test_coarse_head_masks_tokens_as_jax(flax_init, rng, monkeypatch):
    """Train mode with mask_rate 0.2 and the same flags on both sides:
    the same prediction and attention; other flags give others."""
    params, bs = flax_init
    monkeypatch.setattr(jhand_net, "random_token_mask",
                        lambda key, n, rate: jnp.asarray(FLAGS))
    x = _images(rng)
    jm = _jmodel(mask_rate=0.2)
    (want, _, want_attn), _ = jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=True,
        rngs={"mask": jax.random.key(0)}, mutable=["batch_stats"]))(
            params, bs, x)
    tm = _ported(params, bs, mask_rate=0.2).train()
    got, _, attn = tm(_nchw(x), token_mask=torch.from_numpy(FLAGS))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-3)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               atol=1e-3)
    flags = tm.train_inputs(BS, torch.Generator().manual_seed(0))
    assert flags["token_mask"].shape == (21,)
    assert int(flags["token_mask"].sum()) == int(0.2 * 21)
    other, _, _ = tm(_nchw(x), token_mask=torch.from_numpy(~FLAGS))
    assert not torch.allclose(other, got, atol=1e-3)


def _port_state(model):
    opt, sched = schedule.make_optimizer(model, 5e-4, 4)
    return TrainState.create(model, opt, sched, seed=0)


@pytest.mark.parametrize("pl_reg", [False, True])
def test_train_step_matches_jax(flax_init, rng, monkeypatch, pl_reg):
    """One train step from one init on one batch with injected token
    masks, against make_train_step: the loss (and the PL term), the
    updated regressor and the BN running statistics.  The loss of the
    second step shows that the update agrees too."""
    params, bs = flax_init
    monkeypatch.setattr(jhand_net, "random_token_mask",
                        lambda key, n, rate: jnp.asarray(FLAGS))
    batches = [_batch(rng) for _ in range(2)]
    jm = _jmodel(mask_rate=0.2, pl_reg=pl_reg)
    tx = jschedule.make_optimizer(5e-4, 4)
    jstate = JState.create(params, bs, tx, jax.random.key(1))
    jstep = jax.jit(jsteps.make_train_step(jm, tx, W3D, W2D, pl_reg=pl_reg))
    model = _ported(params, bs, mask_rate=0.2, pl_reg=pl_reg)
    model.train_inputs = lambda n, g: {"token_mask": torch.from_numpy(FLAGS)}
    state = _port_state(model)
    step = steps.make_train_step(W3D, W2D, pl_reg=pl_reg)
    for i, (img, lab) in enumerate(batches):
        jstate, jstats = jstep(jstate, {"image": jnp.asarray(img),
                                        "label": jnp.asarray(lab),
                                        "valid": jnp.ones(BS)})
        stats = step(state, {"image": torch.from_numpy(img),
                             "label": torch.from_numpy(lab),
                             "valid": torch.ones(BS)})
        for k in ("loss", "loss_3d", "loss_2d") + (("loss_pl",) if pl_reg
                                                   else ()):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=1e-3 if i == 0 else 5e-3,
                                       err_msg=f"step {i} {k}")
    if pl_reg:
        assert float(stats["loss_pl"]) > 0
    sd = state.model.state_dict()
    np.testing.assert_allclose(
        sd["regressor.weight"].numpy(),
        np.asarray(jstate.params["regressor"]["kernel"]).T, atol=1e-4)
    jb = jstate.batch_stats["main_encoder"]
    for mod, flax_mod in (("bn1", ("bn1",)),
                          ("layer2.0.bn1", ("layer2_0", "BatchNorm_0"))):
        node = jb
        for k in flax_mod:
            node = node[k]
        for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                sd[f"main_encoder.{mod}.{name}"].numpy(),
                np.asarray(node[leaf]), atol=1e-4, rtol=1e-4,
                err_msg=f"{mod} {name}")


def test_eval_step_returns_the_attention(flax_init, rng):
    """make_eval_step(return_attn=True) against the JAX package's: the
    same joints and the attention of the same forward; without it, no
    attention."""
    params, bs = flax_init
    img, lab = _batch(rng)
    jbatch = {"image": jnp.asarray(img), "label": jnp.asarray(lab),
              "valid": jnp.ones(BS)}
    want = jax.jit(jsteps.make_eval_step(_jmodel(), return_attn=True))(
        params, bs, jbatch)
    tm = _ported(params, bs)
    tbatch = {"image": torch.from_numpy(img), "label": torch.from_numpy(lab),
              "valid": torch.ones(BS)}
    got = steps.make_eval_step(tm, return_attn=True)(tbatch)
    np.testing.assert_allclose(got["attn"].numpy(), np.asarray(want["attn"]),
                               atol=1e-3)
    for k in ("pred_joints_3d", "mpjpe_per_sample"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    assert "attn" not in steps.make_eval_step(tm)(tbatch)


def _eval_opt(tmp_path, debug=True):
    return Options(net="reg_transformer_coarse", vit_heads=2, batch_size=BS,
                   compute_dtype="float32", debug=debug,
                   checkpoint_path_eval="",
                   result_dir=str(tmp_path / "eval"))


@pytest.mark.parametrize("cv2_present", [True, False])
def test_evaluator_dumps_the_attention(tmp_path, flax_init, rng, monkeypatch,
                                       capsys, cv2_present):
    """--net reg_transformer_coarse --debug True: each batch of two writes
    attn/{finger}/NNN.png for the five fingers, or, where cv2 is missing,
    the Evaluator prints its skip message once and computes the
    metrics."""
    params, bs = flax_init
    monkeypatch.setattr(evaluator, "build_model",
                        lambda opt, image_size=224, for_keypoints=False: (
                            _tmodel(), assets.load_mean_params()))
    if not cv2_present:
        real = evaluator.importlib.util.find_spec
        monkeypatch.setattr(evaluator.importlib.util, "find_spec",
                            lambda name, *a: None if name == "cv2"
                            else real(name, *a))
    batches = []
    for _ in range(2):
        img, lab = _batch(rng)
        batches.append({"image": torch.from_numpy(img),
                        "label": torch.from_numpy(lab),
                        "valid": torch.ones(BS)})
    opt = _eval_opt(tmp_path)
    ev = evaluator.Evaluator(opt, image_size=IMG, dataset=batches,
                             state_dict=state_dict_from_flax(
                                 params, bs, coarse=True), device="cpu")
    result = ev.eval()
    out = capsys.readouterr().out
    assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])
    folder = os.path.join(opt.result_dir, "attn")
    if cv2_present:
        import cv2
        for finger in ("index", "thumb", "middle", "ring", "little"):
            for n in (1, 2):
                img = cv2.imread(os.path.join(folder, finger, f"{n:03d}.png"))
                assert img is not None and img.shape == (224 * 6, 224 * 6, 3)
        assert "skipping the attention dump" not in out
    else:
        assert out.count("skipping the attention dump") == 1
        assert not os.path.exists(folder)


def test_evaluator_without_debug_asks_for_no_attention(tmp_path):
    ev = evaluator.Evaluator(_eval_opt(tmp_path, debug=False),
                             image_size=IMG, device="cpu")
    assert not ev.want_attn


def test_train_coarse_defaults_to_the_coarse_head(monkeypatch):
    """``python -m scat_tpu_torch.train_coarse``: the default --net ViT
    trains reg_transformer_coarse; another net is kept."""
    seen = []

    class _Recorder:
        def __init__(self, opt):
            seen.append(opt.net)

        def train(self):
            pass

    monkeypatch.setattr(train_coarse, "Trainer", _Recorder)
    train_coarse.main([])
    train_coarse.main(["--net", "reg_transformer"])
    assert seen == ["reg_transformer_coarse", "reg_transformer"]


def test_factory_builds_the_coarse_head():
    """BatchNorm whatever --norm_layer says, no attention kernel whatever
    --use_pallas_attention says, and the pl_reg flag, as the JAX
    package's factory builds it."""
    m, mean = build_model(Options(net="reg_transformer_coarse", vit_heads=2,
                                  norm_layer="group", pl_reg=True,
                                  use_pallas_attention=True), image_size=32)
    assert isinstance(m, EncoderTransformerCoarse) and mean.shape == (66,)
    assert m.pl_reg
    assert not any(isinstance(x, torch.nn.GroupNorm) for x in m.modules())
    assert not any(getattr(x, "use_kernel", False) for x in m.modules())


def test_trainer_trains_and_serves_the_coarse_head(tmp_path, capsys):
    """The Trainer on the synthetic task (2 epochs of 2 steps, masking),
    its final file served by HandPosePredictor as it is, and the
    fresh init scaled as flax's."""
    opt = Options(net="reg_transformer_coarse", batch_size=2, lr=5e-4,
                  epoch=2, l_weight_3d=W3D, l_weight_2d=W2D, vit_heads=2,
                  mask_rate=0.2, synthetic_data=True, debug=False,
                  steps_per_epoch=2, log_every=1, compute_dtype="float32",
                  checkpoint_folder=str(tmp_path / "ckpt"))
    trainer = Trainer(opt, device="cpu", image_size=32)
    assert isinstance(trainer.model, EncoderTransformerCoarse)
    std = trainer.model.regressor.weight.std().item()
    assert abs(std - (1 / (1024 + 3)) ** 0.5) < 0.1 * std   # lecun normal
    trainer.train()
    out = capsys.readouterr().out
    assert "[2,     2] loss:" in out and trainer.state.step == 4
    path = os.path.join(opt.checkpoint_folder, checkpoint.FINAL_NAME)
    pred = HandPosePredictor.from_checkpoint(
        dataclasses.replace(opt, checkpoint_path_eval=path), image_size=32,
        device="cpu")
    got = pred.predict(np.zeros((3, 32, 32, 3), np.uint8))
    assert got["joints_3d"].shape == (3, 21, 3)
    assert np.isfinite(got["joints_3d"]).all()
    assert np.all(got["joints_3d"][:, 1] == 0)
