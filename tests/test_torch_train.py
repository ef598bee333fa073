"""The port's training slice against the JAX package's, in float32 on the
CPU: train-mode BatchNorm, token masking, the path-length probe, the
train step over 12 steps, grad accumulation, --freeze, the eval step,
checkpoints and the Trainer.

One small EncoderTransformer (resnet18, 64x64 crops, 2 heads, iteration
3) is initialized once in flax and carried into the port by
``state_dict_from_flax``; inputs come from a seeded numpy RandomState.
The JAX side takes its plain attention path (its Pallas kernel is held
against the port in tests/test_torch_attention.py); the port takes its
kernel wrapper, which runs the plain version on CPU tensors."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.models.hand_net as jhand_net
from scat_tpu.data.synthetic import synth_batch as jsynth_batch
from scat_tpu.models import losses as jlosses
from scat_tpu.models import resnet as jresnet
from scat_tpu.training import schedule as jschedule
from scat_tpu.training import steps as jsteps
from scat_tpu.training.state import TrainState as JState
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.models import losses, resnet
from scat_tpu_torch.models.factory import build_model
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.training import schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.utils.weights import state_dict_from_flax

IMG, BS = 64, 2
BASE_LR, W3D, W2D = 5e-4, 1e5, 10.0   # script/ablation_pose.sh
STEPS_PER_EPOCH, EPOCHS = 4, 3         # 12 steps inside the warmup ramp


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


def _jmodel(**kw):
    return jhand_net.EncoderTransformer(
        mean_params=jnp.asarray(assets.load_mean_params()), iteration=3,
        heads=2, token_dim=(IMG // 8) ** 2, backbone="resnet18",
        use_pallas=False, **kw)


def _tmodel(**kw):
    return EncoderTransformer(
        mean_params=torch.from_numpy(assets.load_mean_params()),
        iteration=3, heads=2, token_dim=(IMG // 8) ** 2,
        backbone="resnet18", use_kernel=True, **kw)


@pytest.fixture(scope="module")
def flax_init():
    """(params, batch_stats) of one flax init of the small model."""
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    v = jax.jit(lambda x: _jmodel().init(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, x,
        train=False))(x)
    return _unfreeze(v["params"]), _unfreeze(v["batch_stats"])


def _ported(params, bs, **kw):
    tm = _tmodel(**kw)
    tm.load_state_dict(state_dict_from_flax(params, bs), strict=True)
    return tm


def _images(rng, n=BS):
    return (rng.randn(n, IMG, IMG, 3) * 0.5).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_resnet_train_mode_matches_flax(rng):
    """One train-mode forward: the outputs and the mutated running
    statistics, with flax's biased running-variance update (the
    unbiased one would be 2x larger in layer4, where bs 2 x 2x2 maps
    gives n = 8, and 8/7 there)."""
    x = _images(rng)
    jm = jresnet.resnet18()
    v = jax.jit(lambda x: jm.init(jax.random.key(0), x, train=False))(x)
    params, bs = _unfreeze(v["params"]), _unfreeze(v["batch_stats"])
    _randomize_bn(bs, rng)
    want, mutated = jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=True,
        mutable=["batch_stats"]))(params, bs, x)
    sd = state_dict_from_flax({"main_encoder": params},
                              {"main_encoder": bs})
    tm = resnet.get_model("resnet18")
    tm.load_state_dict({k[len("main_encoder."):]: t for k, t in sd.items()},
                       strict=True)
    tm.train()
    got = tm(_nchw(x))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               atol=1e-4, err_msg="fc1 feature")
    np.testing.assert_allclose(
        got[4].detach().numpy().transpose(0, 2, 3, 1), np.asarray(want[4]),
        atol=1e-4, err_msg="x4")
    new = state_dict_from_flax({"main_encoder": params},
                               {"main_encoder": _unfreeze(mutated)[
                                   "batch_stats"]})
    mine = tm.state_dict()
    n_stats = 0
    for k, t in new.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                mine[k[len("main_encoder."):]].numpy(), t.numpy(),
                atol=1e-5, rtol=1e-5, err_msg=k)
            n_stats += 1
    assert n_stats == 2 * 20   # every BN of resnet18 (with downsamples)


def test_masked_head_matches_jax(flax_init, rng, monkeypatch):
    """Train mode with mask_rate 0.2: the same flags injected on both
    sides (the JAX package draws them from jax.random), same outputs."""
    params, bs = flax_init
    flags = np.zeros(21, bool)
    flags[[2, 7, 11, 19]] = True
    monkeypatch.setattr(jhand_net, "random_token_mask",
                        lambda key, n, rate: jnp.asarray(flags))
    x = _images(rng)
    jm = _jmodel(mask_rate=0.2)
    (want, _), _ = jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=True,
        rngs={"mask": jax.random.key(0)}, mutable=["batch_stats"]))(
            params, bs, x)
    tm = _ported(params, bs, mask_rate=0.2).train()
    got, _ = tm(_nchw(x), token_mask=torch.from_numpy(flags))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-3)
    # the mask is live: other flags give another prediction
    other, _ = tm(_nchw(x), token_mask=torch.from_numpy(~flags))
    assert not torch.allclose(other, got, atol=1e-3)


def _batches(rng, count):
    """Identical batches for both frameworks: root-centred 3D targets
    near the mean template, pixel-space 2D (the recipe of
    tests/test_training_dynamics_parity.py)."""
    offsets = assets.load_mean_params()[3:66].reshape(21, 3)
    out = []
    for _ in range(count):
        j3d = (offsets[None] + rng.randn(BS, 21, 3) * 0.02).astype(
            np.float32)
        j3d -= j3d[:, 1:2]
        j2d = (rng.rand(BS, 21, 2) * 180 + 22).astype(np.float32)
        lab = np.concatenate([j3d.reshape(BS, 63), j2d.reshape(BS, 42)], 1)
        out.append((_images(rng), lab))
    return out


def _port_state(model, freeze=False, seed=0):
    opt, sched = schedule.make_optimizer(model, BASE_LR, STEPS_PER_EPOCH,
                                         freeze_backbone=freeze)
    return TrainState.create(model, opt, sched, seed=seed)


def _tbatch(img, lab, valid=None):
    b = {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)}
    b["valid"] = (torch.ones(img.shape[0]) if valid is None
                  else torch.from_numpy(valid))
    return b


def test_train_trajectory_matches_jax(flax_init, rng):
    """12 float32 steps from one init on identical batches, against
    make_train_step: losses within the widening ladder of
    tests/test_training_dynamics_parity.py (round-off compounds through
    the 1e5-weighted loss, Adam and bs-2 BatchNorm), then the updated
    regressor, stem and BN statistics."""
    params, bs = flax_init
    batches = _batches(rng, STEPS_PER_EPOCH * EPOCHS)
    jm = _jmodel()
    tx = jschedule.make_optimizer(BASE_LR, STEPS_PER_EPOCH)
    jstate = JState.create(params, bs, tx, jax.random.key(1))
    jstep = jax.jit(jsteps.make_train_step(jm, tx, W3D, W2D))
    state = _port_state(_ported(params, bs))
    step = steps.make_train_step(W3D, W2D)
    jl, tl = [], []
    for img, lab in batches:
        jstate, jstats = jstep(jstate, {"image": jnp.asarray(img),
                                        "label": jnp.asarray(lab),
                                        "valid": jnp.ones(BS)})
        jl.append(float(jstats["loss"]))
        tl.append(float(step(state, _tbatch(img, lab))["loss"]))
    jl, tl = np.asarray(jl), np.asarray(tl)
    rel = np.abs(tl - jl) / np.abs(jl)
    assert rel[0] < 1e-3, (tl[0], jl[0])
    assert rel[1] < 5e-3, rel[:2]
    assert np.all(rel[:4] < 3e-2), rel[:4]
    assert np.all(rel < 0.3), rel
    assert tl[-1] < 0.5 * tl[0] and jl[-1] < 0.5 * jl[0]
    assert state.step == len(batches)
    sd = state.model.state_dict()
    jp, jb = jstate.params, jstate.batch_stats
    # Adam moves a weight <= lr ~ 1e-4 a step: agreement at 1e-3 after 12
    # steps means the same updates
    np.testing.assert_allclose(sd["regressor.weight"].numpy(),
                               np.asarray(jp["regressor"]["kernel"]).T,
                               atol=1e-3)
    np.testing.assert_allclose(
        sd["main_encoder.conv1.weight"].numpy(),
        np.asarray(jp["main_encoder"]["conv1"]["kernel"]).transpose(
            3, 2, 0, 1), atol=1e-3)
    # BN statistics, updated with the same momentum and the biased
    # variance: the stem's (n = 2*32*32) to 2e-5, where an unbiased update
    # would be off by ~1e-4 after 12 steps; layer4's (n = 8, where the
    # unbiased update is 8/7 of flax's) to 1e-2, 2% of their magnitude:
    # its statistics of 8 values amplify the round-off the ladder allows
    for mod, flax_mod, atol in (("bn1", ("bn1",), 2e-5),
                                ("layer4.1.bn2",
                                 ("layer4_1", "BatchNorm_1"), 1e-2)):
        node = jb["main_encoder"]
        for k in flax_mod:
            node = node[k]
        for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                sd[f"main_encoder.{mod}.{name}"].numpy(),
                np.asarray(node[leaf]), atol=atol, err_msg=f"{mod} {name}")


class _PerSampleHead(torch.nn.Module):
    """A batch-independent model with the (pred, feat) contract, so that
    accumulation over microbatches must equal the full batch."""

    mask_rate = 0.0

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = torch.nn.Parameter(torch.randn(8 * 8 * 3, 32,
                                                generator=g) * 0.05)
        self.b = torch.nn.Parameter(torch.randn(32, 66, generator=g) * 0.1)

    def forward(self, x, token_mask=None):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ self.a)
        return h @ self.b, h


@pytest.mark.parametrize("valid", [None, [1, 1, 0, 1, 0, 0, 1, 1]])
def test_grad_accum_equals_full_batch(rng, valid):
    """grad_accum 2 and 4 give the full batch's update, including a valid
    mask that empties rows unevenly (keypoint terms weighted by each
    microbatch's valid share); to float32 round-off, 1e-6."""
    img = rng.uniform(-1, 1, (8, 8, 8, 3)).astype(np.float32)
    lab = rng.randn(8, 105).astype(np.float32)
    v = None if valid is None else np.asarray(valid, np.float32)
    results = {}
    for accum in (1, 2, 4):
        state = _port_state(_PerSampleHead())
        stats = steps.make_train_step(W3D, W2D, grad_accum=accum)(
            state, _tbatch(img, lab, v))
        results[accum] = (stats, [p.detach().clone()
                                  for p in state.model.parameters()])
    for accum in (2, 4):
        for a, b in zip(results[accum][1], results[1][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
        for k in ("loss", "loss_3d", "loss_2d"):
            torch.testing.assert_close(results[accum][0][k],
                                       results[1][0][k], rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="divisible"):
        steps.make_train_step(W3D, W2D, grad_accum=3)(
            _port_state(_PerSampleHead()), _tbatch(img, lab))


def test_freeze_leaves_backbone_unchanged(flax_init, rng):
    params, bs = flax_init
    state = _port_state(_ported(params, bs), freeze=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    img, lab = _batches(rng, 1)[0]
    steps.make_train_step(W3D, W2D)(state, _tbatch(img, lab))
    after = state.model.state_dict()
    params_of = dict(state.model.named_parameters())
    for k, v in after.items():
        if k in params_of and k.startswith("main_encoder."):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(after["regressor.weight"],
                           before["regressor.weight"])
    # BatchNorm statistics still update
    assert not torch.equal(after["main_encoder.bn1.running_mean"],
                           before["main_encoder.bn1.running_mean"])


def test_pl_probe_matches_jax(flax_init, rng):
    """pl_grad (d sum(feat_out) / d feat_visual) and l_pl against the JAX
    package's nn.vjp probe, in eval mode (no batch statistics)."""
    params, bs = flax_init
    x = _images(rng)
    jm = _jmodel(pl_reg=True)
    jpred, _, jgrad = jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=False))(params, bs, x)
    jl, _ = jlosses.path_length_loss(jgrad, jnp.zeros(()))
    tm = _ported(params, bs, pl_reg=True).eval()
    pred, fv, grad = tm(_nchw(x))
    assert grad.shape == fv.shape
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               atol=1e-3)
    np.testing.assert_allclose(grad.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jgrad), atol=1e-4, rtol=1e-4)
    tl, _ = losses.path_length_loss(grad, torch.zeros(()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-3)
    with torch.no_grad():
        assert tm(_nchw(x))[2] is None   # no probe where nothing records
    # a full pl_reg step differentiates the probe (double backward)
    state = _port_state(_ported(params, bs, pl_reg=True))
    stats = steps.make_train_step(W3D, W2D, pl_reg=True)(
        state, _tbatch(*_batches(rng, 1)[0]))
    assert torch.isfinite(stats["loss"]) and float(stats["loss_pl"]) > 0


def test_pl_reg_takes_the_plain_attention_path(capsys):
    model, _ = build_model(Options(net="reg_transformer", vit_heads=2,
                                   pl_reg=True), image_size=32)
    assert "double-backward" in capsys.readouterr().out
    assert model.pl_reg
    assert not any(m.use_kernel for m in model.modules()
                   if hasattr(m, "use_kernel"))


def test_eval_step_matches_jax(flax_init):
    params, bs = flax_init
    jbatch = jsynth_batch(jax.random.key(3), 4, image_size=IMG)
    want = jax.jit(jsteps.make_eval_step(_jmodel()))(params, bs, jbatch)
    tm = _ported(params, bs).train()
    got = steps.make_eval_step(tm)(
        {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()})
    assert tm.training    # the mode is restored
    for k in ("pred_joints_3d", "mpjpe_per_sample"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["pred_joints_2d"].numpy(),
                               np.asarray(want["pred_joints_2d"]),
                               atol=0.1, err_msg="pixels")
    np.testing.assert_allclose(got["pck"].numpy(), np.asarray(want["pck"]),
                               atol=1e-3)


def _train_opt(tmp_path, **kw):
    base = dict(net="reg_transformer", batch_size=2, lr=BASE_LR, epoch=2,
                l_weight_3d=W3D, l_weight_2d=W2D, vit_heads=2, iteration=3,
                mask_rate=0.2, synthetic_data=True, debug=False,
                steps_per_epoch=2, log_every=1, compute_dtype="float32",
                checkpoint_folder=str(tmp_path / "ckpt"))
    base.update(kw)
    return Options(**base)


def test_checkpoint_roundtrip_and_bitwise_resume(flax_init, rng, tmp_path):
    params, bs = flax_init
    batches = [_tbatch(*b) for b in _batches(rng, 3)]
    step = steps.make_train_step(W3D, W2D)
    straight = _port_state(_ported(params, bs, mask_rate=0.2))
    for b in batches:
        step(straight, b)
    first = _port_state(_ported(params, bs, mask_rate=0.2))
    for b in batches[:2]:
        step(first, b)
    path = checkpoint.save_state(str(tmp_path), first)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    assert set(sd) == {"state_dict", "optimizer", "scheduler", "generator",
                       "step", "pl_mean"}
    resumed = _port_state(_ported(params, bs, mask_rate=0.2), seed=9)
    assert checkpoint.restore_state(path, resumed)
    assert resumed.step == 2
    step(resumed, batches[2])
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert not checkpoint.restore_state(str(tmp_path / "missing.pth"),
                                        resumed)


def test_fused_preprocess_step_is_warp_then_step(flax_init, rng):
    """make_fused_preprocess_train_step on raw uint8 frames and their crop
    affines equals make_train_step on the frames warped and normalised
    beforehand (preprocess.affine_sample with fill -1), bit for bit."""
    from scat_tpu_torch.data import preprocess
    params, bs = flax_init
    raw = (rng.rand(BS, 80, 96, 3) * 255).astype(np.uint8)
    hints = np.stack([rng.uniform(20, 70, (BS, 21)),
                      rng.uniform(15, 60, (BS, 21))], -1).astype(np.float32)
    M, _ = preprocess.crop_hand_affine(torch.from_numpy(hints), 96.0, 80.0,
                                       IMG)
    lab = _batches(rng, 1)[0][1]
    fused, plain = (_port_state(_ported(params, bs)) for _ in range(2))
    stats = steps.make_fused_preprocess_train_step(W3D, W2D, out_size=IMG)(
        fused, {"raw_image": torch.from_numpy(raw), "affine": M,
                "label": torch.from_numpy(lab)})
    images = preprocess.affine_sample(
        preprocess.normalize_to_unit(torch.from_numpy(raw)), M, IMG, IMG,
        fill=-1.0)
    want = steps.make_train_step(W3D, W2D)(
        plain, {"image": images, "label": torch.from_numpy(lab),
                "valid": torch.ones(BS)})
    assert torch.equal(stats["loss"], want["loss"])
    for (k, a), b in zip(fused.model.state_dict().items(),
                         plain.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_trained_pth_loads_into_predictor(flax_init, rng, tmp_path):
    params, bs = flax_init
    state = _port_state(_ported(params, bs))
    steps.make_train_step(W3D, W2D)(state, _tbatch(*_batches(rng, 1)[0]))
    path = checkpoint.save_state(str(tmp_path), state,
                                 checkpoint.FINAL_NAME)
    pred = HandPosePredictor(model=_tmodel(), image_size=IMG, device="cpu")
    checkpoint.load_weights(pred.model, path)
    crops = (rng.rand(3, IMG, IMG, 3) * 255).astype(np.uint8)
    state.model.eval()
    with torch.no_grad():
        x = torch.from_numpy(crops).float() / 127.5 - 1.0
        want = state.model(x.permute(0, 3, 1, 2))[0][:, 3:].reshape(-1, 21,
                                                                     3)
    np.testing.assert_allclose(pred.predict(crops)["joints_3d"],
                               want.numpy(), atol=1e-5)


def test_pretrained_backbone_and_reference_resume(tmp_path):
    """--pretrained_resnet_pth merges a torchvision-layout ResNet into
    main_encoder (a file that matches nothing raises); --resume from a
    reference weights-only .pth merges the weights, non-strict, and the
    optimizer starts fresh."""
    donor = resnet.get_model("resnet18")
    torch.nn.init.normal_(donor.conv1.weight, generator=torch.Generator()
                          .manual_seed(0))
    sd = dict(donor.state_dict())
    sd["fc.weight"] = torch.zeros(1000, 512)   # torchvision's classifier
    path = str(tmp_path / "resnet18.pth")
    torch.save(sd, path)
    tm = _tmodel()
    assert checkpoint.load_pretrained_backbone(tm, path) == len(sd) - 1
    assert torch.equal(tm.main_encoder.conv1.weight, donor.conv1.weight)
    bad = str(tmp_path / "bad.pth")
    torch.save({"encoder.w": torch.zeros(3)}, bad)
    with pytest.raises(ValueError, match="no tensor matched"):
        checkpoint.load_pretrained_backbone(tm, bad)
    ref = str(tmp_path / "hand_net.pth")
    torch.save({"state_dict": tm.state_dict()}, ref)
    state = _port_state(_tmodel())
    assert checkpoint.restore_state(ref, state) and state.step == 0
    assert torch.equal(state.model.main_encoder.conv1.weight,
                       donor.conv1.weight)


def test_trainer_on_cpu(tmp_path, capsys):
    opt = _train_opt(tmp_path)
    trainer = Trainer(opt, device="cpu", image_size=32)
    trainer.train()
    out = capsys.readouterr().out
    assert "[1,     1] loss:" in out and "[2,     2] loss:" in out
    assert "epoch 2:" in out and "samples/s" in out
    assert trainer.state.step == 4
    folder = opt.checkpoint_folder
    assert os.path.exists(os.path.join(folder, checkpoint.FINAL_NAME))
    assert os.path.exists(os.path.join(folder, checkpoint.PERIODIC_NAME))
    with open(os.path.join(folder, "metrics.csv")) as f:
        assert len(f.readlines()) == 1 + 4
    # the final checkpoint serves as it is
    pred = HandPosePredictor.from_checkpoint(
        dataclasses.replace(opt, checkpoint_path_eval=os.path.join(
            folder, checkpoint.FINAL_NAME)), image_size=32, device="cpu")
    assert np.isfinite(pred.predict(np.zeros((1, 32, 32, 3), np.uint8))[
        "joints_3d"]).all()
    # --resume picks the full state up
    again = Trainer(dataclasses.replace(
        opt, resume=True, checkpoint_hand=os.path.join(
            folder, checkpoint.FINAL_NAME)), device="cpu", image_size=32)
    assert again.success_load and again.state.step == 4


def test_trainer_needs_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_train_opt(tmp_path), image_size=32)


@pytest.mark.parametrize("flags,item", [
    pytest.param(dict(param_sharding="fsdp"), 17, id="flags1-17"),
    pytest.param(dict(mesh_shape="data:-1,model:1,seq:1,pipe:1"), 17,
                 id="flags2-17")])
def test_unported_flags_name_their_item(tmp_path, flags, item):
    """The flags that ROADMAP.md queue 1 item 17 ported (FSDP, the mesh
    axes) train, in a gloo group of one process: the state lies over the
    mesh and the checkpoint is written."""
    import torch_parallel_worker
    with torch_parallel_worker.world_1():
        trainer = Trainer(_train_opt(tmp_path, epoch=1, steps_per_epoch=1,
                                     **flags), device="cpu", image_size=32)
        assert trainer.mesh is not None and trainer.state.mesh is not None
        trainer.train()
    assert trainer.state.step == 1
    assert os.path.exists(os.path.join(tmp_path, "ckpt",
                                       checkpoint.FINAL_NAME))
