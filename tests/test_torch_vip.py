"""The port's ``--net ViP`` (scat_tpu_torch.models.performer) against the
JAX package's, on the CPU: the Performer block and the whole model on
both FAVOR+ paths (the JAX side's Pallas kernels in interpret mode, the
port's kernel wrapper taking its plain version on CPU tensors), float32
and bf16, the init, remat and dropout, 12 train steps, the predictor,
checkpoints and the trainer.

Small models (32x32 crops, 4x4 patches: 65 tokens; emb_s 16 or 32, 2
heads, depth 2) are initialized in flax and carried into the port by
``vip_state_dict_from_flax``; inputs come from a seeded numpy
RandomState.  Dropout masks cannot bit-match jax.random, so parity is
held at dropout 0 or in eval mode, and dropout on its own."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.ops.pallas_favor as pf
from scat_tpu.models.performer import PerformerBlock as JBlock
from scat_tpu.models.performer import ViP as JViP
from scat_tpu.serving import HandPosePredictor as JPredictor
from scat_tpu.training import schedule as jschedule
from scat_tpu.training import steps as jsteps
from scat_tpu.training.state import TrainState as JState
from scat_tpu_torch import assets
from scat_tpu_torch.config import BaseOptions, Options
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models.performer import PerformerBlock, ViP, _dropout
from scat_tpu_torch.ops import favor
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.training import schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.utils.weights import vip_state_dict_from_flax

ATOL = 1e-3       # the repo's whole-model parity bar
BF16_REL = 2e-2   # bf16: within 2% of the largest magnitude
IMG, PATCH, BS = 32, 4, 2
BASE_LR, W3D, W2D = 5e-4, 1e5, 10.0   # script/ablation_pose.sh
STEPS_PER_EPOCH, EPOCHS = 4, 3


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pf, "_INTERPRET", True)


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.array(tree)


def _mean():
    return assets.load_mean_params()


def _jvip(emb_s=16, iteration=1, **kw):
    return JViP(mean_params=jnp.asarray(_mean()), image_pix=IMG,
                patch_pix=PATCH, emb_s=emb_s, heads=2, depth=2,
                iteration=iteration, dropout=0.0, **kw)


def _tvip(emb_s=16, iteration=1, **kw):
    kw.setdefault("dropout", 0.0)
    return ViP(mean_params=torch.from_numpy(_mean()), image_pix=IMG,
               patch_pix=PATCH, emb_s=emb_s, heads=2, depth=2,
               iteration=iteration, **kw)


_INITS = {}


def _flax_init(emb_s):
    """(params, constants) of one flax init of the small ViP, with a
    random pos_emb (the init's zeros would hide a layout fault)."""
    if emb_s not in _INITS:
        x = np.zeros((1, IMG, IMG, 3), np.float32)
        v = jax.jit(lambda x: _jvip(emb_s).init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            x, train=False))(x)
        params, consts = _unfreeze(v["params"]), _unfreeze(v["constants"])
        rng = np.random.RandomState(emb_s)
        params["pos_emb"] = (rng.randn(*params["pos_emb"].shape)
                             * 0.1).astype(np.float32)
        _INITS[emb_s] = params, consts
    return _INITS[emb_s]


def _ported(emb_s=16, iteration=1, **kw):
    params, consts = _flax_init(emb_s)
    tm = _tvip(emb_s, iteration, **kw)
    tm.load_state_dict(vip_state_dict_from_flax(params, consts),
                       strict=True)
    return tm


def _images(rng, n=BS):
    return (rng.randn(n, IMG, IMG, 3) * 0.5).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_state_dict_keys_are_the_references():
    keys = set(_tvip().state_dict())
    assert {"patch_emb.weight", "pos_emb", "cls_token", "head.bias",
            "mains.0.kqv.weight", "mains.1.mlp.2.bias", "mains.0.w",
            "mains.1.ln2.weight"} <= keys
    assert not any(k.startswith("mean_params") for k in keys)
    assert "mains.0.w" not in dict(_tvip().named_parameters())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_performer_block_matches_jax(rng, use_kernel):
    jb = JBlock(emb_s=16, head=2, dp_ratio=0.0, use_pallas=use_kernel)
    x = (rng.randn(2, 17, 32)).astype(np.float32)
    v = jb.init(jax.random.key(0), jnp.asarray(x))
    want = jb.apply(v, jnp.asarray(x))
    sd = vip_state_dict_from_flax({"block_0": _unfreeze(v["params"])},
                                  {"block_0": _unfreeze(v["constants"])})
    tb = PerformerBlock(16, 2, dp_ratio=0.0, use_kernel=use_kernel)
    tb.load_state_dict({k[len("mains.0."):]: t for k, t in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("emb_s,iteration", [(16, 1), (32, 3)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_vip_matches_jax(rng, emb_s, iteration, use_kernel):
    params, consts = _flax_init(emb_s)
    x = _images(rng)
    jm = _jvip(emb_s, iteration, use_pallas=use_kernel)
    pred, feat = jax.jit(lambda p, c, x: jm.apply(
        {"params": p, "constants": c}, x, train=False))(params, consts, x)
    tm = _ported(emb_s, iteration, use_kernel=use_kernel).eval()
    with torch.no_grad():
        tpred, tfeat = tm(_nchw(x))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(feat), atol=ATOL)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(pred), atol=ATOL)
    # not root-centred: joint 1 is predicted like the others
    assert np.abs(tpred.numpy()[:, 6:9]).max() > 1e-3


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("scheme", ["cast_compute", "autocast"])
def test_vip_bf16_matches_jax(rng, use_kernel, scheme):
    """bf16 Linear layers with a float32 residual stream, LayerNorms and
    head: serving's cast_compute and training's autocast, both within
    2% of the JAX bf16 model's largest output."""
    params, consts = _flax_init(32)
    x = _images(rng)
    jm = _jvip(32, 3, use_pallas=use_kernel, dtype=jnp.bfloat16)
    want, _ = jax.jit(lambda p, c, x: jm.apply(
        {"params": p, "constants": c}, x, train=False))(params, consts, x)
    tm = _ported(32, 3, use_kernel=use_kernel).eval()
    if scheme == "cast_compute":
        tm.cast_compute(torch.bfloat16)
        assert tm.mains[0].kqv.weight.dtype == torch.bfloat16
        assert tm.mains[0].ln1.weight.dtype == torch.float32
        assert tm.mains[0].w.dtype == torch.float32
        assert tm.head.weight.dtype == torch.float32
        assert tm.pos_emb.dtype == torch.float32
    else:
        tm.set_compute_dtype(torch.bfloat16)
    with torch.no_grad():
        got, _ = tm(_nchw(x))
    want = np.asarray(want)
    diff = np.abs(got.float().numpy() - want).max()
    assert diff <= BF16_REL * np.abs(want).max(), diff


def test_fresh_vip_at_emb_128_is_finite(rng):
    """The JAX package's torch-style init (performer.py:74-92): at the
    reference's emb_s 128 the FAVOR+ normalizer stays finite."""
    tm = _tvip(emb_s=128, dropout=0.1)
    checkpoint.load_weights(tm, "", seed=0)
    bound = 1 / np.sqrt(128)
    kqv = tm.mains[0].kqv
    assert kqv.weight.abs().max() <= bound and kqv.bias.abs().max() <= bound
    assert kqv.weight.std() > 0.5 * bound / np.sqrt(3)
    assert torch.equal(tm.pos_emb, torch.zeros_like(tm.pos_emb))
    assert 0 <= tm.cls_token.min() and tm.cls_token.max() < 1
    assert abs(float(tm.mains[1].w.std()) - 1.0) < 0.1
    x = _nchw(_images(rng))
    for mode in (tm.train(), tm.eval()):
        pred, feat = mode(x)
        assert torch.isfinite(pred).all() and torch.isfinite(feat).all()
    again = _tvip(emb_s=128)
    checkpoint.load_weights(again, "", seed=0)
    for (k, a), b in zip(tm.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_dropout_masks_rate_and_generator():
    tm = _tvip(dropout=0.1)
    g = torch.Generator().manual_seed(3)
    masks = tm.train_inputs(4, g)["dropout_masks"]
    assert len(masks) == 2 and all(len(pair) == 2 for pair in masks)
    keep = torch.stack([m for pair in masks for m in pair]).float().mean()
    assert masks[0][0].shape == (4, 65, 32) and masks[0][0].dtype == \
        torch.bool
    assert abs(float(keep) - 0.9) < 0.01
    again = tm.train_inputs(4, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for pa, pb in zip(
        masks, again["dropout_masks"]) for a, b in zip(pa, pb))
    assert _tvip(dropout=0.0).train_inputs(4, g) == {}


def test_dropout_scales_kept_entries(rng):
    x = torch.from_numpy(rng.randn(2, 65, 32).astype(np.float32))
    keep = torch.from_numpy(rng.rand(2, 65, 32) < 0.9)
    block = PerformerBlock(16, 2, dp_ratio=0.1)
    out = _dropout(x, keep, 0.1)
    torch.testing.assert_close(out[keep], x[keep] / 0.9)
    assert torch.all(out[~keep] == 0)
    assert _dropout(x, None, 0.1) is x
    with torch.no_grad():
        assert not torch.allclose(block(x, (keep, keep)), block(x))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_remat_equals_plain_with_dropout(rng, use_kernel):
    """remat_blocks recomputes each block in the backward with the masks
    its forward saw: the same outputs and gradients, dropout on."""
    x = _nchw(_images(rng))
    tm = _ported(16, 3, use_kernel=use_kernel, dropout=0.1).train()
    results = []
    for remat in (False, True):
        tm.remat = remat
        tm.zero_grad(set_to_none=True)
        inputs = tm.train_inputs(BS, torch.Generator().manual_seed(7))
        pred, _ = tm(x, **inputs)
        (pred ** 2).sum().backward()
        results.append((pred.detach(), [p.grad.clone()
                                        for p in tm.parameters()]))
    (p0, g0), (p1, g1) = results
    torch.testing.assert_close(p1, p0, rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # the masks are live: eval mode (no dropout) predicts otherwise
    with torch.no_grad():
        assert not torch.allclose(tm.eval()(x)[0], p0, atol=1e-4)


def _batches(rng, count):
    """Identical batches for both frameworks (the recipe of
    tests/test_torch_train.py)."""
    offsets = _mean()[3:66].reshape(21, 3)
    out = []
    for _ in range(count):
        j3d = (offsets[None] + rng.randn(BS, 21, 3) * 0.02).astype(
            np.float32)
        j3d -= j3d[:, 1:2]
        j2d = (rng.rand(BS, 21, 2) * 20 + 6).astype(np.float32)
        lab = np.concatenate([j3d.reshape(BS, 63), j2d.reshape(BS, 42)], 1)
        out.append((_images(rng), lab))
    return out


def _tbatch(img, lab):
    return {"image": torch.from_numpy(img), "label": torch.from_numpy(lab),
            "valid": torch.ones(img.shape[0])}


def _port_state(model, seed=0):
    opt, sched = schedule.make_optimizer(model, BASE_LR, STEPS_PER_EPOCH)
    return TrainState.create(model, opt, sched, seed=seed)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_trajectory_matches_jax(rng, use_kernel):
    """12 float32 steps of ViP(dropout=0) from one init on identical
    batches, against make_train_step: losses within the ladder of
    tests/test_torch_train.py, then the updated head and patch
    embedding; the frozen w does not move."""
    params, consts = _flax_init(16)
    batches = _batches(rng, STEPS_PER_EPOCH * EPOCHS)
    jm = _jvip(16, 3, use_pallas=use_kernel)
    tx = jschedule.make_optimizer(BASE_LR, STEPS_PER_EPOCH)
    jstate = JState.create(params, {}, tx, jax.random.key(1),
                           constants=consts)
    jstep = jax.jit(jsteps.make_train_step(jm, tx, W3D, W2D))
    state = _port_state(_ported(16, 3, use_kernel=use_kernel))
    w_before = state.model.mains[0].w.clone()
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
    # both fall (by about 29% in these 12 steps inside the warmup ramp)
    assert tl[-1] < 0.8 * tl[0] and jl[-1] < 0.8 * jl[0], (tl, jl)
    sd = state.model.state_dict()
    jp = jstate.params
    np.testing.assert_allclose(sd["head.weight"].numpy(),
                               np.asarray(jp["head"]["kernel"]).T,
                               atol=1e-3)
    np.testing.assert_allclose(sd["patch_emb.weight"].numpy(),
                               np.asarray(jp["patch_emb"]["kernel"]).T,
                               atol=1e-3)
    assert torch.equal(state.model.mains[0].w, w_before)


def test_predictor_matches_jax(rng):
    params, consts = _flax_init(32)
    jm = _jvip(32, 3)
    crops = (rng.rand(3, IMG, IMG, 3) * 255).astype(np.uint8)
    want = JPredictor(model=jm, params=params, batch_stats={},
                      image_size=IMG, max_batch=4,
                      constants=consts).predict(crops)
    tm = _ported(32, 3, use_kernel=True)
    got = HandPosePredictor(model=tm, image_size=IMG, max_batch=4,
                            device="cpu").predict(crops)
    for k in ("camera", "joints_3d", "joints_2d"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k],
                                   atol=ATOL * (112 if k == "joints_2d"
                                                else 1), err_msg=k)


def test_factory_threads_the_flags():
    argv = ("--net ViP --iteration 3 --use_pallas_favor True "
            "--remat_blocks True --favor_precision mixed").split()
    model, mean = build_model(BaseOptions().parse(argv), image_size=IMG)
    assert isinstance(model, ViP) and model.remat and model.iteration == 3
    assert all(b.use_kernel and b.favor_precision == "mixed"
               for b in model.mains)
    assert model.tokens == (IMG // 4) ** 2 + 1 and model.emb == 512
    assert model.mains[0].w.shape == (64, 128) and len(model.mains) == 3
    assert np.allclose(model.mean_params.numpy(), mean[:66])
    # the JAX default: the plain FAVOR+ path
    plain, _ = build_model(Options(net="ViP"), image_size=IMG)
    assert not any(b.use_kernel for b in plain.mains) and not plain.remat


def test_favor_precision_bogus_raises():
    with pytest.raises(ValueError, match="favor_precision"):
        build_model(Options(net="ViP", favor_precision="bogus"),
                    image_size=IMG)


def _train_opt(tmp_path, **kw):
    base = dict(net="ViP", batch_size=2, lr=BASE_LR, epoch=2,
                l_weight_3d=W3D, l_weight_2d=W2D, iteration=3,
                synthetic_data=True, debug=False, steps_per_epoch=2,
                log_every=1, compute_dtype="float32",
                use_pallas_favor=True,
                checkpoint_folder=str(tmp_path / "ckpt"))
    base.update(kw)
    return Options(**base)


def test_trainer_checkpoint_and_predictor(tmp_path, rng):
    """The Trainer on --net ViP (dropout masks from the state's
    generator); the final checkpoint carries mains.{i}.w, serves as it
    is and resumes bit for bit; without the w buffers it does not
    load."""
    opt = _train_opt(tmp_path)
    trainer = Trainer(opt, device="cpu", image_size=IMG)
    trainer.train()
    assert trainer.state.step == 4
    path = os.path.join(opt.checkpoint_folder, checkpoint.FINAL_NAME)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for i in range(3):
        assert torch.equal(sd["state_dict"][f"mains.{i}.w"],
                           trainer.model.mains[i].w)
    served = HandPosePredictor.from_checkpoint(
        dataclasses.replace(opt, checkpoint_path_eval=path), image_size=IMG,
        device="cpu")
    crops = (rng.rand(3, IMG, IMG, 3) * 255).astype(np.uint8)
    got = served.predict(crops)
    trainer.model.eval()
    with torch.no_grad():
        x = torch.from_numpy(crops).float() / 127.5 - 1.0
        want = trainer.model(x.permute(0, 3, 1, 2))[0][:, 3:].reshape(
            -1, 21, 3)
    np.testing.assert_allclose(got["joints_3d"], want.numpy(), atol=1e-5)
    # a resumed state continues bit for bit: the generator's dropout
    # masks are part of it
    batch = next(iter(trainer.train_loader))
    resumed = Trainer(dataclasses.replace(opt, resume=True,
                                          checkpoint_hand=path),
                      device="cpu", image_size=IMG)
    assert resumed.success_load
    a = trainer.train_step(trainer.state, batch)["loss"]
    b = resumed.train_step(resumed.state, batch)["loss"]
    assert torch.equal(a, b)
    bad = str(tmp_path / "no_w.pth")
    torch.save({k: v for k, v in sd["state_dict"].items()
                if not k.endswith(".w")}, bad)
    with pytest.raises(RuntimeError, match=r"mains\.0\.w"):
        HandPosePredictor.from_checkpoint(
            dataclasses.replace(opt, checkpoint_path_eval=bad),
            image_size=IMG, device="cpu")


def test_freeze_freezes_nothing_of_vip(tmp_path):
    """--freeze leaves out the parameters under main_encoder; ViP has
    none, so every parameter trains (scat_tpu/training/schedule.py:52)."""
    model = _tvip()
    opt, _ = schedule.make_optimizer(model, BASE_LR, 4, freeze_backbone=True)
    assert len(opt.param_groups[0]["params"]) == len(list(model.parameters()))


def test_kernel_path_launches_nothing_on_cpu(rng):
    before = (favor.favor_stats.launches, favor.favor_apply.launches)
    with torch.no_grad():
        _ported(16, 1, use_kernel=True).eval()(_nchw(_images(rng)))
    assert (favor.favor_stats.launches, favor.favor_apply.launches) == before
