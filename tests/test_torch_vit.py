"""The port's ``--net ViT`` and the auxiliary modules against the JAX
package's, in float32 on the CPU: ViT in eval mode and in train mode
with dropout (its keep-masks injected into both), YunqianTransformer,
TruncatedResNet and SPADE (both norms), each loaded strictly through
``utils.weights``; then ViT's train steps against ``make_train_step``,
the Trainer, the predictor and the Evaluator on ``--net ViT``.

The JAX trees come from ``jax.eval_shape`` of each init, filled with
seeded numpy draws (``flax_trees``); inputs come from a seeded numpy
RandomState and go to both sides."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.config as jconfig
import scat_tpu.evaluation.evaluator as jevaluator
from scat_tpu.models import factory as jfactory
from scat_tpu.models import helpers as jhelpers
from scat_tpu.models import vit as jvit
from scat_tpu.training import schedule as jschedule
from scat_tpu.training import steps as jsteps
from scat_tpu.training.state import TrainState as JState
from scat_tpu_torch import assets
from scat_tpu_torch.config import BaseOptions, Options
from scat_tpu_torch.evaluation import evaluator
from scat_tpu_torch.evaluation.demo import DemoRunner
from scat_tpu_torch.models import build_model, helpers, vit
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.training import schedule, steps
from scat_tpu_torch.training.state import TrainState
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.utils.weights import (
    spade_state_dict_from_flax, truncated_resnet_state_dict_from_flax,
    vit_state_dict_from_flax, yunqian_state_dict_from_flax)

from flax_trees import variables as flax_variables

IMG, PATCH, DIM, HEADS, ITER = 32, 8, 64, 2, 2
ATOL = 1e-4
W3D, W2D, LR, STEPS_PER_EPOCH = 1e5, 10.0, 5e-4, 4


def _vit_pair(rng, **kw):
    mean = assets.load_mean_params()
    jm = jvit.ViT(mean_params=jnp.asarray(mean), patch_size=PATCH, dim=DIM,
                  heads=HEADS, iteration=ITER, **kw)
    v = flax_variables(jm, rng, np.zeros((1, IMG, IMG, 3), np.float32),
                       train=False)
    tm = vit.ViT(torch.from_numpy(mean), image_size=IMG, patch_size=PATCH,
                 dim=DIM, heads=HEADS, iteration=ITER, **kw)
    tm.load_state_dict(vit_state_dict_from_flax(v["params"]), strict=True)
    return jm, v, tm


def _crops(rng, n=3):
    # no symmetry for a wrong patch order to hide behind
    return rng.uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_vit_eval_matches_jax(rng):
    """(pred, feat) within 1e-4 on carried weights: the patches in the
    reference's (p1 p2 c) order, the float32 cls token and position
    embedding, the pyramid, the token mean and ``iteration`` refinements;
    no root-centring."""
    jm, v, tm = _vit_pair(rng)
    x = _crops(rng)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    assert got[0].shape == (3, 66) and got[1].shape == (3, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    # the patch order matters: a transposed crop gives another answer
    with torch.no_grad():
        other = tm(_nchw(np.ascontiguousarray(x.transpose(0, 2, 1, 3))))
    assert np.abs(other[0].numpy() - got[0].numpy()).max() > 1e-3


def test_vit_train_mode_with_dropout_matches_jax(rng, monkeypatch):
    """Train mode with emb dropout 0.1 and attention dropout 0.2: the
    same keep-masks fed to both (JAX's ``jax.random.bernoulli`` replaced
    by the masks in call order: the embedding's, then each attention's),
    outputs and the loss's gradient norm within 1e-4; with dropout 0
    train mode equals eval mode (no BatchNorm)."""
    jm, v, tm = _vit_pair(rng, dropout=0.2, emb_dropout=0.1)
    x = _crops(rng, 2)
    masks = tm.train_inputs(2, torch.Generator().manual_seed(5))
    order = [masks["emb_mask"]] + masks["dropout_masks"]
    assert [m.shape[-1] for m in order] == [DIM, DIM, DIM // 2, DIM // 4]
    queue = [jnp.asarray(m.numpy()) for m in order]

    def bernoulli(key, p, shape):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape)
        return mask
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def jloss(params):
        pred, feat = jm.apply({"params": params}, x, train=True,
                              rngs={"dropout": jax.random.key(0)})
        return (pred ** 2).mean(), (pred, feat)
    (jl, want), jg = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    assert not queue
    tm.train()
    pred, feat = tm(_nchw(x), **masks)
    loss = (pred ** 2).mean()
    loss.backward()
    for g, w in zip((pred, feat), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL)
    jnorm = np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                        for g in jax.tree_util.tree_leaves(jg)))
    tnorm = np.sqrt(sum(float((p.grad ** 2).sum())
                        for p in tm.parameters()))
    np.testing.assert_allclose(tnorm, jnorm, rtol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=ATOL)

    plain = vit.ViT(torch.from_numpy(assets.load_mean_params()),
                    image_size=IMG, patch_size=PATCH, dim=DIM, heads=HEADS,
                    iteration=ITER)
    plain.load_state_dict(tm.state_dict())
    assert plain.train_inputs(2) == {}
    with torch.no_grad():
        a = plain.train()(_nchw(x))[0]
        b = plain.eval()(_nchw(x))[0]
    assert torch.equal(a, b)


def test_yunqian_matches_jax(rng):
    """Residual(Attention) with no PreNorm, scaled by dim**-0.5, and the
    LayerNorm + Linear head: within 1e-4 (reference models/vit.py)."""
    jm = jvit.YunqianTransformer(dim=32, depth=2, heads=2, dim_head=16,
                                 mlp_dim=48, out_dim=61)
    x = rng.randn(2, 9, 32).astype(np.float32)
    v = flax_variables(jm, rng, x)
    tm = vit.YunqianTransformer(dim=32, depth=2, heads=2, dim_head=16,
                                mlp_dim=48, out_dim=61)
    tm.load_state_dict(yunqian_state_dict_from_flax(v["params"]),
                       strict=True)
    assert tm.transformer.layers[0][0].fn.scale == 32 ** -0.5
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_truncated_resnet_matches_jax(rng):
    jm = jhelpers.TruncatedResNet()
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    v = flax_variables(jm, rng, x, train=False)
    tm = helpers.TruncatedResNet()
    tm.load_state_dict(truncated_resnet_state_dict_from_flax(
        v["params"], v["batch_stats"]), strict=True)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    assert got.shape == (1, 512, 8, 8)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_spade_matches_jax(rng, norm):
    """The parameter-free norm (running statistics for "batch") and the
    nearest-index resize of a 13x11 segmentation map to 8x8: within
    1e-4."""
    jm = jhelpers.SPADE(norm_nc=16, label_nc=3, param_free_norm_type=norm)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    seg = rng.rand(2, 13, 11, 3).astype(np.float32)
    v = flax_variables(jm, rng, x, seg, train=False)
    tm = helpers.SPADE(16, 3, param_free_norm_type=norm)
    tm.load_state_dict(spade_state_dict_from_flax(
        v["params"], v.get("batch_stats")), strict=True)
    want = jax.jit(lambda v, x, s: jm.apply(v, x, s, train=False))(v, x,
                                                                   seg)
    with torch.no_grad():
        got = tm.eval()(_nchw(x), _nchw(seg))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError):
        helpers.SPADE(16, 3, param_free_norm_type="layer")


def _batches(rng, count, n=2):
    offsets = assets.load_mean_params()[3:66].reshape(21, 3)
    out = []
    for _ in range(count):
        j3d = (offsets[None] + rng.randn(n, 21, 3) * 0.02).astype(
            np.float32)
        j2d = (rng.rand(n, 21, 2) * 180 + 22).astype(np.float32)
        lab = np.concatenate([j3d.reshape(n, 63), j2d.reshape(n, 42)], 1)
        out.append((_crops(rng, n), lab))
    return out


def test_vit_train_steps_match_jax(rng):
    """Three float32 steps of ``make_train_step`` from carried weights on
    identical batches: the first step's loss within 1e-4 relative, the
    next within 1e-3 (Adam's round-off compounds through the 1e5-weighted
    loss), and the updated head within 1e-5."""
    jm, v, tm = _vit_pair(rng)
    batches = _batches(rng, 3)
    tx = jschedule.make_optimizer(LR, STEPS_PER_EPOCH)
    jstate = JState.create(v["params"], {}, tx, jax.random.key(1))
    jstep = jax.jit(jsteps.make_train_step(jm, tx, W3D, W2D))
    opt, sched = schedule.make_optimizer(tm, LR, STEPS_PER_EPOCH)
    state = TrainState.create(tm, opt, sched)
    step = steps.make_train_step(W3D, W2D)
    jl, tl = [], []
    for img, lab in batches:
        jstate, js = jstep(jstate, {"image": jnp.asarray(img),
                                    "label": jnp.asarray(lab),
                                    "valid": jnp.ones(2)})
        jl.append(float(js["loss"]))
        tl.append(float(step(state, {
            "image": torch.from_numpy(img), "label": torch.from_numpy(lab),
            "valid": torch.ones(2)})["loss"]))
    rel = np.abs(np.asarray(tl) - jl) / np.abs(jl)
    assert rel[0] < 1e-4, (tl, jl)
    assert np.all(rel < 1e-3), rel
    np.testing.assert_allclose(
        tm.head[0].weight.detach().numpy(),
        np.asarray(jstate.params["head"]["kernel"]).T, atol=1e-5)


def _vit_opt(tmp_path, **kw):
    return dataclasses.replace(Options(
        net="ViT", vit_dim=DIM, vit_heads=HEADS, iteration=ITER,
        batch_size=2, lr=LR, l_weight_3d=W3D, l_weight_2d=W2D,
        compute_dtype="float32", synthetic_data=True, debug=False,
        steps_per_epoch=2, epoch=2, checkpoint_path_eval="",
        checkpoint_folder=str(tmp_path / "ckpt"),
        result_dir=str(tmp_path / "eval")), **kw)


def test_default_net_is_vit_and_trains(tmp_path, capsys):
    """The default ``--net`` builds ViT; the Trainer trains it on the CPU
    (the reference's loss prints, hand_net_final.pth), the predictor serves
    the file as it is, in float32 and bf16, and DemoRunner accepts it."""
    model, mean = build_model(BaseOptions().parse([]))
    assert isinstance(model, vit.ViT) and mean.shape == (66,)
    assert model.tokens == 197 and model.transformer.dims == [256, 128, 64]
    opt = _vit_opt(tmp_path)
    trainer = Trainer(opt, device="cpu", image_size=IMG)
    trainer.train()
    out = capsys.readouterr().out
    assert "[2,     1] loss:" in out and trainer.state.step == 4
    path = os.path.join(opt.checkpoint_folder, checkpoint.FINAL_NAME)
    pred = HandPosePredictor.from_checkpoint(
        dataclasses.replace(opt, checkpoint_path_eval=path), image_size=IMG,
        device="cpu")
    crops = (np.random.RandomState(0).rand(3, IMG, IMG, 3) * 255).astype(
        np.uint8)
    got = pred.predict(crops)
    trained = trainer.model.eval()
    with torch.no_grad():
        want = trained(torch.from_numpy(crops).float().div(127.5).sub(
            1.0).permute(0, 3, 1, 2))[0]
    np.testing.assert_allclose(got["joints_3d"],
                               want[:, 3:].reshape(-1, 21, 3).numpy(),
                               atol=1e-5)
    bf16 = HandPosePredictor.from_checkpoint(
        dataclasses.replace(opt, checkpoint_path_eval=path,
                            compute_dtype="bfloat16"), image_size=IMG,
        device="cpu")
    assert bf16.model.patch_to_embedding.weight.dtype == torch.bfloat16
    assert bf16.model.head[0].weight.dtype == torch.float32
    assert np.isfinite(bf16.predict(crops)["joints_3d"]).all()
    DemoRunner(dataclasses.replace(opt, checkpoint_path_eval=path),
               image_size=IMG, device="cpu")


def test_evaluator_vit_matches_jax(tmp_path, rng):
    """``--net ViT`` through both Evaluators on the same weights and
    batches: MPJPE within 1%, AUC within 1e-3 relative."""
    jopt = jconfig.Options(net="ViT", vit_dim=DIM, vit_heads=HEADS,
                           iteration=ITER, batch_size=4,
                           compute_dtype="float32",
                           result_dir=str(tmp_path / "jax"))
    jm, _ = jfactory.build_model(jopt, IMG, for_keypoints=True)
    v = flax_variables(jm, rng, np.zeros((1, IMG, IMG, 3), np.float32),
                       train=False)
    sd = vit_state_dict_from_flax(v["params"])
    opt = _vit_opt(tmp_path, batch_size=4)
    tm, _ = build_model(opt, IMG, for_keypoints=True)
    tm.load_state_dict(sd, strict=True)
    batches = []
    for _ in range(2):
        img = _crops(rng, 4)
        with torch.no_grad():
            pred = tm.eval()(_nchw(img))[0]
        lab = np.concatenate([
            pred[:, 3:].numpy() + rng.randn(4, 63).astype(np.float32) * 0.01,
            rng.rand(4, 42).astype(np.float32) * 224], 1)
        batches.append({"image": img, "label": lab,
                        "valid": np.ones(4, np.float32)})
    want = jevaluator.Evaluator(jopt, image_size=IMG, variables=v,
                                dataset=batches).eval()
    got = evaluator.Evaluator(
        opt, image_size=IMG, state_dict=sd, device="cpu",
        dataset=[{k: torch.from_numpy(a) for k, a in b.items()}
                 for b in batches]).eval()
    assert np.isfinite(got["mpjpe_mm"]) and 0 < got["auc"]
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-2)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-3)
