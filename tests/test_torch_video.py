"""The port's temporal stage against the JAX package's, in float32 on the
CPU: the motion discriminator (every pooling, spectral norm), every VIBE
loss, one adversarial step against ``make_adversarial_train_step`` on
the same batch and weights (resnet18 H3DW at 32 px, GRU 16 x 2,
windows of 3 frames), the window dataset, and the VideoTrainer.

The JAX trees come from ``jax.eval_shape`` of each init, filled with
seeded numpy draws (``flax_trees``) and carried by ``utils.weights``;
inputs come from a seeded numpy RandomState and go to both sides."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import scat_tpu.models.hand_net as jhand_net
import scat_tpu.training.adversarial as jadv
from scat_tpu.models import mano as jmano
from scat_tpu.models import vibe_loss as jvl
from scat_tpu.models.discriminator import MotionDiscriminator as JDisc
from scat_tpu.training.video_trainer import VideoChunkDataset as JChunks
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.models import mano
from scat_tpu_torch.models import vibe_loss as vl
from scat_tpu_torch.models.discriminator import MotionDiscriminator
from scat_tpu_torch.models.hand_net import H3DWEncoder
from scat_tpu_torch.training import adversarial
from scat_tpu_torch.training.video_trainer import (VideoChunkDataset,
                                                   VideoTrainer)
from scat_tpu_torch.utils.weights import (
    h3dw_state_dict_from_flax, motion_discriminator_state_dict_from_flax)

from flax_trees import variables as flax_variables

RNN, SEQ, IMG, LR = 16, 8, 32, 1e-3


def _disc_pair(rng, **kw):
    jd = JDisc(rnn_size=RNN, input_size=48, num_layers=2, **kw)
    seq = rng.randn(3, SEQ, 48).astype(np.float32)
    v = flax_variables(jd, rng, seq)
    td = MotionDiscriminator(RNN, 48, 2, **kw)
    td.load_state_dict(motion_discriminator_state_dict_from_flax(
        v["params"], v.get("batch_stats")), strict=True)
    return jd, v, td, seq


@pytest.mark.parametrize("pool,layers", [("concat", 1), ("attention", 1),
                                         ("attention", 2), ("last", 1)])
def test_discriminator_matches_jax(rng, pool, layers):
    """The GRU's gates carried from flax's GRUCell Denses, each pooling
    (the attention MLP with one and two layers), deterministic: within
    1e-5; the output's gradient w.r.t. the input sequence too."""
    jd, v, td, seq = _disc_pair(rng, feature_pool=pool, attention_size=12,
                                attention_layers=layers)
    want, vjp = jax.vjp(lambda s: jd.apply(v, s), jnp.asarray(seq))
    x = torch.from_numpy(seq).requires_grad_()
    got = td(x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    cot = rng.randn(*got.shape).astype(np.float32)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               atol=1e-5)


@pytest.mark.parametrize("update", [False, True])
def test_spectral_norm_is_flax(rng, update):
    """One power iteration from the stored u each call; u and sigma
    written back only under update_sn_stats, as flax's SpectralNorm."""
    jd, v, td, seq = _disc_pair(rng, use_spectral_norm=True)
    want, mutated = jd.apply(v, jnp.asarray(seq), update_sn_stats=update,
                             mutable=["batch_stats"])
    u0 = td.fc_u.clone()
    got = td(torch.from_numpy(seq), update_sn_stats=update)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    sn = mutated["batch_stats"]["SpectralNorm_0"]
    np.testing.assert_allclose(td.fc_u.numpy(),
                               np.asarray(sn["fc/kernel/u"]), atol=1e-6)
    np.testing.assert_allclose(td.fc_sigma.numpy(),
                               np.asarray(sn["fc/kernel/sigma"]), rtol=1e-5)
    assert torch.equal(td.fc_u, u0) != update


def _loss_inputs(rng, b=2, t=4):
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"theta": f(b, t, 61), "j2d": f(b, t, 21, 2) * 50,
            "j3d": f(b, t, 21, 3) * 0.05, "real_2d": f(b, t, 21, 2) * 50,
            "real_3d": f(b, t, 21, 3) * 0.05, "gt": f(b, t, 61),
            "w": (rng.rand(b, t) > 0.3).astype(np.float32),
            "real": f(5, 2), "fake": f(4, 2)}


LOSSES = {
    "keypoint_loss_2d": lambda m, a: m.keypoint_loss_2d(a["j2d"],
                                                        a["real_2d"]),
    "keypoint_loss_2d_weighted": lambda m, a: m.keypoint_loss_2d(
        a["j2d"].reshape(8, 21, 2), a["real_2d"].reshape(8, 21, 2),
        a["w"].reshape(8)),
    "keypoint_loss_3d_weighted": lambda m, a: m.keypoint_loss_3d(
        a["j3d"].reshape(8, 21, 3), a["real_3d"].reshape(8, 21, 3),
        a["w"].reshape(8)),
    "mano_losses": lambda m, a: m.mano_losses(
        a["theta"][..., 3:51], a["theta"][..., 51:], a["gt"][..., 3:51],
        a["gt"][..., 51:], a["w"]),
    "batch_smooth_pose_loss": lambda m, a: m.batch_smooth_pose_loss(
        a["theta"][..., 3:51]),
    "batch_smooth_shape_loss": lambda m, a: m.batch_smooth_shape_loss(
        a["theta"][..., 51:]),
    "batch_smooth_joints_loss": lambda m, a: m.batch_smooth_joints_loss(
        a["j3d"]),
    "encoder_disc_l2_loss": lambda m, a: m.encoder_disc_l2_loss(a["fake"]),
    "adv_disc_l2_loss": lambda m, a: m.adv_disc_l2_loss(a["real"],
                                                        a["fake"]),
    "encoder_disc_wasserstein_loss":
        lambda m, a: m.encoder_disc_wasserstein_loss(a["fake"]),
    "adv_disc_wasserstein_loss":
        lambda m, a: m.adv_disc_wasserstein_loss(a["real"], a["fake"]),
    "vibe_discriminator_loss": lambda m, a: m.vibe_discriminator_loss(
        m.VIBELossConfig(d_motion_loss_weight=0.7), a["real"], a["fake"]),
    "vibe_generator_loss": lambda m, a: m.vibe_generator_loss(
        m.VIBELossConfig(), a["theta"], a["j2d"], a["j3d"], a["real_2d"],
        a["real_3d"], a["gt"], disc_fake_value=a["fake"]),
    "vibe_generator_loss_smooth_weighted":
        lambda m, a: m.vibe_generator_loss(
            m.VIBELossConfig(use_smooth=True), a["theta"], a["j2d"],
            a["j3d"], a["real_2d"], a["real_3d"], a["gt"], w_3d=a["w"],
            w_smpl=a["w"]),
}


def _leaves(x):
    if isinstance(x, dict):
        return {k: _leaves(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_leaves(v) for v in x]
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_vibe_loss_matches_jax(rng, name):
    """Every term within 1e-6 relative, the weighted means in place of
    the reference's boolean indexing."""
    a = _loss_inputs(rng)
    want = _leaves(LOSSES[name](jvl, {k: jnp.asarray(v)
                                      for k, v in a.items()}))
    got = _leaves(LOSSES[name](vl, {k: torch.from_numpy(v)
                                    for k, v in a.items()}))
    flat_w, flat_g = jax.tree_util.tree_leaves(want), \
        jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g) > 0
    if isinstance(want, list) and isinstance(want[-1], dict):
        assert list(got[-1]) == list(want[-1])   # the parts, in order
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def step_pair():
    """(JAX encoder, discriminator, variables, port encoder,
    discriminator) at 32 px, resnet18, GRU 16 x 2 with attention pooling,
    from one set of filled trees."""
    rng = np.random.RandomState(11)
    mean = assets.load_mean_mano_pose()
    je = jhand_net.H3DWEncoder(mean_params=jnp.asarray(mean),
                               backbone="resnet18")
    ev = flax_variables(je, rng, np.zeros((1, IMG, IMG, 3), np.float32),
                        train=False)
    jd = JDisc(rnn_size=RNN, input_size=48, num_layers=2,
               feature_pool="attention", attention_size=RNN)
    dv = flax_variables(jd, rng, np.zeros((2, 3, 48), np.float32))
    return je, jd, ev, dv


def _port_modules(ev, dv):
    enc = H3DWEncoder(torch.from_numpy(assets.load_mean_mano_pose()),
                      backbone="resnet18")
    enc.load_state_dict(h3dw_state_dict_from_flax(ev["params"],
                                                  ev["batch_stats"]),
                        strict=True)
    disc = MotionDiscriminator(RNN, 48, 2, feature_pool="attention",
                               attention_size=RNN)
    disc.load_state_dict(motion_discriminator_state_dict_from_flax(
        dv["params"]), strict=True)
    return enc, disc


def _video_batch(rng, b=2, t=3):
    return {"image": rng.uniform(-1, 1, (b, t, IMG, IMG, 3)).astype(
                np.float32),
            "label": np.concatenate([
                rng.randn(b, t, 61) * 0.1, rng.randn(b, t, 63) * 0.05,
                rng.rand(b, t, 42) * 224], -1).astype(np.float32),
            "real_theta": (rng.randn(b, t, 61) * 0.05).astype(np.float32)}


def _global_norm(tree):
    return float(np.sqrt(sum(float((np.asarray(g) ** 2).sum())
                             for g in jax.tree_util.tree_leaves(tree))))


def test_adversarial_step_matches_jax(step_pair, rng):
    """One step on the same batch and weights as
    ``make_adversarial_train_step``: the generator's and discriminator's
    losses (and d_real, d_fake, each part) within 1e-4 relative, each
    side's gradient norm within 1e-3 relative (JAX's from the step's own
    loss functions), the BatchNorm statistics updated over the B*T
    frames within 1e-5, and Adam's first updates of fc2 and fc."""
    je, jd, ev, dv = step_pair
    batch = _video_batch(rng)
    jm = jmano.ManoModel.from_data()
    gen_tx, disc_tx = optax.adam(LR), optax.adam(LR * 0.1)
    jstate = jadv.AdversarialTrainState.create(ev, dv, gen_tx, disc_tx,
                                               jax.random.key(2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    new, jstats = jax.jit(jadv.make_adversarial_train_step(
        je, jd, jm, gen_tx, disc_tx))(jstate, jb)

    B, T = 2, 3
    flat = jb["image"].reshape((B * T, IMG, IMG, 3))

    def gen_loss(params):   # the step's gen_loss_fn, for its gradient
        (_, thetas_flat), _ = je.apply(
            {"params": params, "batch_stats": ev["batch_stats"]}, flat,
            train=True, mutable=["batch_stats"])
        joints, j2d = jadv._decode_thetas(jm, thetas_flat)
        thetas = thetas_flat.reshape(B, T, 61)
        lab = jb["label"]
        gt = jnp.concatenate([jnp.zeros((B, T, 3)), lab[..., 3:51],
                              jnp.zeros((B, T, 10))], -1)
        fake = jd.apply({"params": dv["params"]}, thetas[:, :, 3:51])
        return jvl.vibe_generator_loss(
            jvl.VIBELossConfig(), thetas, j2d.reshape(B, T, 21, 2),
            joints.reshape(B, T, 21, 3), lab[..., 124:].reshape(
                B, T, 21, 2), lab[..., 61:124].reshape(B, T, 21, 3), gt,
            disc_fake_value=fake)[0], thetas

    (_, thetas), ggrad = jax.jit(jax.value_and_grad(
        gen_loss, has_aux=True))(ev["params"])

    def disc_loss(params):
        f = jd.apply({"params": params}, thetas[:, :, 3:51])
        r = jd.apply({"params": params}, jb["real_theta"][:, :, 3:51])
        return jvl.vibe_discriminator_loss(jvl.VIBELossConfig(), r, f)[2]
    dgrad = jax.jit(jax.grad(disc_loss))(dv["params"])

    enc, disc = _port_modules(ev, dv)
    state = adversarial.AdversarialTrainState.create(enc, disc, LR,
                                                     LR * 0.1)
    step = adversarial.make_adversarial_train_step(
        mano.ManoModel.from_data(), grad_norms=True)
    stats = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1
    for k in ("gen_loss", "disc_loss", "d_real", "d_fake", "loss_kp_2d",
              "loss_kp_3d", "loss_pose", "loss_shape", "e_m_disc_loss"):
        np.testing.assert_allclose(stats[k].item(), float(jstats[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(stats["gen_grad_norm"].item(),
                               _global_norm(ggrad), rtol=1e-3)
    np.testing.assert_allclose(stats["disc_grad_norm"].item(),
                               _global_norm(dgrad), rtol=1e-3)
    sd = enc.state_dict()
    bs = new.gen_batch_stats["ResNet_0"]
    for mod, path in (("bn1", ("bn1",)),
                      ("layer4.1.bn2", ("layer4_1", "BatchNorm_1"))):
        node = bs
        for k in path:
            node = node[k]
        for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                sd[f"main_encoder.{mod}.{name}"].numpy(),
                np.asarray(node[leaf]), atol=1e-5, err_msg=f"{mod} {name}")
    # Adam's first update is lr * g / (|g| + eps): where |g| is near eps,
    # round-off can flip its sign, so such elements agree within 2 lr
    for got, want, lr in (
            (enc.feat_encoder[1].weight, new.gen_params["fc2"]["kernel"],
             LR),
            (disc.fc.weight, new.disc_params["fc"]["kernel"], LR * 0.1)):
        diff = np.abs(got.detach().numpy() - np.asarray(want).T)
        assert np.mean(diff <= 1e-5) > 0.9999 and diff.max() <= 2 * lr


def test_generator_update_leaves_the_discriminator(step_pair, rng):
    """The generator's backward reaches the discriminator's input, not
    its parameters: after ``generator_step`` they and their gradients are
    as before, and the encoder moved."""
    _, _, ev, dv = step_pair
    enc, disc = _port_modules(ev, dv)
    state = adversarial.AdversarialTrainState.create(enc, disc, LR,
                                                     LR * 0.1)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    w0 = enc.regressor[0].weight.detach().clone()
    batch = {k: torch.from_numpy(v) for k, v in _video_batch(rng).items()}
    fake, _ = adversarial.generator_step(state, batch,
                                         mano.ManoModel.from_data())
    assert fake.shape == (2, 3, 61) and not fake.requires_grad
    for k, v in disc.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in disc.parameters())
    assert not torch.equal(enc.regressor[0].weight, w0)


def _frames(rng, n=40, size=IMG):
    images = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    labels = (rng.randn(n, 166) * 0.01).astype(np.float32)
    return images, labels, np.array(["vidA"] * 24 + ["vidB"] * (n - 24))


def test_chunk_dataset_matches_jax(rng):
    """Windows, their order and the real-motion draws over two epochs
    equal the JAX package's."""
    images, labels, vids = _frames(rng)
    want = JChunks(images, labels, vids, seqlen=8, stride=4, batch_size=2,
                   seed=3)
    got = VideoChunkDataset(images, labels, vids, seqlen=8, stride=4,
                            batch_size=2, seed=3, device="cpu")
    assert got.windows == want.windows and len(got) == len(want)
    np.testing.assert_array_equal(got.real_theta_bank, want.real_theta_bank)
    for _ in range(2):
        for g, w in zip(got, want):
            for k in ("image", "label", "real_theta"):
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(w[k]), err_msg=k)


def test_video_trainer_on_cpu(rng, capsys, monkeypatch):
    """An epoch of the temporal stage with a small encoder and
    discriminator put in place before the first step: the per-epoch line,
    one step a batch; the default device is CUDA."""
    images, labels, vids = _frames(rng, n=32)
    ds = VideoChunkDataset(images, labels, vids, seqlen=8, stride=8,
                           batch_size=2, device="cpu")
    opt = Options(net="frankmocap", lr=1e-4, epoch=1,
                  compute_dtype="float32")
    trainer = VideoTrainer(opt, image_size=IMG, device="cpu")
    assert trainer.discriminator.gru.hidden_size == 1024
    assert trainer.discriminator.gru.num_layers == 2
    trainer.encoder = H3DWEncoder(
        torch.from_numpy(assets.load_mean_mano_pose()), backbone="resnet18")
    trainer.discriminator = MotionDiscriminator(
        32, 48, 1, feature_pool="attention", attention_size=32)
    state = trainer.train(ds)
    out = capsys.readouterr().out
    assert "[video 1] gen:" in out and "seq/s" in out
    assert state.step == len(ds) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoTrainer(opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoChunkDataset(images, labels, vids)
