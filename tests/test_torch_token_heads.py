"""The port's 128-token heads, ``--net backbone_hrnet`` and
``backbone_incepv3``, against the JAX package's, in float32 on the CPU:
HRNet and the truncated Inception-v3 in train and eval mode, the channel
reinterpretation, both full heads (with token masking), their key
layouts, and how the factory, trainer, predictor, Evaluator and steps
treat a 61-dim head.

The JAX trees come from ``jax.eval_shape`` of each module's init, filled
with seeded numpy draws of flax's scales (an XLA compile of HRNet's init
costs a minute on one CPU core; its shapes cost nothing), and are carried
into the port by ``utils.weights``; inputs come from a seeded numpy
RandomState and go to both sides.  HRNet programs are applied eagerly,
for the same reason: XLA compiles its ops one by one faster than the
whole program; Inception's are jitted, which is the faster way for it."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import scat_tpu.models.hand_net as jhand_net
from scat_tpu import assets as jassets
from scat_tpu.models import hrnet as jhrnet
from scat_tpu.models import inception as jinception
from scat_tpu.utils.torch_import import (export_torch_hrnet,
                                         export_torch_hrnet_encoder,
                                         export_torch_inception,
                                         export_torch_inception_encoder)
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.evaluation import evaluator
from scat_tpu_torch.models import factory, hand_net, hrnet, inception
from scat_tpu_torch.models.factory import build_model
from scat_tpu_torch.models.transformer import Attention
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.training import steps
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.utils.weights import (hrnet_state_dict_from_flax,
                                          inception_state_dict_from_flax)

FLAGS = np.zeros(128, bool)
FLAGS[np.random.RandomState(3).permutation(128)[:25]] = True  # 0.2 * 128


def _fill(shapes, rng):
    """Seeded values of flax's scales for a tree of ShapeDtypeStructs:
    lecun-normal kernels, non-trivial BatchNorm affines and running
    statistics, small biases, a normal(1) mask token."""
    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            v = rng.uniform(-0.1, 0.1, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mask_token":
            v = rng.randn(*shape)
        else:
            v = rng.randn(*shape) * 0.05
        return np.asarray(v, np.float32)
    return _plain(jax.tree_util.tree_map_with_path(leaf, shapes))


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _variables(module, x, rng, **kw):
    shapes = jax.eval_shape(lambda x: module.init(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, x, **kw),
        x)
    return _fill(shapes, rng)


def _apply(jm, v, x, eager, **kw):
    if eager:
        return jm.apply(v, x, **kw)
    return jax.jit(lambda v, x: jm.apply(v, x, **kw))(v, x)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _stats(tree, prefix=()):
    """{dotted flax path: (mean, var)} of every BatchNorm in a tree."""
    out = {}
    for k, v in tree.items():
        if k == "mean":
            out[prefix] = (np.asarray(tree["mean"]), np.asarray(tree["var"]))
        elif isinstance(v, dict):
            out.update(_stats(v, prefix + (k,)))
    return out


BACKBONES = {
    # name: (JAX module, port module, state_dict of the flax trees, the
    # JAX package's export, input side, eager)
    "hrnet": (lambda: jhrnet.HRNet(c=16, nof_joints=32),
              lambda: hrnet.HRNet(c=16, nof_joints=32),
              lambda p, b: _strip(hrnet_state_dict_from_flax(
                  {"main_encoder": p}, {"main_encoder": b}), "main_encoder."),
              export_torch_hrnet, 64, True),
    # 75 px: the smallest input for which every block of torchvision's
    # Inception-v3 keeps a map of at least 3x3 through Mixed_6e
    "inception": (jinception.Inception3, inception.Inception3,
                  lambda p, b: _strip(inception_state_dict_from_flax(
                      {"main_encoder": p}, {"main_encoder": b}),
                      "main_encoder."),
                  export_torch_inception, 75, False),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_jax(name):
    """The backbone at a small size in eval mode (running statistics) and
    in train mode (batch statistics), its keys the JAX package's export,
    loaded strictly.  Eval-mode maps within 1e-5 of their largest
    magnitude.  In train mode flax's BatchNorm takes the variance as
    E[x^2] - E[x]^2 in float32 (``use_fast_variance``), torch's in two
    passes; over the 8 to 18 values a channel has in the smallest maps
    the two differ by up to 3e-4 of the maps' largest magnitude, so the
    train-mode maps and every updated running statistic (flax's biased
    running variance) agree within 1e-3 of their largest magnitude."""
    jcls, tcls, to_sd, export, side, eager = BACKBONES[name]
    rng = np.random.RandomState(0)
    x = rng.randn(2, side, side, 3).astype(np.float32)
    jm = jcls()
    v = _variables(jm, x, rng, train=False)
    params, bs = v["params"], v["batch_stats"]
    want_eval = _apply(jm, v, x, eager, train=False)
    want_train, mutated = _apply(jm, v, x, eager, train=True,
                                 mutable=["batch_stats"])
    sd = to_sd(params, bs)
    assert set(sd) == set(export(params, bs))
    tm = tcls()
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    with torch.no_grad():
        got_eval = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        tm.train()
        got_train = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want, rel, what in ((got_eval, want_eval, 1e-5, "eval"),
                                 (got_train, want_train, 1e-3, "train")):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                                   atol=rel * np.abs(want).max(), rtol=0,
                                   err_msg=what)
    new = to_sd(params, _plain(mutated["batch_stats"]))
    mine = tm.state_dict()
    n = 0
    for k, t in new.items():
        if k.endswith(("running_mean", "running_var")):
            t = t.numpy()
            np.testing.assert_allclose(mine[k].numpy(), t,
                                       atol=1e-3 * np.abs(t).max(), rtol=0,
                                       err_msg=k)
            n += 1
    assert n == 2 * len(_stats(bs))


def test_hrnet_module_names_are_the_official_weights():
    keys = set(hrnet.HRNet(c=24, nof_joints=128).state_dict())
    for k in ("transition1.1.0.0.weight", "stage3.2.branches.1.3.conv2.weight",
              "stage4.0.fuse_layers.3.0.1.0.weight",
              "stage4.2.fuse_layers.0.3.1.running_var",
              "final_layer.bias", "layer1.0.downsample.1.weight"):
        assert k in keys, k
    assert not any(k.startswith("stage4.2.fuse_layers.1.") for k in keys)
    keys = set(inception.Inception3().state_dict())
    assert "Conv2d_1a_3x3.conv.weight" in keys
    assert "Mixed_6e.branch7x7dbl_5.bn.running_mean" in keys
    assert inception.Inception3().Mixed_5b.branch1x1.bn.eps == 1e-3
    assert hrnet.HRNet().bn1.eps == 1e-5


@pytest.mark.parametrize("new_c,shape", [(512, (128, 56, 56)),
                                         (192, (768, 12, 12)),
                                         (8, (2, 4, 4))])
def test_reinterpret_channels_matches_jax(new_c, shape):
    """The reference's raw .view in NCHW order, from a channels_last map
    (the port's backbones run channels_last on the card)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, *shape).astype(np.float32)
    want = jhand_net._reinterpret_channels(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                           new_c)
    t = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    got = hand_net._reinterpret_channels(t, new_c)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))
    with pytest.raises(ValueError):
        hand_net._reinterpret_channels(t, 5)


HEADS = {
    # net: (JAX module, port module, state_dict of the flax trees, the JAX
    # package's export, eager)
    "backbone_hrnet": (jhand_net.EncoderTransformerHRNet,
                       hand_net.EncoderTransformerHRNet,
                       hrnet_state_dict_from_flax,
                       export_torch_hrnet_encoder, True),
    "backbone_incepv3": (jhand_net.EncoderTransformerInception,
                         hand_net.EncoderTransformerInception,
                         inception_state_dict_from_flax,
                         export_torch_inception_encoder, False),
}


@pytest.fixture(scope="module")
def heads():
    """{net: (JAX module, its variables, the port's module loaded from
    them)} at 224 px, 2 heads, iteration 3."""
    out = {}
    mean = jassets.load_mean_mano_pose()
    x = np.zeros((1, 224, 224, 3), np.float32)
    for net, (jcls, tcls, to_sd, _, _) in HEADS.items():
        jm = jcls(mean_params=jnp.asarray(mean), heads=2, mask_rate=0.2)
        v = _variables(jm, x, np.random.RandomState(2), train=False)
        tm = tcls(torch.from_numpy(mean), heads=2, mask_rate=0.2)
        tm.load_state_dict(to_sd(v["params"], v["batch_stats"]), strict=True)
        out[net] = (jm, v, tm)
    return out


@pytest.mark.parametrize("net", sorted(HEADS))
def test_head_matches_jax_in_eval_mode(heads, net):
    """The whole head at 224 px, bs 1, in eval mode: the [1,61] MANO
    parameters within ATOL 1e-3 (tests/test_full_model_parity.py's bar),
    the kernel path (plain on CPU tensors) equal; the key set is the JAX
    package's export."""
    jm, v, tm = heads[net]
    to_sd, export, eager = HEADS[net][2:]
    assert set(to_sd(v["params"], v["batch_stats"])) == set(
        export(v["params"], v["batch_stats"]))
    x = np.random.RandomState(4).randn(1, 224, 224, 3).astype(np.float32)
    want = _apply(jm, v, x, eager, train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (1, 61)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    assert np.abs(got.numpy() - jassets.load_mean_mano_pose()).max() > 1e-3


def test_inception_head_masks_tokens_as_jax(heads, monkeypatch):
    """Train mode (batch statistics) with mask_rate 0.2: 25 of the 128
    tokens take the learned mask token, the same flags on both sides."""
    monkeypatch.setattr(jhand_net, "random_token_mask",
                        lambda key, n, rate: jnp.asarray(FLAGS))
    jm, v, tm = heads["backbone_incepv3"]
    x = np.random.RandomState(5).randn(2, 224, 224, 3).astype(np.float32)
    want, _ = _apply(jm, v, x, False, train=True,
                     rngs={"mask": jax.random.key(0)},
                     mutable=["batch_stats"])
    tm.train()
    flags = tm.train_inputs(2, torch.Generator().manual_seed(0))
    assert int(flags["token_mask"].sum()) == 25
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 token_mask=torch.from_numpy(FLAGS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("net", sorted(HEADS))
def test_factory_routes_the_heads_to_plain_attention(net):
    """--use_pallas_attention (the flagship's flag, on by default) does not
    route the 128-token heads; use_kernel=True on the constructor does.
    The mean is the 61-dim MANO mean; a seeded fresh init has flax's
    scales."""
    opt = Options(net=net, vit_heads=2, use_pallas_attention=True)
    model, mean = build_model(opt)
    np.testing.assert_array_equal(mean, jassets.load_mean_mano_pose())
    attns = [m for m in model.modules() if isinstance(m, Attention)]
    assert len(attns) == 3 and not any(a.use_kernel for a in attns)
    assert model.mask_token.shape == (1, 1, 196)
    cls = HEADS[net][1]
    kernel = cls(torch.from_numpy(mean), heads=2, use_kernel=True)
    assert all(m.use_kernel for m in kernel.modules()
               if isinstance(m, Attention))
    checkpoint.init_weights(model, seed=0)
    w = model.regressor[0].weight
    assert w.shape == (61, 3 + 61)
    assert abs(w.std().item() - (1 / 64) ** 0.5) < 0.15 * (1 / 64) ** 0.5


@pytest.mark.parametrize("net", sorted(HEADS))
def test_61_dim_heads_are_refused_where_66_are_read(tmp_path, net):
    """The trainer (with the JAX trainer's words), the predictor, the
    Evaluator: a ValueError, never a reshape of 61 numbers."""
    with pytest.raises(ValueError, match="61-dim MANO-parameter head"):
        Trainer(Options(net=net, vit_heads=2, debug=False,
                        synthetic_data=True, batch_size=2,
                        checkpoint_folder=str(tmp_path)), device="cpu")
    model, _ = build_model(Options(net=net, vit_heads=2))
    with pytest.raises(ValueError, match="66-dim camera"):
        HandPosePredictor(model=model, device="cpu")
    with pytest.raises(ValueError, match="66-dim camera"):
        evaluator.Evaluator(Options(net=net, vit_heads=2,
                                    result_dir=str(tmp_path / "e")),
                            device="cpu")


class _BareHead(torch.nn.Module):
    """A 66-dim head whose output is a bare tensor, each row its own."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))
        self.register_buffer("rows", torch.linspace(0.1, 1, 4 * 66).reshape(
            4, 66))

    def forward(self, x):
        return self.rows[:x.shape[0]] + self.w


def test_bare_tensor_outputs_are_read_whole():
    """forward_loss, make_eval_step and the predictor read a bare [B,66]
    output whole: row b is sample b's prediction, not a slice of row 0."""
    model = _BareHead()
    want = model.rows[:, 3:].reshape(4, 21, 3)
    images = torch.zeros(4, 8, 8, 3)
    labels = torch.zeros(4, 105)
    _, _, j3d, _ = steps.forward_loss(model, images, labels, torch.ones(4),
                                      1.0, 1.0)
    torch.testing.assert_close(j3d, want)
    out = steps.make_eval_step(model)({"image": images, "label": labels,
                                       "valid": torch.ones(4)})
    assert out["pred_joints_2d"].shape == (4, 21, 2)
    pred = HandPosePredictor(model=model, image_size=8, max_batch=4,
                             device="cpu")
    got = pred.predict(np.zeros((4, 8, 8, 3), np.uint8))
    np.testing.assert_allclose(got["joints_3d"], want.numpy())
    np.testing.assert_allclose(got["camera"], model.rows[:, :3].numpy())
    assert steps.prediction((model.rows, None)) is model.rows


def test_default_options_build_the_mano_mean(monkeypatch, tmp_path):
    """A missing mean_mano_params.pkl leaves the pose zero (camera scale
    5), as in the JAX package."""
    missing = str(tmp_path / "none.pkl")
    np.testing.assert_array_equal(assets.load_mean_mano_pose(missing),
                                  jassets.load_mean_mano_pose(missing))
    mean = assets.load_mean_mano_pose()
    assert mean[0] == 5.0 and np.abs(mean[6:51]).max() > 0
    np.testing.assert_array_equal(mean, jassets.load_mean_mano_pose())
    opt = dataclasses.replace(Options(net="backbone_incepv3"),
                              mean_mano_param=missing)
    assert np.abs(factory.build_model(opt)[1][3:]).max() == 0
