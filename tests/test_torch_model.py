"""The port's model modules against the JAX package's, in float32 on the
CPU, with the same weights carried by scat_tpu_torch.utils.weights; the
ResNet with BatchNorm and with GroupNorm.

Inputs come from a seeded numpy RandomState and go to both sides."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scat_tpu.models import resnet as jresnet
from scat_tpu.models import transformer as jtransformer
from scat_tpu.models.hand_net import EncoderTransformer as JEncoder
from scat_tpu.ops import geometry as jgeometry
from scat_tpu.utils.torch_import import export_torch_encoder_transformer
from scat_tpu_torch import assets
from scat_tpu_torch.models import resnet, transformer
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.ops import geometry
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.utils.weights import state_dict_from_flax


def _unfreeze(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.asarray(tree)


def _randomize_bn(batch_stats, rng):
    """Non-trivial running statistics, so eval-mode BN is exercised."""
    if "mean" in batch_stats:
        batch_stats["mean"] = rng.uniform(
            -0.1, 0.1, batch_stats["mean"].shape).astype(np.float32)
        batch_stats["var"] = rng.uniform(
            0.5, 1.5, batch_stats["var"].shape).astype(np.float32)
        return
    for sub in batch_stats.values():
        _randomize_bn(sub, rng)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_resnet18_five_outputs(rng):
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = jresnet.resnet18()
    variables = jax.jit(lambda x: jm.init(jax.random.key(0), x,
                                          train=False))(x)
    params = _unfreeze(variables["params"])
    bs = _unfreeze(variables["batch_stats"])
    _randomize_bn(bs, rng)
    want = jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=False))(params, bs, x)

    tm = resnet.get_model("resnet18")
    sd = _strip(state_dict_from_flax({"main_encoder": params},
                                     {"main_encoder": bs}), "main_encoder.")
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, err_msg="fc1 feature")
    for i in range(1, 5):
        np.testing.assert_allclose(
            got[i].numpy().transpose(0, 2, 3, 1), np.asarray(want[i]),
            atol=1e-4, err_msg=f"stage x{i}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pyramid_transformer(rng, use_kernel):
    x = rng.randn(2, 21, 64).astype(np.float32)
    jm = jtransformer.PyramidTransformer(dim=64, depth=3, heads=2,
                                         use_pallas=use_kernel)
    params = _unfreeze(jm.init(jax.random.key(1), x)["params"])
    want = jm.apply({"params": params}, x)

    tm = transformer.PyramidTransformer(dim=64, depth=3, heads=2,
                                        use_kernel=use_kernel)
    tm.load_state_dict(_strip(state_dict_from_flax({"transformer": params}),
                              "transformer."), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 21, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("max_len,d_model,atol", [
    (21, 16, 1e-6), (21, 196, 1e-6), (128, 196, 1e-6),
    # flagship table: XLA's and torch's float32 exp round 31 of the 392
    # frequencies one ulp apart; at position 20 that one ulp moves the
    # angle, and sin, by up to 1.9e-6 = one ulp of a float32 near 20
    (21, 784, 2e-6)])
def test_sinusoidal_position_encoding(max_len, d_model, atol):
    got = transformer.sinusoidal_position_encoding(max_len, d_model)
    want = jtransformer.sinusoidal_position_encoding(max_len, d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_geometry(rng):
    j3d = rng.randn(4, 21, 3).astype(np.float32)
    cam = rng.randn(4, 3).astype(np.float32)
    want = jgeometry.project_2d(jgeometry.batch_orth_proj_idrot(
        jnp.asarray(j3d), jnp.asarray(cam)))
    got = geometry.project_2d(geometry.batch_orth_proj_idrot(
        torch.from_numpy(j3d), torch.from_numpy(cam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mean_params_match():
    from scat_tpu import assets as jassets
    for outside in (True, False):
        np.testing.assert_array_equal(
            assets.load_mean_params(outside=outside),
            jassets.load_mean_params(outside=outside))


@pytest.fixture(scope="module")
def flax_encoder():
    """One flax init of a small EncoderTransformer (resnet18, 32x32)."""
    mean = assets.load_mean_params()
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=2, heads=2,
                  token_dim=16, backbone="resnet18")
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = jax.jit(lambda x: jm.init(jax.random.key(3), x,
                                          train=False))(x)
    return (mean, _unfreeze(variables["params"]),
            _unfreeze(variables["batch_stats"]))


def test_state_dict_from_flax_matches_exporter(flax_encoder):
    _, params, bs = flax_encoder
    got = state_dict_from_flax(params, bs)
    want = export_torch_encoder_transformer(params, bs)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def _port_encoder(mean):
    return EncoderTransformer(mean_params=torch.from_numpy(mean),
                              iteration=2, heads=2, token_dim=16,
                              backbone="resnet18")


def test_state_dict_loads_strict(flax_encoder):
    mean, params, bs = flax_encoder
    tm = _port_encoder(mean)
    tm.load_state_dict(state_dict_from_flax(params, bs), strict=True)
    # the port's own keys are the reference layout, PE buffer aside
    assert "transformer.layers.0.0.fn.fn.to_qkv.weight" in tm.state_dict()
    assert "main_encoder.layer1.0.conv1.weight" in tm.state_dict()
    assert not any("pe" == k.split(".")[-1] for k in tm.state_dict())


def test_load_weights_pth_roundtrip(flax_encoder, tmp_path):
    mean, params, bs = flax_encoder
    sd = state_dict_from_flax(params, bs)
    # a reference .pth also carries the PE buffer, which the port drops
    sd[checkpoint.PE_KEY] = torch.zeros(1, 21, 16)
    path = str(tmp_path / "hand_net_final.pth")
    torch.save({"state_dict": sd}, path)
    tm = _port_encoder(mean)
    checkpoint.load_weights(tm, path)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_load_weights_errors(tmp_path):
    tm = _port_encoder(assets.load_mean_params())
    with pytest.raises(FileNotFoundError):
        checkpoint.load_weights(tm, str(tmp_path / "missing.pth"))
    with pytest.raises(ValueError, match=".pth"):
        checkpoint.load_weights(tm, str(tmp_path))
    # a checkpoint of another architecture fails loudly: an unknown
    # layout, or a known one of which no tensor matches, as the JAX
    # package's _load_pth_into raises
    bad = str(tmp_path / "bad.pth")
    torch.save({"regressor.weight": torch.zeros(66, 1090)}, bad)
    with pytest.raises(ValueError, match="unrecognized"):
        checkpoint.load_weights(tm, bad)
    assert os.path.exists(bad)
    torch.save({"layer1.0.conv1.weight": torch.zeros(64, 64, 1, 1)}, bad)
    with pytest.raises(ValueError, match="architecture mismatch"):
        checkpoint.load_weights(tm, bad)


def test_fresh_init_is_seeded():
    mean = assets.load_mean_params()
    a, b, c = (_port_encoder(mean) for _ in range(3))
    checkpoint.load_weights(a, "", seed=0)
    checkpoint.load_weights(b, "", seed=0)
    checkpoint.load_weights(c, "", seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["regressor.weight"], sc["regressor.weight"])
    # flax's init distributions: lecun-normal kernels, zero biases
    w = sa["main_encoder.fc1.weight"]
    assert abs(w.std().item() * w.shape[1] ** 0.5 - 1.0) < 0.05
    assert torch.all(sa["regressor.bias"] == 0)


def test_cast_compute_keeps_norm_layers_float32(flax_encoder):
    """bf16 serving rounds only the compute: BatchNorm weights and running
    statistics, LayerNorm parameters and the regressor stay float32, as
    the JAX package keeps them."""
    mean, params, bs = flax_encoder
    tm = _port_encoder(mean)
    tm.load_state_dict(state_dict_from_flax(params, bs), strict=True)
    tm.cast_compute(torch.bfloat16)
    norms = [m for m in tm.modules()
             if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm))]
    assert len(norms) == 20 + 5   # resnet18's BNs, the pyramid's LNs
    for m in norms:
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.float32, (m, name)
    assert tm.conv1x1_channel_reduction.weight.dtype == torch.bfloat16
    assert tm.main_encoder.layer1[0].conv1.weight.dtype == torch.bfloat16
    assert tm.regressor.weight.dtype == torch.float32


def test_bf16_eval_forward_matches_jax_bf16(flax_encoder, rng):
    """The bf16 eval forward against the JAX package's bf16 forward from
    the same weights.  The two differ only in where rounding of the
    compute lands (XLA's and oneDNN's bf16 convolutions round partial
    results differently; one flipped bf16 rounding, 2^-9 relative, moves
    later activations), so they are held to the bound of the card's
    bf16 checks (chip_smoke.py): 2% of the largest magnitude."""
    mean, params, bs = flax_encoder
    bs = _unfreeze(bs)   # new dicts: the fixture's stay as they are
    _randomize_bn(bs, np.random.RandomState(1))
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=2, heads=2,
                  token_dim=16, backbone="resnet18", dtype=jnp.bfloat16)
    x = (rng.randn(2, 32, 32, 3) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=False))(params, bs, x)[0])
    tm = _port_encoder(mean)
    tm.load_state_dict(state_dict_from_flax(params, bs), strict=True)
    tm.cast_compute(torch.bfloat16).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))[0].numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# norm_layer="group" (scat_tpu/models/resnet.py:27-48)

@pytest.fixture(scope="module")
def flax_group_encoder():
    """One flax init of the small EncoderTransformer with GroupNorm."""
    mean = assets.load_mean_params()
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=2, heads=2,
                  token_dim=16, backbone="resnet18", norm_layer="group")
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = jax.jit(lambda x: jm.init(jax.random.key(5), x,
                                          train=False))(x)
    params = _unfreeze(variables["params"])
    # non-trivial affines, so that a swapped scale or bias shows
    rng = np.random.RandomState(2)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [p.key for p in path]
        if "GroupNorm_0" in keys:
            node = params
            for k in keys[:-1]:
                node = node[k]
            node[keys[-1]] = (leaf + rng.uniform(-0.3, 0.3, leaf.shape)
                              ).astype(np.float32)
    return mean, jm, params


def _group_encoder(mean, **kw):
    return EncoderTransformer(mean_params=torch.from_numpy(mean),
                              iteration=2, heads=2, token_dim=16,
                              backbone="resnet18", norm_layer="group", **kw)


@pytest.mark.parametrize("channels", [16, 64, 256])
def test_group_norm_matches_flax(rng, channels):
    """The port's GroupNorm against flax's nn.GroupNorm with min(32, C)
    groups and eps 1e-5, affine from the same numbers: within 1e-5; bf16
    input keeps its dtype, float32 statistics."""
    import flax.linen as fnn
    x = (rng.randn(2, 5, 7, channels) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = rng.randn(channels).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=min(32, channels), epsilon=1e-5)
    want = jm.apply({"params": {"scale": scale, "bias": bias}}, x)
    gn = resnet.GroupNorm(channels)
    assert gn.num_groups == min(32, channels) and gn.eps == 1e-5
    gn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)}, strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        got = gn(xt)
        got_bf16 = gn(xt.to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=1e-5)
    assert got_bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf16.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), atol=5e-2)


def test_group_norm_flagship_matches_flax(flax_group_encoder, rng,
                                         tmp_path):
    """The flagship with norm_layer="group" carried from flax by
    state_dict_from_flax (``bn1/GroupNorm_0``, ``_GN_<i>/GroupNorm_0``,
    ``downsample_bn/GroupNorm_0`` -> ``bnK`` and ``downsample.1``, no
    running buffers), loaded strictly: the f32 forward in eval and train
    mode (the same: no batch statistics) within 1e-3; a .pth of it loads
    strictly into a fresh GroupNorm model."""
    mean, jm, params = flax_group_encoder
    sd = state_dict_from_flax(params)
    path = str(tmp_path / "hand_net_final.pth")
    torch.save({"state_dict": sd}, path)
    loaded = _group_encoder(mean)
    checkpoint.load_weights(loaded, path)
    assert all(torch.equal(v, sd[k]) for k, v in loaded.state_dict().items())
    assert "main_encoder.layer2.0.downsample.1.weight" in sd
    assert "main_encoder.bn1.bias" in sd
    assert not any("running" in k or "num_batches" in k for k in sd)
    tm = _group_encoder(mean)
    tm.load_state_dict(sd, strict=True)
    x = (rng.randn(2, 32, 32, 3) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, train=False))(params, x)[0])
    for mode in (tm.eval, tm.train):
        mode()
        with torch.no_grad():
            got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))[0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_group_norm_bf16_and_cast_compute(flax_group_encoder, rng):
    """bf16 serving keeps every GroupNorm float32 and matches the JAX
    package's bf16 forward to 2% of the largest magnitude (the bound of
    the bf16 BatchNorm case above)."""
    mean, _, params = flax_group_encoder
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=2, heads=2,
                  token_dim=16, backbone="resnet18", norm_layer="group",
                  dtype=jnp.bfloat16)
    x = (rng.randn(2, 32, 32, 3) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, train=False))(params, x)[0])
    tm = _group_encoder(mean)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    tm.cast_compute(torch.bfloat16).eval()
    norms = [m for m in tm.modules() if isinstance(m, resnet.GroupNorm)]
    assert len(norms) == 20
    assert all(m.weight.dtype == torch.float32 for m in norms)
    assert tm.main_encoder.layer1[0].conv1.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_group_norm_train_step_matches_jax(flax_group_encoder, rng):
    """One float32 train step of the GroupNorm flagship against the JAX
    package's make_train_step from the same weights and batch: the loss
    within 1e-3 relative, the updated regressor and stem within 1e-5
    (Adam moves a weight by about the learning rate, 5e-4)."""
    from scat_tpu.training import schedule as jschedule
    from scat_tpu.training import steps as jsteps
    from scat_tpu.training.state import TrainState as JState
    from scat_tpu_torch.training import schedule, steps
    from scat_tpu_torch.training.state import TrainState
    mean, jm, params = flax_group_encoder
    offsets = mean[3:66].reshape(21, 3)
    j3d = (offsets[None] + rng.randn(2, 21, 3) * 0.02).astype(np.float32)
    j3d -= j3d[:, 1:2]
    j2d = (rng.rand(2, 21, 2) * 180 + 22).astype(np.float32)
    label = np.concatenate([j3d.reshape(2, 63), j2d.reshape(2, 42)], 1)
    img = (rng.randn(2, 32, 32, 3) * 0.5).astype(np.float32)
    tx = jschedule.make_optimizer(5e-4, 4)
    jstate = JState.create(params, {}, tx, jax.random.key(1))
    jstate, jstats = jax.jit(jsteps.make_train_step(jm, tx, 1e5, 10.0))(
        jstate, {"image": jnp.asarray(img), "label": jnp.asarray(label),
                 "valid": jnp.ones(2)})
    tm = _group_encoder(mean)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    opt, sched = schedule.make_optimizer(tm, 5e-4, 4)
    state = TrainState.create(tm, opt, sched, seed=0)
    stats = steps.make_train_step(1e5, 10.0)(state, {
        "image": torch.from_numpy(img), "label": torch.from_numpy(label),
        "valid": torch.ones(2)})
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-3)
    sd = state.model.state_dict()
    np.testing.assert_allclose(
        sd["regressor.weight"].numpy(),
        np.asarray(jstate.params["regressor"]["kernel"]).T, atol=1e-5)
    np.testing.assert_allclose(
        sd["main_encoder.bn1.weight"].numpy(),
        np.asarray(jstate.params["main_encoder"]["bn1"]["GroupNorm_0"][
            "scale"]), atol=1e-5)
