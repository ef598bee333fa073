"""The port's serving slice against the JAX package's, on the CPU.

The whole EncoderTransformer (resnet18 backbone, 32x32 crops, 2 heads,
iteration 3) with the JAX side through its Pallas attention kernel in
interpret mode, and the port through its kernel wrapper (which takes the
plain version on CPU tensors); weights cross through
``state_dict_from_flax``.  Then the port's predictor against the JAX
predictor, its bucketing and dtype contract, and the HTTP round trip."""

import http.client
import json
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scat_tpu.models.hand_net import EncoderTransformer as JEncoder
from scat_tpu.serving import HandPosePredictor as JPredictor
from scat_tpu_torch import assets
from scat_tpu_torch.config import BaseOptions, Options
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.ops.attention import flash_attention
from scat_tpu_torch.server import MicroBatcher, make_server
from scat_tpu_torch.serving import (HandPosePredictor, bucket_ladder,
                                    pick_bucket, run_bucketed)
from scat_tpu_torch.utils.weights import state_dict_from_flax

ATOL = 1e-3   # the bar of tests/test_full_model_parity.py
IMG = 32


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.asarray(tree)


def _randomize_bn(tree, rng):
    for k, sub in tree.items():
        if k == "mean":
            tree[k] = rng.uniform(-0.1, 0.1, sub.shape).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)
        else:
            _randomize_bn(sub, rng)


@pytest.fixture(scope="module")
def pair():
    """(flax module, params, batch_stats, port module) with one set of
    weights; the flax init and apply are jitted once here."""
    rng = np.random.RandomState(0)
    mean = assets.load_mean_params()
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=3, heads=2,
                  token_dim=(IMG // 8) ** 2, backbone="resnet18",
                  use_pallas=True)
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    # the parameter tree does not depend on the attention path
    variables = jax.jit(lambda x: jm.clone(use_pallas=False).init(
        jax.random.key(0), x, train=False))(x)
    params = _unfreeze(variables["params"])
    params["mask_token"] = rng.randn(1, 1, 16).astype(np.float32)
    bs = _unfreeze(variables["batch_stats"])
    _randomize_bn(bs, rng)
    apply = jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=False))

    tm = EncoderTransformer(mean_params=torch.from_numpy(mean),
                            iteration=3, heads=2, token_dim=16,
                            backbone="resnet18", use_kernel=True)
    tm.load_state_dict(state_dict_from_flax(params, bs), strict=True)
    tm.eval()
    return jm, params, bs, apply, tm


def test_encoder_transformer_matches_jax(pair, rng):
    _, params, bs, apply, tm = pair
    x = (rng.randn(2, IMG, IMG, 3) * 0.5).astype(np.float32)
    pred, fv = apply(params, bs, x)
    with torch.no_grad():
        tpred, tfv = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(tfv.numpy().transpose(0, 2, 3, 1),
                               np.asarray(fv), atol=ATOL,
                               err_msg="conv1x1 feature map")
    np.testing.assert_allclose(tpred.numpy(), np.asarray(pred), atol=ATOL,
                               err_msg="pred_params")
    np.testing.assert_allclose(tpred.numpy()[:, 6:9], 0.0, atol=1e-6,
                               err_msg="joint 1 is the root")


def test_predictor_matches_jax(pair, rng):
    jm, params, bs, _, tm = pair
    crops = (rng.rand(3, IMG, IMG, 3) * 255).astype(np.uint8)
    # one bucket (4) keeps the JAX side to one compiled program
    want = JPredictor(model=jm, params=params, batch_stats=bs,
                      image_size=IMG, max_batch=4).predict(crops)
    got = HandPosePredictor(model=tm, image_size=IMG, max_batch=4,
                            device="cpu").predict(crops)
    for k in ("camera", "joints_3d", "joints_2d"):
        assert got[k].shape == want[k].shape, k
        # joints_2d are crop pixels: 112 x the normalized coordinates
        np.testing.assert_allclose(got[k], want[k],
                                   atol=ATOL * (112 if k == "joints_2d"
                                                else 1), err_msg=k)


@pytest.fixture(scope="module")
def predictor(pair):
    return HandPosePredictor(model=pair[-1], image_size=IMG, device="cpu")


def test_predict_shapes_and_padding(predictor, rng):
    out = predictor.predict((rng.rand(3, IMG, IMG, 3) * 255).astype(np.uint8))
    assert out["camera"].shape == (3, 3)
    assert out["joints_3d"].shape == (3, 21, 3)
    assert out["joints_2d"].shape == (3, 21, 2)
    assert all(np.isfinite(v).all() for v in out.values())
    np.testing.assert_allclose(out["joints_3d"][:, 1], 0.0, atol=1e-6)


def test_predict_bucketing_consistency(predictor, rng):
    imgs = (rng.rand(5, IMG, IMG, 3) * 255).astype(np.uint8)
    full = predictor.predict(imgs)   # pads to bucket 8
    for i in range(5):
        single = predictor.predict(imgs[i:i + 1])
        np.testing.assert_allclose(full["joints_3d"][i],
                                   single["joints_3d"][0], atol=1e-4)


def test_predict_uint8_matches_float(predictor, rng):
    u8 = (rng.rand(2, IMG, IMG, 3) * 255).astype(np.uint8)
    a = predictor.predict(u8)
    b = predictor.predict(u8.astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_allclose(a["joints_3d"], b["joints_3d"], atol=1e-5)


def test_oversized_request_chunks_and_device_times(pair, rng):
    p = HandPosePredictor(model=pair[-1], image_size=IMG, max_batch=4,
                          device="cpu")
    assert p._buckets == [1, 2, 4]
    imgs = (rng.rand(9, IMG, IMG, 3) * 255).astype(np.uint8)
    times = []
    timed = p.predict(imgs, chunk_device_times=times)
    assert len(times) == 3 and all(t > 0 for t in times)  # 4 + 4 + 1
    fast = p.predict(imgs)
    for k in fast:
        assert fast[k].shape[0] == 9
        np.testing.assert_allclose(timed[k], fast[k], atol=1e-6)


def test_rejects_non_uint8_integers(predictor, rng):
    with pytest.raises(ValueError, match="uint8"):
        predictor.predict((rng.rand(2, IMG, IMG, 3) * 255).astype(np.int32))


def test_bucket_ladder_and_pick():
    assert bucket_ladder(64) == [1, 2, 4, 8, 16, 32, 64]
    assert bucket_ladder(60) == [1, 2, 4, 8, 16, 32, 60]
    assert [pick_bucket(n, [1, 2, 4, 8]) for n in (1, 3, 5, 8, 100)] \
        == [1, 4, 8, 8, 8]


def test_run_bucketed_order_and_padding():
    """Output rows come back in request order with the padding cut off."""
    seen = []

    def forward(xb):
        seen.append(xb.shape[0])
        tag = xb[:, 0, 0, 0:1].float()
        n = xb.shape[0]
        return (torch.cat([tag, torch.zeros(n, 2)], 1),
                torch.zeros(n, 21, 3), torch.zeros(n, 21, 2))

    x = np.zeros((11, 2, 2, 3), np.float32)
    x[:, 0, 0, 0] = np.arange(1, 12)
    out = run_bucketed(forward, x, [1, 2, 4], torch.from_numpy, window=2)
    assert seen == [4, 4, 4]
    np.testing.assert_array_equal(out["camera"][:, 0], np.arange(1, 12))


def test_from_checkpoint_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = Options(net="reg_transformer", vit_heads=2, iteration=1,
                  checkpoint_path_eval="")
    with pytest.raises(RuntimeError, match="CUDA"):
        HandPosePredictor.from_checkpoint(opt, image_size=IMG)


def test_from_checkpoint_cpu_flagship_flags():
    """The flagship flag line builds a predictor; a seeded fresh init is
    the same for the kernel and the plain attention path."""
    argv = ("--net reg_transformer --vit_heads 2 --iteration 3 "
            "--compute_dtype float32 --checkpoint_path_eval=").split()
    opt = BaseOptions().parse(argv)
    assert opt.iteration == 3 and opt.use_pallas_attention
    a = HandPosePredictor.from_checkpoint(opt, image_size=IMG, device="cpu")
    opt.use_pallas_attention = False
    b = HandPosePredictor.from_checkpoint(opt, image_size=IMG, device="cpu")
    crops = np.random.RandomState(4).rand(2, IMG, IMG, 3).astype(np.float32)
    np.testing.assert_allclose(a.predict(crops)["joints_3d"],
                               b.predict(crops)["joints_3d"], atol=1e-5)


def test_bf16_compute_dtype():
    opt = Options(net="reg_transformer", vit_heads=2, iteration=3,
                  compute_dtype="bfloat16", checkpoint_path_eval="")
    p = HandPosePredictor.from_checkpoint(opt, image_size=IMG, device="cpu")
    assert p.model.transformer.layers[0][0].fn.fn.to_qkv.weight.dtype \
        == torch.bfloat16
    assert p.model.regressor.weight.dtype == torch.float32
    out = p.predict(np.zeros((1, IMG, IMG, 3), np.uint8))
    assert out["joints_3d"].dtype == np.float32
    assert np.isfinite(out["joints_3d"]).all()


@pytest.mark.parametrize("net,cls,out", [
    ("reg_transformer_coarse", "EncoderTransformerCoarse", 66),
    ("backbone_hrnet", "EncoderTransformerHRNet", 61),
    ("backbone_incepv3", "EncoderTransformerInception", 61),
    ("ViT", "ViT", 66),
    ("frankmocap", "H3DWEncoder", 61)])
def test_ported_nets_build(net, cls, out):
    """The nets of ROADMAP.md queue 1 items 9, 10, 11 and 12 build in the
    port."""
    model, mean = build_model(Options(net=net))
    assert type(model).__name__ == cls and mean.shape == (out,)


def test_training_only_paths_raise():
    """The training-only paths arrived with the training slice and no
    longer raise: pl_reg builds on the plain attention path, and token
    masking runs in train mode only."""
    m, _ = build_model(Options(net="reg_transformer", vit_heads=2,
                               pl_reg=True), image_size=IMG)
    assert m.pl_reg and not m.transformer.layers[0][0].fn.fn.use_kernel
    m, _ = build_model(Options(net="reg_transformer", vit_heads=2,
                               mask_rate=0.2), image_size=IMG)
    x = torch.zeros(2, 3, IMG, IMG)
    flags = torch.zeros(21, dtype=torch.bool)
    m.eval()
    with torch.no_grad():
        plain = m(x)[0]
        assert torch.equal(m(x, token_mask=~flags)[0], plain)
    m.train()
    with torch.no_grad():
        assert torch.isfinite(m(x)[0]).all()
        masked = m(x, token_mask=~flags)[0]
        assert not torch.allclose(masked, m(x, token_mask=flags)[0])


def _post(port, arr):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/predict", body=arr.tobytes(), headers={
        "X-Shape": ",".join(map(str, arr.shape)),
        "X-Dtype": str(arr.dtype)})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("window_ms", [0.0, 50.0])
def test_server_roundtrip(predictor, rng, window_ms):
    httpd = make_server(predictor, port=0, batch_window_ms=window_ms)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        imgs = (rng.rand(3, IMG, IMG, 3) * 255).astype(np.uint8)
        local = predictor.predict(imgs)
        for body in (imgs, imgs.astype(np.float32) / 127.5 - 1.0):
            status, out = _post(port, body)
            assert status == 200, out
            for k in ("camera", "joints_3d", "joints_2d"):
                np.testing.assert_allclose(np.asarray(out[k]), local[k],
                                           atol=1e-5, err_msg=k)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["image_size"] == IMG
        status, err = _post(port, imgs[:, :16])
        assert status == 400 and "X-Shape" in err["error"]
        batcher = httpd.RequestHandlerClass.predictor
        assert isinstance(batcher, MicroBatcher) == (window_ms > 0)
    finally:
        httpd.shutdown()
        httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_flash_attention_count_is_a_plain_int():
    assert isinstance(flash_attention.launches, int)
