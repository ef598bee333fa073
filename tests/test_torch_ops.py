"""The port's geometry, procrustes, metrics, losses, token masking,
synthetic data and lr schedule against the JAX package's, in float32 on
the CPU.  Inputs come from a seeded numpy RandomState and go to both
sides; the JAX side's random numbers (synthetic draws) are handed to the
port's pure renderer."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scat_tpu.data import synthetic as jsynthetic
from scat_tpu.models import losses as jlosses
from scat_tpu.ops import geometry as jgeometry
from scat_tpu.ops import metrics as jmetrics
from scat_tpu.ops import procrustes as jprocrustes
from scat_tpu.training import schedule as jschedule
from scat_tpu_torch import assets
from scat_tpu_torch.data import synthetic
from scat_tpu_torch.models import losses
from scat_tpu_torch.models.transformer import random_token_mask
from scat_tpu_torch.ops import geometry, metrics, procrustes
from scat_tpu_torch.training import schedule

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=msg)


# ---- geometry -------------------------------------------------------------

def test_rodrigues_both_forms(rng):
    r = (rng.randn(16, 3) * 0.8).astype(np.float32)
    r[0] = 0.0                # the Taylor form, exactly at theta = 0
    r[1] = 3e-7               # ... and below the 1e-6 switch
    _close(geometry.batch_rodrigues(_t(r)),
           jgeometry.batch_rodrigues(jnp.asarray(r)), msg="quaternion")
    _close(geometry.rodrigues_guarded(_t(r)),
           jgeometry.rodrigues_guarded(jnp.asarray(r)), msg="guarded")
    quat = rng.randn(5, 4).astype(np.float32)
    _close(geometry.quat2mat(_t(quat)), jgeometry.quat2mat(jnp.asarray(quat)))


def test_rodrigues_guarded_gradient_finite_at_zero():
    r = torch.zeros(2, 3, requires_grad=True)
    geometry.rodrigues_guarded(r).sum().backward()
    assert torch.isfinite(r.grad).all()


def test_root_center(rng):
    j = rng.randn(3, 21, 3).astype(np.float32)
    _close(geometry.root_center(_t(j)), jgeometry.root_center(jnp.asarray(j)))
    assert torch.all(geometry.root_center(_t(j))[:, 1] == 0)


# ---- procrustes -----------------------------------------------------------

@pytest.mark.parametrize("layout", ["BN3", "B3N"])
def test_similarity_align(rng, layout):
    s1 = rng.randn(6, 21, 3).astype(np.float32)
    s2 = (s1 @ np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32) * 1.3
          + rng.randn(6, 21, 3).astype(np.float32) * 0.05)
    if layout == "B3N":
        s1, s2 = s1.transpose(0, 2, 1), s2.transpose(0, 2, 1)
    want = jprocrustes.similarity_align(jnp.asarray(s1), jnp.asarray(s2))
    got = procrustes.similarity_align(_t(s1), _t(s2))
    assert got.shape == s1.shape
    _close(got, want, atol=1e-4)


def test_similarity_align_ignores_svd_signs(rng, monkeypatch):
    """Flipping the sign of a pair of singular vectors (another valid
    SVD) changes nothing."""
    s1 = rng.randn(4, 21, 3).astype(np.float32)
    s2 = rng.randn(4, 21, 3).astype(np.float32)
    want = procrustes.similarity_align(_t(s1), _t(s2))
    svd = torch.linalg.svd

    def flipped(a):
        u, s, vh = svd(a)
        u, vh = u.clone(), vh.clone()
        u[:, :, 0] *= -1
        vh[:, 0, :] *= -1
        u[:, :, 2] *= -1
        vh[:, 2, :] *= -1
        return u, s, vh

    monkeypatch.setattr(torch.linalg, "svd", flipped)
    _close(procrustes.similarity_align(_t(s1), _t(s2)), want, atol=1e-5)


# ---- metrics --------------------------------------------------------------

@pytest.mark.parametrize("flat", [True, False])
def test_pck_mpjpe_auc(rng, flat):
    gt = rng.randn(5, 21, 3).astype(np.float32) * 0.05
    pred = gt + rng.randn(5, 21, 3).astype(np.float32) * 0.02
    valid = np.array([1, 0, 1, 1, 0], np.float32)
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else _t(v)
        _close(metrics.cal_pck(_t(pred), _t(gt), flat_compat=flat, valid=tv),
               jmetrics.cal_pck(jnp.asarray(pred), jnp.asarray(gt),
                                flat_compat=flat, valid=jv), atol=1e-4)
        pck, auc = metrics.pck_auc(_t(pred), _t(gt), flat_compat=flat,
                                   valid=tv)
        jpck, jauc = jmetrics.pck_auc(jnp.asarray(pred), jnp.asarray(gt),
                                      flat_compat=flat, valid=jv)
        _close(pck, jpck, atol=1e-4)
        _close(auc, jauc, rtol=1e-6)  # AUC of percentages, ~60
    _close(metrics.mpjpe(_t(pred), _t(gt)),
           jmetrics.mpjpe(jnp.asarray(pred), jnp.asarray(gt)))
    _close(metrics.joint_distances_mm(_t(pred), _t(gt)),
           jmetrics.joint_distances_mm(jnp.asarray(pred), jnp.asarray(gt)),
           atol=1e-3)
    _close(metrics.get_dist_pck(_t(pred), _t(gt)),
           jmetrics.get_dist_pck(jnp.asarray(pred), jnp.asarray(gt)),
           atol=1e-4)
    x = np.linspace(0, 1, 7).astype(np.float32)
    y = rng.rand(7).astype(np.float32)
    _close(metrics.area_under_curve(x, y), jmetrics.area_under_curve(x, y))


def test_valid_sample_mask(rng):
    imgs = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    imgs[1] = 1.0     # a white failed crop
    imgs[2] = -1.0    # a black one
    want = jmetrics.valid_sample_mask(jnp.asarray(imgs), threshold=20.0)
    got = metrics.valid_sample_mask(_t(imgs), threshold=20.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 0, 0, 1])


# ---- losses ---------------------------------------------------------------

@pytest.mark.parametrize("width", [105, 166])
@pytest.mark.parametrize("with_valid", [False, True])
def test_scat_loss(rng, width, with_valid):
    b = 4
    p3 = rng.randn(b, 63).astype(np.float32) * 0.05
    p2 = rng.rand(b, 42).astype(np.float32) * 224
    labels = rng.randn(b, width).astype(np.float32)
    valid = np.array([1, 0, 1, 0], np.float32) if with_valid else None
    jb, _ = jlosses.scat_loss(jnp.asarray(p3), jnp.asarray(p2),
                              jnp.asarray(labels), 1e5, 10.0,
                              valid=None if valid is None
                              else jnp.asarray(valid))
    tb, _ = losses.scat_loss(_t(p3), _t(p2), _t(labels), 1e5, 10.0,
                             valid=None if valid is None else _t(valid))
    for name in ("total", "l_3d", "l_2d", "l_pl"):
        _close(getattr(tb, name), getattr(jb, name), rtol=1e-5,
               msg=name)
    views = losses.split_labels(_t(labels))
    assert (views.pose is None) == (width == 105)
    with pytest.raises(ValueError, match="105/166"):
        losses.split_labels(torch.zeros(2, 100))


def test_masked_mean_all_invalid_is_zero(rng):
    x = _t(rng.randn(3, 63).astype(np.float32))
    assert float(losses._masked_mean(x, torch.zeros(3))) == 0.0


@pytest.mark.parametrize("compat", [True, False])
def test_path_length_loss(rng, compat):
    g = rng.randn(3, 8, 8, 21).astype(np.float32)      # NHWC, as JAX
    state = np.float32(0.37)
    jl, jstate = jlosses.path_length_loss(jnp.asarray(g), jnp.asarray(state),
                                          ema_reset_compat=compat)
    tl, tstate = losses.path_length_loss(_t(g.transpose(0, 3, 1, 2)),
                                         torch.tensor(state),
                                         ema_reset_compat=compat)
    _close(tl, jl, rtol=1e-5)
    _close(tstate, jstate, rtol=1e-6)
    # and inside scat_loss, with its x10 weight
    lab = rng.randn(3, 105).astype(np.float32)
    p3, p2 = lab[:, :63], lab[:, 63:]
    jb, _ = jlosses.scat_loss(jnp.asarray(p3), jnp.asarray(p2),
                              jnp.asarray(lab), 1.0, 1.0,
                              pl_grad=jnp.asarray(g),
                              pl_mean_state=jnp.asarray(state),
                              ema_reset_compat=compat)
    tb, _ = losses.scat_loss(_t(p3), _t(p2), _t(lab), 1.0, 1.0,
                             pl_grad=_t(g.transpose(0, 3, 1, 2)),
                             pl_mean_state=torch.tensor(state),
                             ema_reset_compat=compat)
    _close(tb.total, jb.total, rtol=1e-5)


# ---- token masking --------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5, 0.9])
def test_random_token_mask_count_and_marginals(rate):
    n, draws = 21, 4000
    k = int(rate * n)
    gen = torch.Generator().manual_seed(0)
    flags = torch.stack([random_token_mask(n, rate, gen)
                         for _ in range(draws)])
    assert flags.dtype == torch.bool and flags.shape == (draws, n)
    assert torch.all(flags.sum(dim=1) == k)
    # uniform marginals: every token masked with probability k/n; 5
    # standard deviations of a draws-sample frequency
    p = k / n
    freq = flags.float().mean(dim=0).numpy()
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / draws)), freq
    # seeded: the same generator state gives the same mask
    a = random_token_mask(n, rate, torch.Generator().manual_seed(3))
    b = random_token_mask(n, rate, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


# ---- synthetic data -------------------------------------------------------

@pytest.mark.parametrize("layout", ["stb", "frei"])
def test_synthetic_render_matches_jax(layout):
    """The port's renderer fed the JAX draws equals _synth_batch_impl."""
    b, size = 3, 64
    mean = assets.load_mean_params()
    template = mean[3:].reshape(21, 3)
    key = jax.random.key(5)
    want = jsynthetic._synth_batch_impl(key, b, size, jnp.asarray(template),
                                        layout)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {
        "rotvec": jax.random.normal(k4, (b, 3)) * 0.4,
        "jitter": jax.random.normal(k1, (b, 21, 3)) * 0.002,
        "scale": 5.0 + jax.random.normal(k2, (b, 1)) * 0.3,
        "trans": jax.random.normal(k3, (b, 2)) * 0.02}
    got = synthetic.render({k: _t(v) for k, v in draws.items()},
                           _t(template), size, layout)
    _close(got["image"], want["image"], atol=1e-5, msg="image")
    # labels: 3D in meters, 2D in pixels up to ~224
    _close(got["label"], want["label"], atol=1e-4, rtol=1e-6, msg="label")
    _close(got["valid"], want["valid"])


def test_synthetic_dataset_is_seeded():
    a = list(synthetic.SyntheticDataset(2, num_batches=2, seed=1,
                                        image_size=32))
    b = list(synthetic.SyntheticDataset(2, num_batches=2, seed=1,
                                        image_size=32))
    c = list(synthetic.SyntheticDataset(2, num_batches=2, seed=2,
                                        image_size=32))
    assert len(a) == 2 and a[0]["image"].shape == (2, 32, 32, 3)
    assert a[0]["label"].shape == (2, 105)
    assert all(torch.equal(x["image"], y["image"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["image"], a[1]["image"])
    assert not torch.equal(a[0]["image"], c[0]["image"])
    frei = next(iter(synthetic.SyntheticDataset(2, num_batches=1,
                                                image_size=32,
                                                layout="frei")))
    assert frei["label"].shape == (2, 166)
    with pytest.raises(ValueError, match="layout"):
        synthetic.SyntheticDataset(2, layout="rhd")


# ---- schedule -------------------------------------------------------------

def test_warmup_schedule_matches_optax():
    base, spe = 5e-4, 3
    jsched = jschedule.warmup_schedule(base, spe)
    model = torch.nn.Linear(2, 2)
    opt, sched = schedule.make_optimizer(model, base, spe)
    for step in range(17 * spe):   # epochs 0-16, across the ramp's end
        got = opt.param_groups[0]["lr"]
        np.testing.assert_allclose(got, float(jsched(step)), rtol=1e-6,
                                   err_msg=f"step {step}")
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(base)
