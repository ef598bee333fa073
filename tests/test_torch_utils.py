"""The port's training utilities on the CPU, against the JAX package's
where it has them: ``utils/profiling.py`` (``StepTimer``,
``TraceWindow``, ``profiler_trace``, ``benchmark_fn``),
``utils/debugging.py``, the TensorBoard mirror of ``utils/logging.py``,
``viz/draw.py``'s debug figures, ``viz/render.py``,
``models/config_test.py``, and the Trainer's ``--debug``,
``--profile_trace_dir`` and ``--tensorboard`` with the Evaluator's
``--tensorboard``."""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from scat_tpu.models import config_test as jconfig_test
from scat_tpu.models.hand_net import EncoderTransformer as JEncoder
from scat_tpu.utils import debugging as jdebugging
from scat_tpu.viz import draw as jdraw
from scat_tpu.viz import render as jrender
from scat_tpu_torch import assets
from scat_tpu_torch.config import Options
from scat_tpu_torch.data.synthetic import SyntheticDataset
from scat_tpu_torch.evaluation.evaluator import Evaluator
from scat_tpu_torch.models import config_test
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.training.trainer import Trainer
from scat_tpu_torch.utils import debugging, profiling
from scat_tpu_torch.utils.logging import MetricsLogger
from scat_tpu_torch.viz import draw, render

IMG = 32


def _joints(seed):
    rng = np.random.RandomState(seed)
    j2d = (rng.rand(21, 2) * 180 + 20).astype(np.float32)
    j3d = (rng.randn(21, 3) * 0.05).astype(np.float32)
    return j2d, j3d


def _image(seed, size=224):
    return np.random.RandomState(seed).randint(0, 256, (size, size, 3)
                                               ).astype(np.uint8)


def _png(path):
    import cv2
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


# --- profiling --------------------------------------------------------

def test_step_timer_counts_after_warmup():
    timer = profiling.StepTimer(batch_size=4, warmup=1)
    for _ in range(4):
        timer.tick(torch.zeros(1))
    assert timer.counted_steps == 3
    assert timer.ms_per_step > 0
    assert timer.samples_per_sec == pytest.approx(
        4 * 3 / (timer.ms_per_step * 3 / 1000))
    timer.reset()
    assert timer.counted_steps == 0 and np.isnan(timer.ms_per_step)


def test_trace_window_writes_its_steps(tmp_path):
    """The window opens at step(3), after the 3rd step, and closes at
    step(5): steps 4 and 5 of six are traced into trace.json, with the
    model's ops; the steps outside the window are not."""
    window = profiling.TraceWindow(str(tmp_path), n_steps=2, start_step=3)
    lin = nn.Linear(8, 8)
    for step in range(1, 7):
        with torch.profiler.record_function(f"step{step}"):
            lin(torch.ones(2, 8))
        window.step(step)
    window.stop()
    with open(window.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step4", "step5", "aten::linear"} <= names
    assert not names & {"step1", "step2", "step3", "step6"}


def test_trace_window_warns_on_a_short_run(tmp_path, capsys):
    window = profiling.TraceWindow(str(tmp_path), n_steps=2, start_step=3)
    window.step(1)
    window.step(2)
    window.stop()
    window.stop()
    out = capsys.readouterr().out
    assert out.count("the run ended before step 3") == 1
    assert not os.listdir(tmp_path)


def test_trace_window_off_without_a_dir():
    window = profiling.TraceWindow(None)
    for step in range(1, 30):
        window.step(step)
    window.stop()
    assert window.path is None


def test_profiler_trace_and_benchmark_fn(tmp_path):
    with profiling.profiler_trace(str(tmp_path)):
        torch.ones(3).sum()
    assert os.path.exists(tmp_path / profiling.TRACE_FILE)
    with profiling.profiler_trace(None):
        pass
    res = profiling.benchmark_fn(lambda x: x * 2, torch.ones(4), iters=3,
                                 batch_size=4)
    assert res["ms_per_step"] > 0 and res["samples_per_sec"] > 0
    assert res["samples_per_sec_per_chip"] == res["samples_per_sec"]


# --- debugging --------------------------------------------------------

def test_assert_all_finite_names_the_bad_keys():
    model = nn.Sequential(nn.Linear(2, 2), nn.BatchNorm1d(2))
    debugging.assert_all_finite(model)
    with torch.no_grad():
        model[0].weight[0, 0] = float("nan")
        model[1].running_var[1] = float("inf")
    with pytest.raises(FloatingPointError) as e:
        debugging.assert_all_finite(model, "model")
    assert "0.weight" in str(e.value) and "1.running_var" in str(e.value)
    assert "0.bias" not in str(e.value)
    debugging.assert_all_finite({"a": [np.ones(2), torch.arange(3)]})
    with pytest.raises(FloatingPointError, match=r"\['a'\]\[1\]"):
        debugging.assert_all_finite({"a": [np.ones(2), np.array([np.nan])]})


def test_check_determinism():
    debugging.check_determinism(
        lambda g: {"x": torch.randn(3, generator=g), "n": 1})
    with pytest.raises(AssertionError):
        debugging.check_determinism(lambda g: torch.randn(3))


def test_check_graph_consistency_on_the_cpu():
    """Eager against the torch.export program: a module passes; a
    program that draws random numbers on each run does not."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 8), nn.GELU(), nn.Linear(8, 2))
    debugging.check_graph_consistency(model, torch.randn(3, 4))
    with pytest.raises(AssertionError):
        debugging.check_graph_consistency(
            lambda x: x + torch.rand(x.shape), torch.randn(3, 4))


def test_count_params_matches_jax():
    """The same flagship (resnet18, 32 px, 2 heads) counts the same
    parameters in both packages."""
    mean = assets.load_mean_params()
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=1, heads=2,
                  token_dim=(IMG // 8) ** 2, backbone="resnet18")
    variables = jax.jit(lambda x: jm.init(jax.random.key(0), x,
                                          train=False))(
        np.zeros((1, IMG, IMG, 3), np.float32))
    tm = EncoderTransformer(mean_params=torch.from_numpy(mean), iteration=1,
                            heads=2, token_dim=(IMG // 8) ** 2,
                            backbone="resnet18")
    want = jdebugging.count_params(variables["params"])
    assert debugging.count_params(tm) == want
    assert debugging.count_params(
        [p.detach() for p in tm.parameters()]) == want


# --- logging ----------------------------------------------------------

def test_tensorboard_mirror_writes_events(tmp_path):
    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    logger.log(1, {"loss": 2.0, "nan": float("nan")})
    logger.log(2, {"loss": 1.0, "nan": 0.5})
    logger.close()
    events = glob.glob(str(tmp_path / "tb" / "metrics" / "events.out.*"))
    assert len(events) == 1 and os.path.getsize(events[0]) > 0
    with open(tmp_path / "metrics.csv") as f:
        assert len(f.read().splitlines()) == 3


def test_tensorboard_without_tensorboardx_keeps_the_csv(tmp_path, capsys,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    logger.log(1, {"loss": 2.0})
    logger.close()
    assert "tensorboardX is not installed; CSV only" in \
        capsys.readouterr().out
    assert os.listdir(tmp_path) == ["metrics.csv"]


# --- viz --------------------------------------------------------------

def test_debug_pred_gt_matches_jax(tmp_path):
    """The same arrays draw the same 2x2 grid, pixel for pixel."""
    gt2, gt3 = _joints(0)
    pr2, pr3 = _joints(1)
    image = _image(2)
    got = draw.debug_pred_gt(image, gt2, gt3, pr2, pr3, "single",
                             out_dir=str(tmp_path / "port"))
    want = jdraw.debug_pred_gt(image, gt2, gt3, pr2, pr3, "single",
                               out_dir=str(tmp_path / "jax"))
    assert os.path.basename(got) == "debug_gt_pred_single.png"
    np.testing.assert_array_equal(_png(got), _png(want))


def test_vis_heatmap_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    img = rng.rand(224, 224, 3).astype(np.float32) * 2 - 1
    gt = rng.rand(4, 56, 56).astype(np.float32)
    pred = rng.rand(4, 56, 56).astype(np.float32) - 0.2
    got = draw.vis_heatmap(img, gt, pred, str(tmp_path / "port.png"))
    want = jdraw.vis_heatmap(img, gt, pred, str(tmp_path / "jax.png"))
    assert got.shape == (4 * 224, 2 * 224, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_png(str(tmp_path / "port.png")),
                                  _png(str(tmp_path / "jax.png")))


def test_draw_3d_skeleton_and_fig2data_match_jax():
    _, j3d = _joints(4)
    got = draw.draw_3d_skeleton(j3d)
    np.testing.assert_array_equal(got, jdraw.draw_3d_skeleton(j3d))
    assert got.shape == (224, 224, 4) and got.dtype == np.uint8
    plt = draw._plt("a test figure")
    figs = []
    for module in (draw, jdraw):
        fig = plt.figure(figsize=(2, 2))
        module.plot_2d_hand(fig.add_subplot(111), _joints(5)[0], order="uv")
        figs.append(fig)
    np.testing.assert_array_equal(draw.fig2data(figs[0]),
                                  jdraw.fig2data(figs[1]))
    plt.close("all")


def test_debug_dataset_matches_jax(tmp_path):
    j2d, j3d = _joints(6)
    image = _image(7)
    got = draw.debug_dataset(image, j2d, j3d, str(tmp_path / "port.png"))
    want = jdraw.debug_dataset(image, j2d, j3d, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(_png(got), _png(want))


def test_figures_skip_without_matplotlib(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    j2d, j3d = _joints(8)
    assert draw.debug_pred_gt(None, j2d, j3d, j2d, j3d, "x",
                              out_dir=str(tmp_path / "d")) is None
    assert draw.draw_3d_skeleton(j3d) is None
    assert draw.debug_dataset(_image(9), j2d, j3d,
                              str(tmp_path / "x.png")) is None
    out = capsys.readouterr().out
    assert out.count("matplotlib unavailable, skipping") == 3
    assert not os.listdir(tmp_path)


def _mesh(seed):
    rng = np.random.RandomState(seed)
    verts = (rng.randn(60, 3) * 0.3).astype(np.float32)
    faces = rng.randint(0, 60, (90, 3))
    return verts, faces


@pytest.mark.parametrize("cv2_present", [True, False])
def test_render_mesh_overlay_matches_jax(cv2_present, monkeypatch):
    """The rasterizer (cv2) and the vertex splats (no cv2), exactly."""
    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)
    verts, faces = _mesh(10)
    image = _image(11, 96)
    cam = np.array([0.9, 0.05, -0.03], np.float32)
    got = render.render_mesh_overlay(image, verts, faces, cam)
    np.testing.assert_array_equal(
        got, jrender.render_mesh_overlay(image, verts, faces, cam))
    assert not np.array_equal(got, image)
    np.testing.assert_array_equal(
        render.weak_perspective_project(verts, cam, 96),
        jrender.weak_perspective_project(verts, cam, 96))
    np.testing.assert_array_equal(
        render.Renderer((96, 96))(verts, faces, cam),
        jrender.Renderer((96, 96))(verts, faces, cam))


# --- config_test ------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [], ["--vit_heads", "8"], ["--pos_embed=True", "--net", "ViP"],
    ["--iteration", "1", "--pos_embed", "False"]])
def test_config_test_matches_the_jax_twin(argv):
    got = dataclasses.asdict(config_test.BaseOptions().parse(argv))
    want = dataclasses.asdict(jconfig_test.BaseOptions().parse(argv))
    assert got == want
    if not argv:
        assert got["vit_heads"] == 4 and got["pos_embed"] is False


# --- the trainer's and the evaluator's flags --------------------------

def test_trainer_debug_profile_and_tensorboard(tmp_path, monkeypatch,
                                               capsys):
    """The canonical flag line's --debug True (the default) with
    --profile_trace_dir and --tensorboard True, 2 epochs of 2 steps at
    32 px: the grid (at each epoch's first batch), the trace of steps 3
    and 4 (the window opens at the 3rd step) and the events beside the
    CSV."""
    monkeypatch.chdir(tmp_path)
    trace_dir = str(tmp_path / "trace")
    opt = Options(net="reg_transformer", batch_size=2, lr=5e-4, epoch=2,
                  l_weight_3d=1e5, l_weight_2d=10.0, vit_heads=2,
                  iteration=1, mask_rate=0.2, synthetic_data=True,
                  steps_per_epoch=2, log_every=1, compute_dtype="float32",
                  profile_trace_dir=trace_dir, profile_trace_steps=2,
                  tensorboard=True, checkpoint_folder=str(tmp_path / "ck"))
    assert opt.debug and opt.debug_img == "single"
    Trainer(opt, device="cpu", image_size=IMG).train()
    out = capsys.readouterr().out
    assert out.count("==== Visualize ====") == 2
    assert os.path.exists(tmp_path / "debug_img" / "debug_gt_pred_single.png")
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names
    assert glob.glob(str(tmp_path / "ck" / "tb" / "metrics" / "events.*"))
    assert os.path.exists(tmp_path / "ck" / "hand_net_final.pth")


def test_evaluator_tensorboard(tmp_path):
    opt = Options(net="reg_transformer", vit_heads=2, iteration=1,
                  batch_size=2, compute_dtype="float32",
                  checkpoint_path_eval="", tensorboard=True,
                  result_dir=str(tmp_path / "eval"))
    result = Evaluator(opt, image_size=IMG, dataset=list(SyntheticDataset(
        2, num_batches=2, image_size=IMG)), device="cpu").eval()
    assert np.isfinite(result["mpjpe_mm"])
    assert glob.glob(str(tmp_path / "eval" / "tb" / "eval_metrics" /
                         "events.*"))
    with open(tmp_path / "eval" / "eval_metrics.csv") as f:
        assert len(f.read().splitlines()) == 1 + 2 + 1
