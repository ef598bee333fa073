"""The port's example scripts (``examples/*_torch.py``) on the CPU,
loaded by path (``examples/`` is not a package), each run with
``device="cpu"`` in a ``tmp_path`` cwd, against the JAX package:

  * quickstart: 24 train steps at 64 px in float32, the example's own
    reload assertion, then its ``hand_net.pth`` evaluated by
    ``scat_tpu``'s Evaluator on the same held-out batches: MPJPE within
    1e-3 mm and AUC within 1e-3 of the port's evaluation;
  * serve_artifact: an artifact of a small flagship (resnet18, 64 px,
    float32) whose weights come from a flax init through
    ``state_dict_from_flax``, served by the example against
    ``scat_tpu``'s live predictor on the same weights within 1e-3; the
    no-argument path (export, then serve) at that small size against the
    port's live predictor;
  * check_dataset: the synthetic, STB, FreiHAND and HO-3D loaders on
    written trees, one header line and up to ``--n`` batch lines each,
    the lines that the JAX example prints on the same trees;

and each one raises where CUDA is absent and the CPU was not asked for.
The examples' card runs are chip_smoke.py's examples phase."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dataset_trees import write_frei_tree, write_ho3d_tree
from stb_tree import write_stb_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "serve_artifact", "check_dataset")
IMG = 64
# the JAX package against the port in float32: the repo's model parity
# bar (1e-3), joints_2d in crop pixels (IMG / 2 a unit)
ATOL = 1e-3
KEYS = ("camera", "joints_3d", "joints_2d")


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch on one CPU thread: the tests' workers share the cores, and
    resnet50 runs on all of them in each worker oversubscribe them (the
    quickstart took 8x as long beside five busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name, suffix="_torch"):
    """``examples/{name}{suffix}.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}{suffix}",
        os.path.join(REPO, "examples", f"{name}{suffix}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _atol(key):
    return ATOL * (IMG / 2 if key == "joints_2d" else 1)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_cuda_unless_asked(name, monkeypatch, tmp_path):
    """Without ``device="cpu"`` each example asks for CUDA, and raises
    where it is absent; it writes nothing before that."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = _load(name).main
    with pytest.raises(RuntimeError, match="CUDA"):
        main([]) if name == "check_dataset" else main()
    assert os.listdir(tmp_path) == []


def test_quickstart_against_jax(monkeypatch, tmp_path, capsys):
    from scat_tpu.config import BaseOptions as JBaseOptions
    from scat_tpu.evaluation.evaluator import Evaluator as JEvaluator

    monkeypatch.chdir(tmp_path)
    out = _load("quickstart").main(device="cpu")
    text = capsys.readouterr().out
    # the JAX example's prints: a loss every 8 of 24 steps, the export,
    # the reload and the summary
    for i in (0, 8, 16):
        assert f"step {i:3d}  loss {out['losses'][i]:12.1f}" in text
    assert sorted(out["losses"]) == [0, 8, 16]
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert f"-> {out['pth']}" in text
    assert "reloaded .pth reproduces the evaluation exactly" in text
    res, res2 = out["eval"], out["reload"]
    assert abs(res2["mpjpe_mm"] - res["mpjpe_mm"]) < 1e-3
    assert f"done: PA-MPJPE {res['mpjpe_mm']:.2f} mm" in text
    assert os.path.isfile(tmp_path / "output" / "eval_0219" / "hand_net.pth")

    # the same .pth and batches through the JAX package's Evaluator
    jopt = JBaseOptions().parse(
        ["--net", "reg_transformer", "--vit_heads", "2", "--iteration",
         "1", "--batch_size", "8", "--compute_dtype", "float32",
         "--use_pallas_attention", "False", "--result_dir",
         str(tmp_path / "jax_eval"), "--checkpoint_path_eval",
         os.path.abspath(out["pth"])])
    held_out = [{k: v.cpu().numpy() for k, v in b.items()}
                for b in out["held_out"]]
    assert held_out[0]["image"].shape == (8, IMG, IMG, 3)
    jres = JEvaluator(jopt, image_size=IMG, dataset=held_out).eval()
    assert abs(jres["mpjpe_mm"] - res["mpjpe_mm"]) < 1e-3, (jres, res)
    assert abs(jres["auc"] - res["auc"]) < 1e-3, (jres, res)


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(JAX live predictor, artifact dir) of one set of weights: a flax
    init of a small flagship, carried to the port and exported there on
    the CPU."""
    from scat_tpu.models.hand_net import EncoderTransformer as JEncoder
    from scat_tpu.serving import HandPosePredictor as JPredictor
    from scat_tpu_torch import assets, export
    from scat_tpu_torch.models.hand_net import EncoderTransformer
    from scat_tpu_torch.serving import HandPosePredictor
    from scat_tpu_torch.utils.weights import state_dict_from_flax

    rng = np.random.RandomState(0)
    mean = assets.load_mean_params()
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=1, heads=2,
                  token_dim=(IMG // 8) ** 2, backbone="resnet18",
                  use_pallas=False)
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    variables = jax.jit(lambda x: jm.init(jax.random.key(0), x,
                                          train=False))(x)
    params = _unfreeze(variables["params"])
    params["mask_token"] = rng.randn(*params["mask_token"].shape).astype(
        np.float32)
    bs = _unfreeze(variables["batch_stats"])
    jpred = JPredictor(model=jm, params=params, batch_stats=bs,
                       image_size=IMG, max_batch=8)
    tm = EncoderTransformer(mean_params=torch.from_numpy(mean), iteration=1,
                            heads=2, token_dim=(IMG // 8) ** 2,
                            backbone="resnet18", use_kernel=True)
    tm.load_state_dict(state_dict_from_flax(params, bs), strict=True)
    live = HandPosePredictor(model=tm, image_size=IMG, max_batch=8,
                             device="cpu")
    path = str(tmp_path_factory.mktemp("artifact") / "flagship")
    export.export_predictor(live, path, net="reg_transformer")
    return jpred, path


def test_serve_artifact_against_jax(carried, capsys):
    jpred, path = carried
    out = _load("serve_artifact").main(path, device="cpu")
    text = capsys.readouterr().out
    crops = np.random.default_rng(0).integers(0, 256, (5, IMG, IMG, 3),
                                              np.uint8)
    np.testing.assert_array_equal(out["crops"], crops)
    assert out["live"] is None and "exported" not in text
    assert ("camera: (5, 3) joints_3d: (5, 21, 3) joints_2d: (5, 21, 2)"
            in text), text
    assert f"sample camera row: {np.round(out['out']['camera'][0], 4)}" \
        in text
    want = jpred.predict(crops)
    for k in KEYS:
        np.testing.assert_allclose(out["out"][k], want[k], atol=_atol(k),
                                   rtol=0, err_msg=k)


def test_serve_artifact_exports_then_serves(monkeypatch, tmp_path, capsys):
    """The no-argument path at a small size (2 heads, iteration 1, 64 px,
    float32): the fresh-init flagship exported to a new temporary
    directory, served from there, equal to its live predictor."""
    module = _load("serve_artifact")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(module, "FLAGSHIP", dict(
        module.FLAGSHIP, iteration=1, vit_heads=2, compute_dtype="float32"))
    monkeypatch.setattr(module, "IMAGE_SIZE", IMG)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = module.main(device="cpu")
    text = capsys.readouterr().out
    art = out["artifact"]
    assert os.path.dirname(art) == str(tmp_path)
    assert os.path.basename(art).startswith("scat_artifact_")
    assert f"exported fresh-init flagship -> {art}" in text
    assert out["served"].manifest["device"] == "cpu"
    assert out["served"].image_size == IMG
    want = out["live"].predict(out["crops"])
    for k in KEYS:
        assert out["out"][k].shape == want[k].shape
        np.testing.assert_allclose(out["out"][k], want[k], atol=1e-5,
                                   rtol=0, err_msg=k)


def _lines(text):
    """The loader header lines and the batch lines of a run's output."""
    return [line for line in text.splitlines()
            if line.startswith("==") or line.startswith("  batch ")]


def test_check_dataset_on_written_trees(monkeypatch, tmp_path, capsys):
    root = tmp_path / "data"
    # full-size STB frames: the loader's crop lies inside them
    stb = write_stb_tree(str(root / "STB"), n=4, height=480, width=640)
    write_frei_tree(str(root), n=8)
    write_ho3d_tree(str(root))
    out_dir = tmp_path / "plots"
    out_dir.mkdir()
    monkeypatch.chdir(tmp_path)
    argv = ["--data_dir", stb, "--n", "2", "--out_dir", str(out_dir)]
    seen = _load("check_dataset").main(argv + ["--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert list(seen) == ["synthetic", "STB", "FreiHAND", "HO3D"]
    headers = [line for line in lines if line.startswith("==")]
    assert headers == ["== synthetic: 2 batches", "== STB: 2 batches",
                       "== FreiHAND: 2 batches", "== HO3D: 1 batches"]
    for header, name in zip(headers, seen):
        n = min(2, int(header.split()[-2]))
        assert len(seen[name]) == n, (name, lines)
        for line in seen[name]:
            assert line in lines and "image(4, 224, 224, 3) [-1.00,1.00]" \
                in line and "valid=1.00" in line, line
    # a plot of each loader's first sample where matplotlib imports
    if importlib.util.find_spec("matplotlib") is not None:
        assert sorted(os.listdir(out_dir)) == sorted(
            f"{name}_debug.png" for name in seen)

    # the JAX example on the same trees prints the same lines: loaders,
    # batch counts, NHWC shapes, ranges and valid shares
    monkeypatch.setattr(sys, "argv", ["check_dataset.py"] + argv)
    _load("check_dataset", suffix="").main()
    assert _lines(capsys.readouterr().out) == lines


def test_check_dataset_skips_missing_trees(monkeypatch, tmp_path, capsys):
    """No tree under --data_dir: the synthetic batches, then the three
    skip lines of the JAX example."""
    monkeypatch.chdir(tmp_path)
    seen = _load("check_dataset").main(
        ["--data_dir", str(tmp_path / "STB"), "--n", "1", "--out_dir",
         str(tmp_path)], device="cpu")
    text = capsys.readouterr().out
    assert len(seen["synthetic"]) == 1
    assert "image(4, 224, 224, 3)" in seen["synthetic"][0]
    assert seen["STB"] is seen["FreiHAND"] is seen["HO3D"] is None
    for line in (f"== STB: no data under {tmp_path / 'STB'}, skipped",
                 "== FreiHAND: no data, skipped", "== HO3D: no data, skipped"):
        assert line in text, text
