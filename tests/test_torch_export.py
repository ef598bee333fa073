"""The port's serving artifact (``scat_tpu_torch.export``) on the CPU.

A small flagship (resnet18, 64-px crops, 2 heads, iteration 1, float32)
with weights from a flax init through ``state_dict_from_flax``: its
artifact, exported and loaded on the CPU, against the port's live
``HandPosePredictor`` and the JAX package's live predictor on the same
weights (the JAX side through its Pallas attention in interpret mode);
a small ViP artifact (32-px crops) against its live predictor; the
custom-op nodes of the exported graphs; ``opcheck`` of the four ops'
CPU implementations; an artifact served by a process that imports no
model module; the contract errors; and ``--serve_artifact`` over HTTP.
The CUDA graphs that serve an artifact on the card are checked in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import http.client
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scat_tpu.models.hand_net import EncoderTransformer as JEncoder
from scat_tpu.serving import HandPosePredictor as JPredictor
from scat_tpu_torch import assets, export, server
from scat_tpu_torch.config import Options
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.ops import attention, favor
from scat_tpu_torch.serving import HandPosePredictor
from scat_tpu_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
MAX_BATCH = 8
# the artifact runs the live predictor's ops: float32 rounding apart,
# the same numbers; against JAX, the model parity bar of the port's f32
# tests at this size
ATOL_LIVE, ATOL_JAX = 1e-5, 1e-4
KEYS = ("camera", "joints_3d", "joints_2d")


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.asarray(tree)


def _atol(key, atol):
    # joints_2d are crop pixels: IMG / 2 pixels per unit
    return atol * (IMG / 2 if key == "joints_2d" else 1)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(JAX live predictor, port live predictor, artifact dir, artifact)
    of one set of weights."""
    rng = np.random.RandomState(0)
    mean = assets.load_mean_params()
    jm = JEncoder(mean_params=jnp.asarray(mean), iteration=1, heads=2,
                  token_dim=(IMG // 8) ** 2, backbone="resnet18",
                  use_pallas=True)
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    variables = jax.jit(lambda x: jm.clone(use_pallas=False).init(
        jax.random.key(0), x, train=False))(x)
    params = _unfreeze(variables["params"])
    params["mask_token"] = rng.randn(*params["mask_token"].shape).astype(
        np.float32)
    bs = _unfreeze(variables["batch_stats"])
    jpred = JPredictor(model=jm, params=params, batch_stats=bs,
                       image_size=IMG, max_batch=MAX_BATCH)
    tm = EncoderTransformer(mean_params=torch.from_numpy(mean), iteration=1,
                            heads=2, token_dim=(IMG // 8) ** 2,
                            backbone="resnet18", use_kernel=True)
    tm.load_state_dict(state_dict_from_flax(params, bs), strict=True)
    live = HandPosePredictor(model=tm, image_size=IMG, max_batch=MAX_BATCH,
                             device="cpu")
    path = str(tmp_path_factory.mktemp("artifact") / "flagship")
    manifest = export.export_predictor(live, path, net="reg_transformer")
    assert manifest["device"] == "cpu" and manifest["max_batch"] == MAX_BATCH
    return jpred, live, path, export.ExportedPredictor(path, device="cpu")


@pytest.fixture(scope="module")
def crops():
    rng = np.random.RandomState(1)
    return {n: rng.randint(0, 256, (n, IMG, IMG, 3)).astype(np.uint8)
            for n in (1, 5, 70)}


def _close(got, want, atol, what):
    for k in KEYS:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], atol=_atol(k, atol),
                                   rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("n", [1, 5, 70])
def test_artifact_matches_live_and_jax(flagship, crops, n):
    """uint8 requests of 1, 5 and 70 crops (70: nine chunks of the top
    bucket 8, the last padded)."""
    jpred, live, _, art = flagship
    got = art.predict(crops[n])
    _close(got, live.predict(crops[n]), ATOL_LIVE, "port live")
    _close(got, jpred.predict(crops[n]), ATOL_JAX, "JAX live")
    np.testing.assert_allclose(got["joints_3d"][:, 1], 0.0, atol=1e-6)


def test_float32_request_matches_live_and_jax(flagship, crops):
    jpred, live, _, art = flagship
    x = crops[5][:3].astype(np.float32) / 127.5 - 1.0
    got = art.predict(x)
    _close(got, live.predict(x), ATOL_LIVE, "port live")
    _close(got, jpred.predict(x), ATOL_JAX, "JAX live")


def test_predict_from_frames(flagship):
    """Whole frames and rough 2D hints: one warp, then the artifact, as
    the live predictor does it."""
    _, live, _, art = flagship
    rng = np.random.RandomState(2)
    frames = rng.randint(0, 256, (3, 96, 128, 3)).astype(np.uint8)
    hints = (rng.rand(3, 21, 2) * [80, 60] + [20, 15]).astype(np.float32)
    got = art.predict_from_frames(frames, hints)
    want = live.predict_from_frames(frames, hints)
    np.testing.assert_array_equal(got["crop_affine"], want["crop_affine"])
    _close(got, want, ATOL_LIVE, "predict_from_frames")


def test_flagship_graphs_hold_the_attention_op(flagship):
    """3 attention_fwd nodes in each program: one per pyramid layer; no
    profiler op (the model's spans record nothing while no profiler
    runs, as under torch.export)."""
    art = flagship[-1]
    assert set(art.programs) == {"uint8", "float32"}
    for name, module in art.programs.items():
        assert export.op_nodes(module) == {"attention_fwd": 3}, name
        targets = [str(node.target) for sub in module.modules()
                   if getattr(sub, "graph", None) is not None
                   for node in sub.graph.nodes]
        assert targets and not [t for t in targets if "profiler" in t], name


def test_vip_artifact_matches_live(tmp_path):
    """A ViP artifact (32-px crops, 65 tokens, FAVOR+ through the ops):
    3 favor_stats and 3 favor_apply nodes a program, and the live
    predictor's outputs."""
    opt = Options(net="ViP", use_pallas_favor=True, compute_dtype="float32",
                  checkpoint_path_eval="", seed=3)
    live = HandPosePredictor.from_checkpoint(opt, image_size=32,
                                             device="cpu")
    path = str(tmp_path / "vip")
    export.export_predictor(live, path, net="ViP")
    art = export.ExportedPredictor(path, device="cpu")
    for name, module in art.programs.items():
        assert export.op_nodes(module) == {"favor_stats": 3,
                                           "favor_apply": 3}, name
    x = np.random.RandomState(4).randint(0, 256, (5, 32, 32, 3)).astype(
        np.uint8)
    for k in KEYS:
        np.testing.assert_allclose(art.predict(x)[k], live.predict(x)[k],
                                   atol=ATOL_LIVE * (16 if k == "joints_2d"
                                                     else 1), rtol=0)


def _qkv(shape, dtype, seed=0):
    b, h, n, d = shape
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g).to(dtype)
    return qkv.permute(2, 0, 3, 1, 4)


def _op_cases():
    q, k, v = _qkv((2, 2, 21, 64), torch.float32)
    g = torch.Generator().manual_seed(1)
    do = torch.randn(2, 21, 2, 64, generator=g).permute(0, 2, 1, 3)
    fk, fv = (torch.randn(2, 3, 17, 16, generator=g) for _ in range(2))
    w = torch.randn(8, 16, generator=g)
    ksum, kptv = favor.favor_stats(fk, fv, w)
    return {
        "attention_fwd": (attention._attention_fwd, (q, k, v, 0.125)),
        "attention_fwd-bf16": (attention._attention_fwd,
                               tuple(t.bfloat16() for t in (q, k, v))
                               + (0.125,)),
        "attention_bwd": (attention._attention_bwd, (q, k, v, do, 0.125)),
        "favor_stats": (favor._favor_stats, (fk, fv, w)),
        "favor_stats-bf16": (favor._favor_stats,
                             (fk.bfloat16(), fv.bfloat16(), w)),
        "favor_apply": (favor._favor_apply, (fk, ksum, kptv, w)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_ops_pass_opcheck(case):
    """The ops' schema, fake implementation (shapes and strides of the
    CPU outputs), autograd registration and dispatch under
    ``torch.library.opcheck``."""
    op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result


def test_ops_cpu_match_the_plain_versions():
    """The CPU implementations are the plain versions, in the kernels'
    output layouts."""
    q, k, v = _qkv((2, 2, 21, 64), torch.float32)
    out = torch.ops.scat_tpu_torch.attention_fwd(q, k, v, 0.125)
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, attention.attention_reference(
        q, k, v, 0.125), rtol=0, atol=0)
    g = torch.Generator().manual_seed(2)
    fk, fv = (torch.randn(1, 2, 9, 8, generator=g) for _ in range(2))
    w = torch.randn(4, 8, generator=g)
    ksum, kptv = torch.ops.scat_tpu_torch.favor_stats(fk, fv, w)
    want = favor.favor_stats_reference(fk, fv, w)
    torch.testing.assert_close((ksum, kptv), want, rtol=0, atol=0)
    y = torch.ops.scat_tpu_torch.favor_apply(fk, ksum, kptv, w)
    assert y.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(y, favor.favor_apply_reference(
        fk, ksum, kptv, w), rtol=0, atol=0)


def test_artifact_serves_without_model_modules(flagship):
    """A fresh process loads and serves the artifact; no module of
    ``scat_tpu_torch.models`` is imported."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from scat_tpu_torch.export import ExportedPredictor\n"
        "p = ExportedPredictor(sys.argv[1], device='cpu')\n"
        "out = p.predict(np.zeros((3, p.image_size, p.image_size, 3),"
        " np.uint8))\n"
        "assert out['joints_3d'].shape == (3, 21, 3)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('scat_tpu_torch.models')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code, flagship[2]], check=True,
                   env=env, cwd=REPO, timeout=300)


def test_artifact_holds_one_weights_file(flagship):
    """The programs take the weights as an input: the directory holds one
    ``weights.npz`` under the reference keys, the programs lift no
    parameter, and the loaded predictor holds the live model's tensors."""
    _, live, path, art = flagship
    assert sorted(os.listdir(path)) == ["forward_float32.pt2",
                                        "forward_uint8.pt2", "manifest.json",
                                        "weights.npz"]
    weights_mb = os.path.getsize(os.path.join(path, "weights.npz")) / 1e6
    for name in export.DTYPES:
        program = torch.export.load(export.program_path(path, name))
        assert not program.state_dict, sorted(program.state_dict)[:3]
        assert program.example_inputs is None
        # a program without the weights is a small part of their size
        mb = os.path.getsize(export.program_path(path, name)) / 1e6
        assert mb < 0.1 * weights_mb, (name, mb, weights_mb)
    want = live.model.state_dict()
    assert sorted(art.weights) == sorted(want)
    for k, v in want.items():
        assert torch.equal(art.weights[k], v), k


def test_weights_file_bitcasts_bf16(tmp_path):
    """bf16 tensors ship bit-cast to uint16 and come back bit for bit."""
    sd = {"a.weight": torch.randn(4, 3, 2, 2).bfloat16(),
          "a.bias": torch.randn(4), "n": torch.tensor(7)}
    path = str(tmp_path / "w.npz")
    bitcast = export.save_weights(sd, path)
    assert bitcast == {"a.weight": "bfloat16"}
    back = export.load_weights_npz(path, bitcast, torch.device("cpu"))
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    assert back["a.weight"].is_contiguous(memory_format=torch.channels_last)


def test_refuses_integer_requests_other_than_uint8(flagship, crops):
    with pytest.raises(ValueError, match="uint8"):
        flagship[-1].predict(crops[1].astype(np.int32))


def _manifest_only(src, dst, **changes):
    """A directory holding ``src``'s manifest with ``changes``."""
    os.makedirs(dst)
    with open(os.path.join(src, export.MANIFEST)) as f:
        manifest = json.load(f)
    manifest.update(changes)
    with open(os.path.join(dst, export.MANIFEST), "w") as f:
        json.dump(manifest, f)
    return dst


def test_refuses_another_format(flagship, tmp_path):
    path = _manifest_only(flagship[2], str(tmp_path / "a"), format=1)
    with pytest.raises(ValueError, match="format"):
        export.ExportedPredictor(path, device="cpu")


def test_refuses_another_device_type(flagship, tmp_path):
    """An artifact exported for CUDA never serves on the CPU."""
    path = _manifest_only(flagship[2], str(tmp_path / "a"), device="cuda")
    with pytest.raises(ValueError, match="exported for cuda"):
        export.ExportedPredictor(path, device="cpu")


def test_defaults_to_cuda(flagship, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export.ExportedPredictor(flagship[2])


def _post(port, arr):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/predict", body=arr.tobytes(), headers={
        "X-Shape": ",".join(map(str, arr.shape)),
        "X-Dtype": str(arr.dtype)})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, body
    return {k: np.asarray(v, np.float32) for k, v in body.items()}


def test_serve_artifact_over_http(flagship, crops, monkeypatch):
    """``server.main(["--serve_artifact", DIR])`` (the artifact loaded on
    the CPU in place of the card) answers POST /predict with exactly what
    ``predict`` returns and names the artifact in GET /healthz."""
    art, path = flagship[-1], flagship[2]
    loaded = []
    monkeypatch.setattr(export, "load_artifact",
                        lambda p, device=None: loaded.append(p) or
                        export.ExportedPredictor(p, device="cpu"))
    made = []
    real_make = server.make_server

    def make(*a, **kw):
        made.append(real_make(*a, **kw))
        return made[-1]

    monkeypatch.setattr(server, "make_server", make)
    thread = threading.Thread(target=server.main, args=(
        ["--serve_artifact", path, "--server_host", "127.0.0.1",
         "--server_port", "0"],), daemon=True)
    thread.start()
    try:
        for _ in range(600):
            if made or not thread.is_alive():
                break
            thread.join(0.1)
        assert made and loaded == [path]
        port = made[0].server_address[1]
        x = crops[5]
        for body in (x, x.astype(np.float32) / 127.5 - 1.0):
            got, want = _post(port, body), art.predict(body)
            for k in KEYS:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["source"] == f"artifact:{path}"
        assert health["net"] == "reg_transformer"
    finally:
        if made and thread.is_alive():
            made[0].shutdown()
            made[0].server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_export_main_writes_the_artifact(tmp_path, capsys):
    """``python -m scat_tpu_torch.export`` (``scat-tpu-torch-export``)
    with ``--device cpu``: the manifest and both programs."""
    out = str(tmp_path / "out")
    export.main(["--device", "cpu", "--net", "reg_transformer",
                 "--vit_heads", "2", "--iteration", "1", "--compute_dtype",
                 "float32", "--checkpoint_path_eval=", "--export_dir", out])
    assert sorted(os.listdir(out)) == ["forward_float32.pt2",
                                       "forward_uint8.pt2", "manifest.json",
                                       "weights.npz"]
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["net"] == "reg_transformer"
    assert manifest["image_size"] == 224 and manifest["device"] == "cpu"
    assert "exported reg_transformer" in capsys.readouterr().out
