"""The port's file tools against the JAX package's: partial ``.pth``
loads against ``scat_tpu.utils.checkpoint._load_pth_into``, the flax
direction of the weights (``utils/weights.flax_from_state_dict``) against
``scat_tpu.utils.torch_import.import_torch_*``, ``convert`` on every
``--net`` (and the JAX package's ``to_orbax`` reading the port's
``.pth``), and ``validate_data`` against ``scat_tpu.validate_data`` on
the written trees of ``tests/dataset_trees.py`` and
``tests/stb_tree.py``.  Small sizes, on the CPU; the JAX trees come from
``jax.eval_shape`` filled with seeded draws (``tests/flax_trees.py``)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scat_tpu import assets as jassets
from scat_tpu import convert as jconvert
from scat_tpu import validate_data as jvalidate
from scat_tpu.config import Options as JOptions
from scat_tpu.models import helpers as jhelpers
from scat_tpu.models import hand_net as jhand_net
from scat_tpu.models import hrnet as jhrnet
from scat_tpu.models import inception as jinception
from scat_tpu.models import resnet as jresnet
from scat_tpu.models import vit as jvit
from scat_tpu.models.discriminator import MotionDiscriminator as JDisc
from scat_tpu.models.performer import ViP as JViP
from scat_tpu.utils import checkpoint as jcheckpoint
from scat_tpu.utils import torch_import
from scat_tpu_torch import assets, convert, validate_data
from scat_tpu_torch.config import Options
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models.hand_net import EncoderTransformer
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.utils import weights as W

from dataset_trees import (write_frei_tree, write_ho3d_tree, write_mhp_tree,
                           write_rhd_tree)
from flax_trees import variables as flax_variables
from stb_tree import write_stb_tree

IMG = 32


def _mean66():
    return jnp.asarray(jassets.load_mean_params())


def _mean61():
    return jnp.asarray(jassets.load_mean_mano_pose())


def _x(size):
    return np.zeros((1, size, size, 3), np.float32)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# net: (JAX module, init args, init kwargs, flax trees -> port state_dict,
#       JAX importer (state_dict, fresh trees) -> None, or None)
def _imp_encoder(coarse):
    return lambda sd, t: torch_import.import_torch_encoder_transformer(
        sd, t["params"], t["batch_stats"], depth=3, coarse=coarse)


NETS = {
    "reg_transformer": (
        lambda: jhand_net.EncoderTransformer(
            mean_params=_mean66(), iteration=1, heads=2,
            token_dim=(IMG // 8) ** 2, backbone="resnet18"),
        (_x(IMG),), dict(train=False),
        lambda v: W.state_dict_from_flax(v["params"], v["batch_stats"]),
        _imp_encoder(False)),
    "reg_transformer_coarse": (
        lambda: jhand_net.EncoderTransformerCoarse(
            mean_params=_mean66(), heads=2, token_dim=(IMG // 8) ** 2,
            backbone="resnet18"),
        (_x(IMG),), dict(train=False),
        lambda v: W.state_dict_from_flax(v["params"], v["batch_stats"],
                                         coarse=True),
        _imp_encoder(True)),
    "backbone_hrnet": (
        lambda: jhand_net.EncoderTransformerHRNet(mean_params=_mean61(),
                                                  heads=2),
        (_x(224),), dict(train=False),
        lambda v: W.hrnet_state_dict_from_flax(v["params"],
                                               v["batch_stats"]),
        lambda sd, t: torch_import.import_torch_hrnet_encoder(
            sd, t["params"], t["batch_stats"], depth=3)),
    "backbone_incepv3": (
        lambda: jhand_net.EncoderTransformerInception(mean_params=_mean61(),
                                                      heads=2),
        (_x(224),), dict(train=False),
        lambda v: W.inception_state_dict_from_flax(v["params"],
                                                   v["batch_stats"]),
        lambda sd, t: torch_import.import_torch_inception_encoder(
            sd, t["params"], t["batch_stats"], depth=3)),
    "ViT": (
        lambda: jvit.ViT(mean_params=_mean66(), image_size=IMG,
                         patch_size=8, dim=32, depth=2, heads=2),
        (_x(IMG),), dict(train=False),
        lambda v: W.vit_state_dict_from_flax(v["params"]),
        lambda sd, t: torch_import.import_torch_vit(
            sd, t["params"], t.setdefault("batch_stats", {}), depth=2)),
    "ViP": (
        lambda: JViP(mean_params=_mean66(), image_pix=IMG, patch_pix=4,
                     emb_s=16, heads=2, depth=2),
        (_x(IMG),), dict(train=False),
        lambda v: W.vip_state_dict_from_flax(v["params"], v["constants"]),
        lambda sd, t: torch_import.import_torch_vip(
            sd, t["params"], t["constants"], depth=2)),
    "frankmocap": (
        lambda: jhand_net.H3DWEncoder(mean_params=_mean61(),
                                      backbone="resnet18"),
        (_x(IMG),), dict(train=False),
        lambda v: W.h3dw_state_dict_from_flax(v["params"], v["batch_stats"]),
        lambda sd, t: torch_import.import_torch_auto(
            sd, t["params"], t["batch_stats"])),
    "motion_discriminator": (
        lambda: JDisc(rnn_size=16, input_size=48, num_layers=2,
                      feature_pool="attention", attention_size=16),
        (np.zeros((2, 4, 48), np.float32),), {},
        lambda v: W.motion_discriminator_state_dict_from_flax(v["params"]),
        lambda sd, t: torch_import.import_torch_motion_discriminator(
            sd, t["params"], num_layers=2)),
    "resnet": (
        lambda: jresnet.resnet18(),
        (_x(IMG),), dict(train=False),
        lambda v: W.truncated_resnet_state_dict_from_flax(
            v["params"], v["batch_stats"]),
        lambda sd, t: torch_import.import_torch_resnet(
            sd, t["params"], t["batch_stats"], stage_sizes=(2, 2, 2, 2))),
    "hrnet": (
        lambda: jhrnet.HRNet(c=16, nof_joints=32),
        (_x(64),), dict(train=False),
        lambda v: _strip(W.hrnet_state_dict_from_flax(
            {"main_encoder": v["params"]},
            {"main_encoder": v["batch_stats"]}), "main_encoder."),
        lambda sd, t: torch_import.import_torch_hrnet(
            sd, t["params"], t["batch_stats"])),
    "inception": (
        jinception.Inception3, (_x(75),), dict(train=False),
        lambda v: _strip(W.inception_state_dict_from_flax(
            {"main_encoder": v["params"]},
            {"main_encoder": v["batch_stats"]}), "main_encoder."),
        lambda sd, t: torch_import.import_torch_inception(
            sd, t["params"], t["batch_stats"])),
    "yunqian": (
        lambda: jvit.YunqianTransformer(dim=32, depth=2, heads=2,
                                        dim_head=16, mlp_dim=48, out_dim=61),
        (np.zeros((2, 9, 32), np.float32),), {},
        lambda v: W.yunqian_state_dict_from_flax(v["params"]), None),
    "spade": (
        lambda: jhelpers.SPADE(norm_nc=16, label_nc=3,
                               param_free_norm_type="batch"),
        (np.zeros((2, 8, 8, 16), np.float32),
         np.zeros((2, 13, 11, 3), np.float32)), dict(train=False),
        lambda v: W.spade_state_dict_from_flax(v["params"],
                                               v.get("batch_stats")),
        None),
}


def _leaves(tree, prefix=()):
    out = {}
    for k, v in (tree or {}).items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("net", sorted(NETS))
def test_flax_from_state_dict(net):
    """The reference-keyed state_dict of a flax tree goes back to the same
    tree, every leaf, and equals what the JAX package's importer merges
    from it into a zeroed tree."""
    make, args, kw, to_sd, importer = NETS[net]
    v = flax_variables(make(), np.random.RandomState(0), *args, **kw)
    sd = to_sd(v)
    back = W.flax_from_state_dict(net, sd)
    for col in ("params", "batch_stats", "constants"):
        want, got = _leaves(v.get(col)), _leaves(back[col])
        assert sorted(got) == sorted(want), (col, set(got) ^ set(want))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{col} {k}")
    if importer is None:
        return
    fresh = {col: _zeros(v[col]) for col in v}
    importer({k: t.numpy() for k, t in sd.items()}, fresh)
    for col in ("params", "batch_stats", "constants"):
        merged, got = _leaves(fresh.get(col)), _leaves(back[col])
        for k, val in got.items():
            np.testing.assert_array_equal(merged[k], val,
                                          err_msg=f"{col} {k}")


def test_flax_from_state_dict_refuses_an_unknown_net():
    with pytest.raises(ValueError, match="no flax interchange"):
        W.flax_from_state_dict("hand_net", {})


# ---------------------------------------------------------------------
# partial loads
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_flagship():
    """(JAX flagship, its flax trees, its jitted eval forward)."""
    jm = jhand_net.EncoderTransformer(mean_params=_mean66(), iteration=1,
                                      heads=2, depth=3,
                                      token_dim=(IMG // 8) ** 2,
                                      backbone="resnet18")
    v = flax_variables(jm, np.random.RandomState(1), _x(IMG), train=False)
    return jm, v, jax.jit(lambda p, b, x: jm.apply(
        {"params": p, "batch_stats": b}, x, train=False)[0])


def _port(v):
    """The port's flagship with the flax trees' weights."""
    tm = EncoderTransformer(torch.from_numpy(assets.load_mean_params()),
                            iteration=1, heads=2, depth=3,
                            token_dim=(IMG // 8) ** 2, backbone="resnet18")
    tm.load_state_dict(W.state_dict_from_flax(v["params"], v["batch_stats"]),
                       strict=True)
    return tm


def _donor(path, heads=2, depth=3, seed=7):
    m = EncoderTransformer(torch.from_numpy(assets.load_mean_params()),
                           iteration=1, heads=heads, depth=depth,
                           token_dim=(IMG // 8) ** 2, backbone="resnet18")
    checkpoint.init_weights(m, seed)
    torch.save({"state_dict": m.state_dict()}, path)
    return m


@pytest.mark.parametrize("case", ["full", "heads4", "depth2"])
def test_partial_load_matches_jax(case, tmp_path, capsys, jax_flagship):
    """A full reference file, one of another head count (the attention
    projections do not match) and one of another depth (its final
    layer's FeedForward lands where the JAX importer puts it): the same
    merged count and warning as ``_load_pth_into``, and outputs within
    1e-3 of the JAX model loaded from the same file."""
    path = str(tmp_path / "hand_net.pth")
    kw = {"full": {}, "heads4": dict(heads=4), "depth2": dict(depth=2)}
    _donor(path, **kw[case])
    jm, v, forward = jax_flagship
    tm = _port(v)
    p, b = jcheckpoint._load_pth_into(path, v["params"], v["batch_stats"])
    jout = capsys.readouterr().out
    merged = checkpoint.load_pth(tm, torch.load(path, weights_only=True),
                                 path)
    tout = capsys.readouterr().out
    assert f"merged {merged} tensors" in jout, (merged, jout)
    assert ("WARNING: only" in jout) == ("WARNING: only" in tout) == (
        case != "full"), (jout, tout)
    if case != "full":
        assert jout.split("WARNING: only ")[1].split(" ")[0] == \
            tout.split("WARNING: only ")[1].split(" ")[0]
    x = np.random.RandomState(2).randn(3, IMG, IMG, 3).astype(np.float32)
    want = np.asarray(forward(p, b, x))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_no_match_raises_in_both(tmp_path, jax_flagship):
    """A bare torchvision ResNet into the encoder (no top-level layer1):
    zero matches raise the architecture-mismatch error; an unknown layout
    raises its own."""
    _, v, _ = jax_flagship
    tm = _port(v)
    rn = tmp_path / "rn.pth"
    torch.save({"layer1.0.conv1.weight": torch.zeros(64, 64, 3, 3),
                "conv1.weight": torch.zeros(64, 3, 7, 7)}, rn)
    with pytest.raises(ValueError, match="no tensor"):
        jcheckpoint._load_pth_into(str(rn), v["params"], v["batch_stats"])
    with pytest.raises(ValueError, match="architecture mismatch"):
        checkpoint.load_weights(tm, str(rn))
    bogus = tmp_path / "bogus.pth"
    torch.save({"decoder.weight": torch.zeros(3, 3)}, bogus)
    with pytest.raises(ValueError, match="unrecognized"):
        jcheckpoint._load_pth_into(str(bogus), v["params"],
                                   v["batch_stats"])
    with pytest.raises(ValueError, match="unrecognized"):
        checkpoint.load_weights(tm, str(bogus))


def test_partial_file_evaluates_and_serves(tmp_path, capsys):
    """A partial file goes through the entry points that read
    ``--checkpoint_path_eval``: the predictor and the Evaluator print the
    warning and run on what matched (``--net ViT``, small; the card's
    files phase does it on the flagship)."""
    from scat_tpu_torch.evaluation.evaluator import Evaluator
    from scat_tpu_torch.serving import HandPosePredictor
    opt = Options(net="ViT", vit_dim=32, vit_heads=2, vit_depth=2,
                  iteration=1, compute_dtype="float32", batch_size=2,
                  result_dir=str(tmp_path / "eval"))
    donor, _ = build_model(dataclasses.replace(opt, vit_heads=4), IMG)
    checkpoint.init_weights(donor, 4)
    path = str(tmp_path / "h4.pth")
    torch.save(donor.state_dict(), path)
    opt = dataclasses.replace(opt, checkpoint_path_eval=path)
    pred = HandPosePredictor.from_checkpoint(opt, image_size=IMG,
                                             device="cpu")
    out = pred.predict(np.random.RandomState(0).randint(
        0, 256, (2, IMG, IMG, 3)).astype(np.uint8))
    assert np.isfinite(out["joints_3d"]).all()
    from torch_parallel_worker import batch
    res = Evaluator(opt, image_size=IMG, dataset=[batch(0, n=2)],
                    device="cpu").eval()
    assert np.isfinite(res["mpjpe_mm"])
    text = capsys.readouterr().out
    assert text.count("WARNING: only") == 2, text


def test_vip_file_without_projections_is_refused(tmp_path):
    from scat_tpu_torch.models.performer import ViP
    m = ViP(torch.from_numpy(assets.load_mean_params()), image_pix=IMG,
            emb_s=16, heads=2, depth=2)
    path = str(tmp_path / "vip.pth")
    torch.save({k: v for k, v in m.state_dict().items()
                if not k.endswith(".w")}, path)
    with pytest.raises(RuntimeError, match=r"mains\.0\.w"):
        checkpoint.load_weights(m, path)


# ---------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------

CONVERT = {"reg_transformer": IMG, "reg_transformer_coarse": IMG,
           "ViT": IMG, "ViP": IMG, "frankmocap": IMG,
           "backbone_hrnet": 224, "backbone_incepv3": 224}


@pytest.mark.parametrize("net", sorted(CONVERT))
def test_convert_to_pth(net, tmp_path, capsys):
    """A port train state of each ``--net`` to a bare reference-keyed
    ``.pth``: every tensor of the model, loaded through the partial
    loader (no warning)."""
    size = CONVERT[net]
    opt = Options(net=net, vit_heads=2, iteration=1, vit_dim=32,
                  compute_dtype="float32")
    model, _ = build_model(opt, size)
    src = str(tmp_path / "hand_net_final.pth")
    torch.save({"state_dict": model.state_dict(), "step": 3}, src)
    out = str(tmp_path / "bare.pth")
    n = convert.to_pth(dataclasses.replace(opt, checkpoint_path_eval=src),
                       out, image_size=size)
    sd = torch.load(out, weights_only=True)
    want = {k: v for k, v in model.state_dict().items()
            if k != checkpoint.PE_KEY}
    assert n == len(sd) == len(want) and sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    assert "WARNING" not in capsys.readouterr().out


def test_convert_refuses_what_it_cannot(tmp_path):
    opt = Options(net="reg_transformer", vit_heads=2,
                  checkpoint_path_eval=str(tmp_path / "typo.pth"))
    with pytest.raises(FileNotFoundError):
        convert.to_pth(opt, str(tmp_path / "out.pth"))
    with pytest.raises(SystemExit, match="scat-convert --direction to_orbax"):
        convert.main(["--direction", "to_orbax", "--convert_out",
                      str(tmp_path / "o")])
    with pytest.raises(ValueError, match="no torch interchange"):
        convert.state_dict_for_net("hand_net", torch.nn.Linear(1, 1))


def test_jax_to_orbax_reads_the_port_pth(tmp_path, capsys):
    """``scat-convert --direction to_orbax`` takes the port's ``.pth`` as
    it is: every tensor merges into the JAX model."""
    flags = dict(net="ViT", vit_dim=32, vit_heads=2, vit_depth=2,
                 iteration=1)
    opt = Options(compute_dtype="float32", **flags)
    model, _ = build_model(opt, IMG)
    checkpoint.init_weights(model, 6)
    src = str(tmp_path / "vit.pth")
    torch.save({"state_dict": model.state_dict()}, src)
    pth = str(tmp_path / "bare.pth")
    n = convert.to_pth(dataclasses.replace(opt, checkpoint_path_eval=src),
                       pth, image_size=IMG)
    jopt = JOptions(checkpoint_path_eval=pth, **flags)
    back = jconvert.to_orbax(jopt, str(tmp_path / "orbax"), image_size=IMG)
    assert os.path.isdir(back)
    text = capsys.readouterr().out
    assert f"merged {n} tensors" in text and "WARNING" not in text, text


# ---------------------------------------------------------------------
# validate_data
# ---------------------------------------------------------------------

def _trees(root):
    stb = os.path.join(root, "STB")
    write_stb_tree(stb, n=2)
    return {"stb": (stb, {}),
            "frei": (str(write_frei_tree(os.path.join(root, "FreiHAND"),
                                         n=4)), {}),
            "ho3d": (str(write_ho3d_tree(os.path.join(root, "HO3D"))), {}),
            "mhp": (str(write_mhp_tree(os.path.join(root, "MHP"))), {}),
            "rhd": (str(write_rhd_tree(os.path.join(root, "RHD"))), {})}


def _report(r):
    return (r.dataset, r.n_samples,
            [(f.level, f.code, f.path,
              f.message.replace("scat_tpu_torch", "scat_tpu"))
             for f in r.findings])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return _trees(str(tmp_path_factory.mktemp("trees")))


@pytest.mark.parametrize("name", ["stb", "frei", "ho3d", "mhp", "rhd"])
def test_validate_matches_jax(name, trees, tmp_path, capsys):
    """The same findings (level, code, path, message) and sample count as
    the JAX package's validator on the same tree; ``--n 2 --device cpu``
    runs the port's loader on it and writes its debug crops."""
    root, _ = trees[name]
    assert validate_data.detect_dataset(root) == \
        jvalidate.detect_dataset(root) == name
    want = jvalidate.VALIDATORS[name](root)
    got = validate_data.VALIDATORS[name](root)
    assert _report(got) == _report(want)
    rc = validate_data.main(["--data_dir", root, "--n", "2", "--device",
                             "cpu", "--out", str(tmp_path / "crops")])
    text = capsys.readouterr().out
    assert rc == jvalidate.main(["--data_dir", root]) == (
        1 if want.n_errors else 0), text
    # a tree with schema errors (the written RHD tree's projection
    # check) skips the sample run, as the JAX package's CLI does
    assert ("[validate] wrote 2 debug crops" in text) == (rc == 0), text


def test_validate_defaults_to_cuda(trees, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        validate_data.main(["--data_dir", trees["stb"][0], "--n", "1",
                            "--out", str(tmp_path)])
