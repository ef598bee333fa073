"""The ``hrnet`` configuration (``--net backbone_hrnet`` served through
its MANO decode) at a small cut of its own (64-px crops, 2 heads,
float32 compute): the reference holds the port's served path, plain and
kernel-routed (the CPU takes the kernel op's plain version), a sound run
of ``hrnet-serve`` comes out correct and the ``altered`` fault does not;
and ``metrics/hrnet_flops.py``'s FLOPs a crop at 224 px are pinned
against the port's module.  The benchmark runs from the checkout's root,
where the port reads its default ``--mean_mano_param``; so do these
tests."""

import copy
import os

import pytest
import torch

from harness import bench, env, port, runner, seeded

SMALL = {"image_size": 64,
         "options": {"vit_heads": 2, "compute_dtype": "float32"},
         "model": {"heads": 2, "token_dim": 16}}
SMALL_TRAFFIC = {"sizes": [3, 9], "size_bins": 8, "pool": 16,
                 "check_requests": 3, "trace_requests": 2}
SEED = 2**31 + 7


def small_cell() -> bench.Cell:
    cell = bench.load_cell("hrnet-serve")
    cell.config = copy.deepcopy(cell.config)
    cell.config["image_size"] = SMALL["image_size"]
    for part in ("options", "model"):
        cell.config[part].update(SMALL[part])
    cell.traffic = dict(cell.traffic, **SMALL_TRAFFIC)
    return cell


def flops_module():
    return bench.load_module(os.path.join(env.BENCH_DIR, "metrics",
                                          "hrnet_flops.py"))


@pytest.fixture(autouse=True)
def _at_the_root(monkeypatch):
    monkeypatch.chdir(env.ROOT)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_reference_holds_the_ports_served_path(kernel):
    """The bare head and its decode (``factory.keypoint_decode``) on 4
    crops in eval mode against the reference on the same state_dict:
    camera and joints within 1e-4 of their largest magnitude."""
    from reference import common
    from scat_tpu_torch.models.factory import keypoint_decode
    cell = small_cell()
    cell.config["options"]["use_pallas_attention"] = kernel
    model = port.build(cell.config, 0, "cpu")
    weights = seeded.weights(seeded.shapes_of(model.state_dict()),
                             cell.config["init"], 5, "cpu")
    model.load_state_dict(weights, strict=True)
    model.eval()
    images = seeded.images(torch.Generator().manual_seed(3), 4,
                           cell.config["image_size"])
    with torch.no_grad():
        params = model(images.permute(0, 3, 1, 2))
        got = keypoint_decode(model)(params)
        want = port.reference(cell.config).forward(
            weights, images, cell.config["model"], False, None, common.F32,
            common.mean_template("cpu"))
    assert params.shape == (4, 61) and got.shape == want.shape == (4, 66)
    for part in (slice(0, 3), slice(3, 66)):
        scale = want[:, part].abs().max().item()
        torch.testing.assert_close(got[:, part], want[:, part], rtol=0,
                                   atol=1e-4 * scale)


def test_a_sound_run_is_correct():
    line = runner.run_cell(small_cell(), SEED, 0.3, True, "cpu")
    assert line["correct"], line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "mfu.serve.hrnet" in line["metrics"]


def test_the_altered_fault_is_not_correct():
    # a second's window: HRNet on the CPU serves a request in about 0.2 s,
    # and the fault shows across the several requests compared
    line = runner.run_cell(small_cell(), SEED, 1.0, False, "cpu", "altered")
    assert not line["correct"], line["check"]


def test_flops_a_crop_are_the_ports_module():
    """At 224 px: the convolutions' and Linears' multiply-adds counted by
    hooks on the port's module (one crop on the CPU, every call of the
    refinement's Linear), the attention's two products a layer from its
    input's shape, and the MANO decode's count from the decode's arrays,
    twice, give ``forward_flops``."""
    from scat_tpu_torch.models.mano import ManoDecode
    from scat_tpu_torch.models.transformer import Attention
    config = copy.deepcopy(bench.load_cell("hrnet-serve").config)
    # float32 and the plain attention: neither changes the count
    config["options"].update(use_pallas_attention=False,
                             compute_dtype="float32")
    model = port.build(config, 0, "cpu").eval()
    counted = []

    def hook(module, inputs, out):
        rows = out.numel() // out.shape[1 if out.dim() == 4 else -1]
        if isinstance(module, torch.nn.Conv2d):
            k = module.weight[0].numel()
            counted.append(rows * module.out_channels * k)
        elif isinstance(module, torch.nn.Linear):
            counted.append(rows * module.in_features * module.out_features)
        else:   # the attention's q k^T and p v
            b, n, _ = inputs[0].shape
            counted.append(2 * b * n * n * module.heads * module.dim_head)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, Attention)):
            m.register_forward_hook(hook)
    size = config["image_size"]
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size))
    flops = flops_module()
    mano = ManoDecode()
    verts, joints = mano.weights.shape
    assert flops.mano_macs() == (
        mano.shapedirs_flat.numel() + mano.J_regressor.numel() * 3
        + mano.posedirs_flat.numel() + (joints - 1) * (27 + 9) + joints * 9
        + verts * joints * 12 + verts * 12 + (21 + verts) * 9)
    assert flops.forward_flops(config) == 2.0 * (sum(counted)
                                                 + flops.mano_macs())
    assert flops.forward_flops(config) == 10_349_958_578.0
