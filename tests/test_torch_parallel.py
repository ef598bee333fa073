"""The port's ``parallel/`` over gloo on the CPU: the modes of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py:53``;
``MULTICHIP_r05.json``) at world 4 against the world-1 step on the whole
batch, the world-4 dp step against JAX's single-device
``steps.make_train_step``, the Trainer over a data x model mesh, a
2-rank Evaluator and a 2-replica ``mesh=`` predictor.

One ``torch.multiprocessing`` spawn of 4 ranks runs every mode
(``tests/torch_parallel_worker.py``).  The equivalences run in float64:
Adam's first step moves a weight by lr * sign(g), so float32 round-off
flips the update of a weight whose gradient is round-off sized (1.3e-4
on the flagship's parameters), and under dp2 x tp2 the tiny model's
gradients move by 4% of the largest (``python
tests/torch_parallel_worker.py`` prints every mode's float32 gaps);
float64 makes the check one of the distributed math.  The JAX case runs
in float32 at the bar of the single-process port-vs-JAX step
(``tests/test_torch_train.py``)."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from scat_tpu import assets as jassets
from scat_tpu.models.hand_net import EncoderTransformer as JEncoder
from scat_tpu.training import schedule as jschedule
from scat_tpu.training import steps as jsteps
from scat_tpu.training.state import TrainState as JState
from scat_tpu_torch.config import Options
from scat_tpu_torch.evaluation.evaluator import Evaluator
from scat_tpu_torch.parallel import mesh as mesh_lib
from scat_tpu_torch.parallel import pipeline, sharding_rules
from scat_tpu_torch.serving import HandPosePredictor, bucket_ladder
from scat_tpu_torch.utils.weights import state_dict_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as worker  # noqa: E402
from stb_tree import EVAL_SEQS, write_stb_tree  # noqa: E402

TOL = 1e-5
ALL = tuple(worker.MODES) + ("dp2_pipe2_vip",)


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def jax_case():
    """(flax init as a port state_dict, batch, JAX step's stats and
    params) of the tiny flagship without token masking."""
    jm = JEncoder(mean_params=jnp.asarray(jassets.load_mean_params()),
                  iteration=1, heads=2, depth=3, backbone="resnet18",
                  mask_rate=0.0, token_dim=(worker.IMG // 8) ** 2,
                  use_pallas=False)
    b = {k: v.numpy() for k, v in worker.batch(3).items()}
    v = jax.jit(lambda x: jm.init(
        {"params": jax.random.key(0), "mask": jax.random.key(1)}, x,
        train=False))(b["image"][:1])
    params, bs = _unfreeze(v["params"]), _unfreeze(v["batch_stats"])
    sd = {k: t.numpy() for k, t in state_dict_from_flax(params, bs).items()}
    tx = jschedule.make_optimizer(worker.LR, steps_per_epoch=1)
    state = JState.create(params, bs, tx, jax.random.key(1))
    state, stats = jax.jit(jsteps.make_train_step(
        jm, tx, worker.W3D, worker.W2D))(
        state, {k: jnp.asarray(x) for k, x in b.items()})
    return sd, b, float(stats["loss"]), state.params


def _eval_opts(tmp_path, **kw):
    base = dict(net="reg_transformer", batch_size=6, vit_heads=2,
                iteration=1, compute_dtype="float32", seed=0,
                result_dir=str(tmp_path), debug=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def eval_case():
    """(the tiny flagship's weights, a batch of 6 and one of 5) for the
    Evaluator, as numpy."""
    sd = {k: v.numpy() for k, v in worker.flagship(3).state_dict().items()}
    batches = []
    for seed, n in ((4, 6), (5, 5)):
        b = worker.batch(seed, n=n)
        batches.append({k: v.numpy() for k, v in b.items()})
    return sd, batches


@pytest.fixture(scope="module")
def stb_case(tmp_path_factory):
    """(the tiny flagship's weights at 224 px, an STB tree of the two eval
    sequences' first two frames) for the Evaluator through its loader."""
    sd = {k: v.numpy() for k, v in
          worker.flagship(3, img=224).state_dict().items()}
    return sd, write_stb_tree(tmp_path_factory.mktemp("stb_tree"),
                              EVAL_SEQS, n=2)


def _stb_opts(tmp_path, data_dir, mesh_shape="data:-1"):
    return _eval_opts(tmp_path, data_dir=data_dir, synthetic_data=False,
                      batch_size=4, mesh_shape=mesh_shape)


@pytest.fixture(scope="module")
def results(jax_case, eval_case, stb_case, tmp_path_factory):
    sd, b, _, _ = jax_case
    folder = str(tmp_path_factory.mktemp("trainer"))
    eval_args = eval_case + (_eval_opts(
        tmp_path_factory.mktemp("eval"), mesh_shape="data:2,model:2"),)
    stb_args = (stb_case[0], _stb_opts(tmp_path_factory.mktemp("stb"),
                                      stb_case[1], "data:2,model:2"))
    return worker.spawn(worker.all_modes, 4, sd, b, folder, eval_args,
                        stb_args)


@pytest.mark.parametrize("mode", ALL)
def test_mode_matches_world_1(results, mode):
    """Loss (and PL term) within 1e-5 relative, parameters after the step
    within 1e-5, gradients within 1e-5 of the largest."""
    r = results[mode]
    want, got = r["loss"]
    assert abs(got - want) <= TOL * abs(want), (mode, r)
    if "loss_pl" in r:
        want, got = r["loss_pl"]
        assert abs(got - want) <= TOL * max(abs(want), 1.0), (mode, r)
    assert r["params"] <= TOL, (mode, r)
    if "grads" in r:
        assert r["grads"] <= TOL, (mode, r)
    if mode == "dp2_pipe2_vip":
        assert r["y"] <= TOL and r["staged"] == 12, r


def test_pl_reg_runs_its_term(results):
    assert results["pl_reg"]["loss_pl"][0] > 0


def test_dp_step_matches_jax(results, jax_case):
    """The world-4 dp step, float32, against JAX's single-device step from
    the same flax init: the loss within 1e-3, the updated regressor and
    stem within 1e-3 (the bar of test_torch_train's first step)."""
    _, _, jloss, jparams = jax_case
    got = results["jax_dp"]
    assert abs(got["loss"] - jloss) <= 1e-3 * abs(jloss), (got["loss"],
                                                           jloss)
    np.testing.assert_allclose(got["regressor.weight"],
                               np.asarray(jparams["regressor"]["kernel"]).T,
                               atol=1e-3)
    np.testing.assert_allclose(
        got["main_encoder.conv1.weight"],
        np.asarray(jparams["main_encoder"]["conv1"]["kernel"]).transpose(
            3, 2, 0, 1), atol=1e-3)


def test_trainer_over_a_data_model_mesh(results):
    """The Trainer at data:2 x model:2 takes its steps; process 0 writes
    the checkpoints and the CSV, gathered to the global layout, which
    load into an unsplit model as the trained one."""
    r = results["trainer"]
    assert r["step"] == 2
    assert r["files"] == ["hand_net.pth", "hand_net_final.pth",
                          "metrics.csv"]
    assert r["params"] == 0.0


def test_two_rank_evaluator_equals_world_1(results, eval_case, tmp_path,
                                          monkeypatch):
    """Each of two data ranks evaluates its rows (the mesh data:2,model:2
    of the 4-rank group: the Evaluator runs the model axis replicated);
    the aligned joints are gathered and the metrics are those of the
    global batch (a batch of 6 and one of 5, padded to 6 with invalid
    rows); the tiny flagship on both sides."""
    from scat_tpu_torch.evaluation import evaluator
    monkeypatch.setattr(evaluator, "build_model", worker.tiny_build_model)
    sd, batches = eval_case
    want = Evaluator(Options(**_eval_opts(tmp_path / "one")),
                     image_size=worker.IMG,
                     dataset=[{k: torch.from_numpy(v) for k, v in b.items()}
                              for b in batches],
                     state_dict={k: torch.from_numpy(v)
                                 for k, v in sd.items()},
                     device="cpu").eval()
    got = results["evaluator"]
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-5)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-5)
    np.testing.assert_allclose(got["pck"], want["pck"], atol=1e-6)


def test_two_rank_stb_loader_evaluator_equals_world_1(results, stb_case,
                                                     tmp_path, monkeypatch):
    """Through the STB eval loader each of two data ranks reads and
    decodes only its frames (2 of the 4: one batch of 2 rows a rank); the
    gathered rows give the world-1 numbers."""
    from scat_tpu_torch.evaluation import evaluator
    monkeypatch.setattr(evaluator, "build_model", worker.tiny_build_model)
    sd, data_dir = stb_case
    want = Evaluator(Options(**_stb_opts(tmp_path, data_dir)),
                     image_size=224,
                     state_dict={k: torch.from_numpy(v)
                                 for k, v in sd.items()},
                     device="cpu").eval("STB")
    got = results["eval_stb"]
    np.testing.assert_allclose(got["mpjpe_mm"], want["mpjpe_mm"], rtol=1e-5)
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-5)
    np.testing.assert_allclose(got["pck"], want["pck"], atol=1e-6)


def test_loaders_split_over_the_data_axis(results):
    """Under a mesh the loaders' topology is the ``data`` coordinate and
    size: each data rank reads 2 of batch j's 4 rows, the model peers the
    same ones, and the data ranks' rows together are the world-1 batch."""
    r = results["loader_split"]
    assert r["topology"] == (0, 2) and r["lbs"] == 2 and r["batches"] == 2
    by_data = {}
    for coords, rows in zip(r["coords"], r["rows"]):
        by_data.setdefault(coords["data"], []).append(rows)
    assert all(peers[0] == peers[1] for peers in by_data.values())
    for j in range(2):
        got = sorted(by_data[0][0][j] + by_data[1][0][j])
        assert got == list(range(4 * j, 4 * j + 4)), (j, r["rows"])


def test_two_replica_predictor_equals_one(tmp_path):
    """``mesh=`` over two CPU devices: one replica a device, buckets from
    the data-axis size, each padded bucket split across the replicas."""
    one = HandPosePredictor(model=worker.flagship(), image_size=worker.IMG,
                            device="cpu")
    mesh = mesh_lib.make_mesh((("data", 2),), devices=["cpu", "cpu"])
    two = HandPosePredictor(model=worker.flagship(), image_size=worker.IMG,
                            device="cpu", mesh=mesh)
    assert two._buckets == bucket_ladder(64, 2) == [2, 4, 8, 16, 32, 64]
    assert len(two._replicas) == 2
    crops = np.random.RandomState(0).randint(
        0, 256, (5, worker.IMG, worker.IMG, 3)).astype(np.uint8)
    got = two.predict(crops)
    # 5 crops pad to the bucket of 8, 4 rows a replica: the one-device
    # predictor on each half (bucket 4 each) gives the same numbers
    padded = np.concatenate([crops, np.zeros((3,) + crops.shape[1:],
                                             np.uint8)])
    halves = [one.predict(padded[:4]), one.predict(padded[4:])]
    for k in ("camera", "joints_3d", "joints_2d"):
        want = np.concatenate([h[k] for h in halves])[:5]
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_serving_mesh_is_a_device_mesh():
    with pytest.raises(ValueError, match="one-process"):
        HandPosePredictor(model=worker.flagship(), image_size=worker.IMG,
                          device="cpu",
                          mesh=mesh_lib.Mesh(("data",), (1,),
                                             [torch.device("cpu")], rank=0))


def test_make_mesh_without_a_group():
    """No process group: a mesh of one device is no mesh; a larger one
    names torchrun."""
    assert mesh_lib.make_mesh((("data", 1),), device_type="cpu") is None
    assert mesh_lib.make_mesh((("data", -1),), device_type="cpu") is None
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.make_mesh((("data", 4),), device_type="cpu")
    with pytest.raises(ValueError, match="axes"):
        mesh_lib.make_mesh((("rows", 1),), devices=["cpu"])


def test_shard_rows_within_microbatches():
    """Rank d of D takes its share of each of the A global microbatches."""
    x = torch.arange(8)
    assert mesh_lib.shard_rows(x, 1, 4).tolist() == [2, 3]
    assert mesh_lib.shard_rows(x, 1, 4, grad_accum=2).tolist() == [1, 5]
    padded = mesh_lib.pad_batch_to_multiple(
        {"image": worker.batch(0, n=3)["image"],
         "label": torch.zeros(3, 105)}, 4)
    assert padded["image"].shape[0] == 4
    assert padded["valid"].tolist() == [1.0, 1.0, 1.0, 0.0]


def test_fsdp_small_leaf_rule():
    """A leaf under 1<<14 elements, or with no dimension the data size
    divides, stays replicated; else the largest dividing dimension."""
    assert mesh_lib.fsdp_placement(torch.zeros(64, 64), 4) is None
    assert mesh_lib.fsdp_placement(torch.zeros(256, 1024), 4) == 1
    assert mesh_lib.fsdp_placement(torch.zeros(1024, 130), 4) == 0
    assert mesh_lib.fsdp_placement(torch.zeros(129, 127), 2) is None


def test_head_rows_split_q_k_v_by_head():
    """A tensor-parallel rank holds the Q, K and V rows of its heads, not
    a contiguous slice of to_qkv's output."""
    rows = sharding_rules._head_rows(heads=4, dim_head=2, rank=1, size=2)
    assert rows.tolist() == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]


def test_pipeline_refuses_dim_changing_stacks():
    from scat_tpu_torch.models.transformer import PyramidTransformer
    pyramid = PyramidTransformer(dim=16, depth=2, heads=2, dim_head=4)
    with pytest.raises(ValueError, match="homogeneous"):
        pipeline.stack_layer_vars([pyramid.layers[0], pyramid.layers[1]])


def test_sequence_split_token_ranges():
    sp = sharding_rules.SeqParallel(None, 1, 2)
    assert sp.token_range(65) == slice(33, 65)
    assert sp.sizes(65) == [33, 32]


def test_world_1_group_helpers():
    """In a gloo group of one: the barrier returns, a one-axis mesh has
    every group, rows gather to themselves, and a mesh of size 1 over a
    group runs its collectives."""
    with worker.world_1():
        mesh_lib.wait_for_all_processes("test", timeout_ms=60_000)
        mesh = mesh_lib.make_mesh((("data", -1), ("seq", 1)),
                                  device_type="cpu")
        assert mesh.shape == {"data": 1, "seq": 1} and mesh.rank == 0
        assert mesh_lib.active_mesh() is mesh
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(mesh_lib.gather_rows(mesh.data_group, x), x)
        assert mesh.loss_scale() == 1.0
        assert mesh.replica_axes == ("data", "seq")
    assert mesh_lib.active_mesh() is None


def test_seq_helpers_without_an_axis():
    """Without a ``seq`` axis the token anchors are identities, as the
    JAX package's are without a live mesh axis."""
    assert sharding_rules.seq_parallel(None) is None
    assert sharding_rules.seq_axis_size(None) == 1
    x = torch.randn(2, 5, 3)
    assert sharding_rules.shard_tokens(x, None) is x
    torch.testing.assert_close(sharding_rules.token_mean(x, None, 5),
                               x.mean(dim=1))
    sp = sharding_rules.SeqParallel(None, 0, 2, total=5)
    assert sharding_rules.shard_tokens(x, sp).shape == (2, 3, 3)
