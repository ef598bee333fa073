"""The ranks of ``tests/test_torch_parallel.py``: each mode of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py:53``) run by the
port over a gloo group, beside the same step at world 1 in the same
process, on the tiny flagship of ``tests/test_parallel.py:191-230``
(resnet18, 32 px crops, token dim 16, 2 heads) and a tiny ViP.

``spawn(fn, world, *args)`` starts ``world`` processes that join one
gloo group over localhost and run ``fn(rank, world, *args)``; it returns
rank 0's result and raises with the traceback of a rank that failed."""

from __future__ import annotations

import contextlib
import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

IMG, BS = 32, 8
W3D, W2D, LR = 1e5, 10.0, 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, queue):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        out = fn(rank, world, *args)
        queue.put((rank, "ok", out))
    except BaseException:
        queue.put((rank, "err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@contextlib.contextmanager
def world_1():
    """A gloo group of one process, this one, for the duration."""
    from scat_tpu_torch.parallel.mesh import release_mesh
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        release_mesh()
        dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 300.0):
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, status, out = queue.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return results[0]


# ---------------------------------------------------------------------
# the tiny models and their data
# ---------------------------------------------------------------------

def options(**kw):
    from scat_tpu_torch.config import Options
    base = dict(net="reg_transformer", batch_size=BS, lr=LR, epoch=1,
                l_weight_3d=W3D, l_weight_2d=W2D, vit_heads=2, iteration=1,
                mask_rate=0.2, synthetic_data=True, debug=False,
                steps_per_epoch=1, log_every=1, compute_dtype="float32")
    base.update(kw)
    return Options(**base)


def flagship(seed: int = 0, sd=None, pl_reg: bool = False,
             mask_rate: float = 0.2, img: int = IMG):
    """The tiny flagship for ``img`` px crops: a seeded fresh init, or the
    given state_dict."""
    from scat_tpu_torch import assets
    from scat_tpu_torch.models.hand_net import EncoderTransformer
    from scat_tpu_torch.utils import checkpoint
    m = EncoderTransformer(
        mean_params=torch.from_numpy(assets.load_mean_params()), iteration=1,
        heads=2, depth=3, backbone="resnet18", mask_rate=mask_rate,
        token_dim=(img // 8) ** 2, pl_reg=pl_reg)
    if sd is None:
        checkpoint.init_weights(m, seed)
    else:
        m.load_state_dict(sd, strict=True)
    return m


def vip(seed: int = 0, depth: int = 2):
    from scat_tpu_torch import assets
    from scat_tpu_torch.models.performer import ViP
    from scat_tpu_torch.utils import checkpoint
    m = ViP(mean_params=torch.from_numpy(assets.load_mean_params()),
            image_pix=IMG, patch_pix=4, emb_s=16, heads=2, depth=depth,
            iteration=1)
    checkpoint.init_weights(m, seed)
    return m


def batch(seed: int = 0, n: int = BS, invalid: int = 1):
    """A seeded batch: crops near the synthetic task's scale, root-centred
    3D joints about the mean template, pixel 2D joints, and ``invalid``
    rows marked invalid."""
    from scat_tpu_torch import assets
    rng = np.random.RandomState(seed)
    offsets = assets.load_mean_params()[3:66].reshape(21, 3)
    j3d = (offsets[None] + rng.randn(n, 21, 3) * 0.02).astype(np.float32)
    j3d -= j3d[:, 1:2]
    j2d = (rng.rand(n, 21, 2) * IMG * 0.8 + IMG * 0.1).astype(np.float32)
    lab = np.concatenate([j3d.reshape(n, 63), j2d.reshape(n, 42)], 1)
    valid = np.ones(n, np.float32)
    valid[n - invalid:] = 0.0
    return {"image": torch.from_numpy(
                (rng.randn(n, IMG, IMG, 3) * 0.5).astype(np.float32)),
            "label": torch.from_numpy(lab),
            "valid": torch.from_numpy(valid)}


def _state(model, opt):
    from scat_tpu_torch.training import schedule
    from scat_tpu_torch.training.state import TrainState
    o, sch = schedule.make_optimizer(model, opt.lr, opt.steps_per_epoch)
    return TrainState.create(model, o, sch, seed=opt.seed)


def _params(state) -> dict:
    from scat_tpu_torch.parallel.mesh import full_state_dict
    if state.mesh is None:
        return {k: v.detach().clone() for k, v in
                state.model.state_dict().items()}
    return full_state_dict(state.model)


def _grads(state) -> dict:
    """The gradients of the step, in the global layout."""
    from scat_tpu_torch.parallel.sharding_rules import gather_shard
    out = {}
    for name, p in state.model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad
        if hasattr(g, "full_tensor"):
            g = g.full_tensor()
        out[name] = gather_shard(state.model, name, g).detach().clone()
    return out


def _step(make_model, opt, b, mesh=None, tp_min_elems=None,
          dtype=torch.float64):
    """One train step of a fresh state in ``dtype`` on batch ``b`` (the
    global batch; sharded under ``mesh``): (stats as floats, full params,
    full gradients)."""
    from scat_tpu_torch.parallel import mesh as mesh_lib
    from scat_tpu_torch.parallel.sharding_rules import TP_MIN_ELEMS
    from scat_tpu_torch.training import steps
    from scat_tpu_torch.training.trainer import parallelize
    model = make_model().to(dtype)
    state = _state(model, opt)
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    if mesh is not None:
        parallelize(state, mesh, opt, opt.steps_per_epoch,
                    TP_MIN_ELEMS if tp_min_elems is None else tp_min_elems)
        b = mesh_lib.shard_batch(mesh, b, opt.grad_accum)
    step = steps.make_train_step(opt.l_weight_3d, opt.l_weight_2d,
                                 pl_reg=opt.pl_reg, grad_accum=opt.grad_accum,
                                 mesh=mesh)
    stats = step(state, b)
    return ({k: float(stats[k]) for k in ("loss", "loss_3d", "loss_2d",
                                           "loss_pl")}, _params(state),
            _grads(state))


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a
               if a[k].is_floating_point())


def _compare(ref, got) -> dict:
    """Loss, PL term, parameters after the step and gradients of a step
    against the world-1 one: the losses, the largest parameter
    difference, and the largest gradient difference over the largest
    gradient."""
    (s1, p1, g1), (s2, p2, g2) = ref, got
    assert sorted(p1) == sorted(p2), set(p1) ^ set(p2)
    assert sorted(g1) == sorted(g2), set(g1) ^ set(g2)
    return {"loss": (s1["loss"], s2["loss"]),
            "loss_pl": (s1["loss_pl"], s2["loss_pl"]),
            "params": _max_diff(p1, p2),
            "grads": _max_diff(g1, g2) / max(float(g.abs().max())
                                             for g in g1.values())}


# ---------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------

# mode: (model, options, mesh, tensor-parallel min_elems); the pairs of
# the tiny flagship hold < 1<<16 elements, so dp2 x tp2 splits them
# anyway (min_elems 0), that the head split runs; the ViT under FSDP is
# 64 wide, that its first to_qkv (24,576 elements) is sharded
MODES = {
    "dp": ("flagship", dict(), "data:4", None),
    "grad_accum": ("flagship", dict(grad_accum=2), "data:4", None),
    "pl_reg": ("flagship", dict(pl_reg=True), "data:4", None),
    "pl_reg_grad_accum": ("flagship", dict(pl_reg=True, grad_accum=2),
                          "data:4", None),
    "fsdp": ("flagship", dict(param_sharding="fsdp"), "data:4", None),
    "dp2_seq2_vip": ("vip", dict(net="ViP"), "data:2,seq:2", None),
    "dp2_seq2_vit": ("vit", dict(net="ViT"), "data:2,seq:2", None),
    "dp2_seq2_vit_fsdp": ("vit64", dict(net="ViT", param_sharding="fsdp"),
                          "data:2,seq:2", None),
    "dp2_tp2": ("flagship", dict(), "data:2,model:2", 0),
}


def vit(seed: int = 0, dim: int = 32):
    from scat_tpu_torch import assets
    from scat_tpu_torch.models.vit import ViT
    from scat_tpu_torch.utils import checkpoint
    m = ViT(mean_params=torch.from_numpy(assets.load_mean_params()),
            image_size=IMG, patch_size=8, dim=dim, depth=2, heads=2,
            dropout=0.1, emb_dropout=0.1, iteration=1)
    checkpoint.init_weights(m, seed)
    return m


def train_mode(name: str, refs: dict, rank: int, dtype=torch.float64):
    """One step of mode ``name`` in ``dtype`` at world 4 against the
    world-1 step on the whole batch, on rank 0 (``refs`` keeps the world-1
    steps of the modes that share one); the other ranks take part in the
    step and return None."""
    from scat_tpu_torch.parallel.mesh import make_mesh, mesh_axes
    net, kw, shape, tp_min = MODES[name]
    opt = options(mesh_shape=shape, **kw)

    def make():
        if net == "flagship":
            return flagship(pl_reg=opt.pl_reg)
        if net == "vip":
            return vip()
        return vit(dim=64) if net == "vit64" else vit()

    b = batch(1)
    key = (net, opt.pl_reg, opt.grad_accum)
    if rank == 0 and key not in refs:
        refs[key] = _step(make, opt, b, dtype=dtype)
    mesh = make_mesh(mesh_axes(opt), device_type="cpu")
    got = _step(make, opt, b, mesh, tp_min, dtype=dtype)
    return _compare(refs[key], got) if rank == 0 else None


def pipe_mode() -> dict:
    """dp2 x pipe2 over ViP's PerformerBlocks (GPipe, 2 microbatches):
    one Adam step of mean(y^2), as the JAX dry run's, against the blocks
    in sequence over the whole batch (float64)."""
    from scat_tpu_torch.models.performer import PerformerBlock
    from scat_tpu_torch.parallel import pipeline
    from scat_tpu_torch.parallel.mesh import (DATA_AXIS, average_gradients,
                                              make_mesh, shard_rows)

    def blocks():
        torch.manual_seed(7)
        return torch.nn.ModuleList([PerformerBlock(16, 2, 0.5, 0.1)
                                    for _ in range(2)]).double()

    tok = torch.from_numpy(np.random.RandomState(5).randn(BS, 17, 32))
    ref = blocks()
    y_ref = tok
    for blk in ref:
        y_ref = blk(y_ref)
    loss_ref = (y_ref ** 2).mean()
    loss_ref.backward()
    torch.optim.Adam(ref.parameters(), lr=LR).step()

    mesh = make_mesh((("data", 2), ("pipe", 2)), device_type="cpu")
    d = mesh.coord(DATA_AXIS)
    mine = blocks()
    y = pipeline.pipeline_apply(lambda blk, t: blk(t), mine,
                                shard_rows(tok, d, 2), mesh, 2)
    loss = (y ** 2).sum() / y_ref.numel()   # this data rank's share
    loss.backward()
    params = [p for blk in pipeline.stage_blocks(mine, mesh)
              for p in blk.parameters()]
    for p in params:       # DDP's convention: shares times the data size
        p.grad.mul_(2)
    average_gradients([p.grad for p in params], mesh.data_group)
    torch.optim.Adam(params, lr=LR).step()
    total = loss.detach().clone()
    dist.all_reduce(total, group=mesh.data_group)
    want = dict(ref.named_parameters())
    got = {n: p for n, p in mine.named_parameters()
           if any(p is q for q in params)}
    return {"loss": (float(loss_ref.detach()), float(total)),
            "params": max(float((got[n] - want[n]).abs().max())
                          for n in got),
            "y": float((y - shard_rows(y_ref, d, 2)).abs().max()),
            "staged": len(got)}


def jax_dp(sd: dict, b: dict) -> dict:
    """The world-4 dp step, float32, from a given state_dict (a flax init
    carried by ``state_dict_from_flax``) on a given batch: its loss and
    two of its updated weights."""
    from scat_tpu_torch.parallel.mesh import make_mesh, mesh_axes
    opt = options(mesh_shape="data:4", mask_rate=0.0)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    stats, params, _ = _step(lambda: flagship(sd=sd, mask_rate=0.0), opt, b,
                             make_mesh(mesh_axes(opt), device_type="cpu"),
                             dtype=torch.float32)
    return {"loss": stats["loss"],
            **{k: params[k].numpy() for k in ("regressor.weight",
                                              "main_encoder.conv1.weight")}}


def trainer_run(folder: str) -> dict:
    """``Trainer(...).train()`` on a data:2 x model:2 mesh, 2 steps of
    the synthetic task: its checkpoint, gathered and written by process
    0, loads into an unsplit model and equals the trained one."""
    from scat_tpu_torch.models import build_model
    from scat_tpu_torch.parallel.mesh import full_state_dict
    from scat_tpu_torch.training.trainer import Trainer
    from scat_tpu_torch.utils import checkpoint
    opt = options(mesh_shape="data:2,model:2", steps_per_epoch=2,
                  checkpoint_folder=folder)
    trainer = Trainer(opt, device="cpu", image_size=IMG)
    trainer.train()
    full = full_state_dict(trainer.model)
    dist.barrier()
    fresh, _ = build_model(opt, IMG)
    checkpoint.load_weights(fresh, os.path.join(folder, checkpoint.FINAL_NAME))
    loaded = fresh.state_dict()
    return {"step": trainer.state.step,
            "params": max(float((loaded[k].float() - full[k].float())
                                .abs().max()) for k in full),
            "files": sorted(os.listdir(folder))}


def all_modes(rank, world, sd, b, folder, eval_args, stb_args):
    """Every mode at world 4, the Evaluator over two ``data`` ranks on
    injected batches and through the STB loader, and the loaders' split
    (rank 0's numbers)."""
    import time
    refs, out, seconds = {}, {}, {}
    for name in MODES:
        t0 = time.perf_counter()
        out[name] = train_mode(name, refs, rank)
        seconds[name] = time.perf_counter() - t0
    for name, fn, args in (("dp2_pipe2_vip", pipe_mode, ()),
                           ("jax_dp", jax_dp, (sd, b)),
                           ("trainer", trainer_run, (folder,)),
                           ("evaluator", eval_ranks,
                            (rank, world) + eval_args),
                           ("eval_stb", eval_stb, stb_args),
                           ("loader_split", loader_split, (rank,))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def tiny_build_model(opt, image_size=224, for_keypoints=False):
    """``models.build_model``'s signature, the tiny flagship's weights."""
    from scat_tpu_torch import assets
    return flagship(img=image_size), assets.load_mean_params()


def eval_stb(sd, opt_kw):
    """The Evaluator through the STB eval loader on the mesh of
    ``opt_kw``: each data rank reads and decodes its frames alone."""
    from scat_tpu_torch.config import Options
    from scat_tpu_torch.evaluation import evaluator
    from scat_tpu_torch.evaluation.evaluator import Evaluator
    evaluator.build_model = tiny_build_model
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    res = Evaluator(Options(**opt_kw), image_size=224, state_dict=sd,
                    device="cpu").eval("STB")
    return {"mpjpe_mm": res["mpjpe_mm"], "auc": res["auc"],
            "pck": np.asarray(res["pck"])}


def loader_split(rank):
    """The loaders' topology on a data:2 x model:2 mesh: the data
    coordinate and size; batch j of each data rank's epoch order (8
    samples, batch 4: 2 rows a rank) and the other ranks' rows, gathered
    over the whole group in rank order."""
    from scat_tpu_torch.data import common
    from scat_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((("data", 2), ("model", 2)), device_type="cpu")
    lbs = common.local_batch_size(4)
    order = common.host_shard(np.arange(8))
    rows = torch.from_numpy(order.reshape(-1, lbs)).contiguous()
    parts = [torch.empty_like(rows) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, rows)
    return {"topology": common._process_topology(), "lbs": lbs,
            "batches": common.num_batches(8, lbs),
            "coords": [mesh.coords(r) for r in range(4)],
            "rows": [p.tolist() for p in parts]}


def eval_ranks(rank, world, sd, batches, opt_kw):
    """The Evaluator on the mesh of ``opt_kw`` (data:2,model:2: two data
    ranks, each run twice), injected batches and weights, on the tiny
    flagship."""
    from scat_tpu_torch.config import Options
    from scat_tpu_torch.evaluation import evaluator
    from scat_tpu_torch.evaluation.evaluator import Evaluator
    evaluator.build_model = tiny_build_model
    batches = [{k: torch.from_numpy(v) for k, v in bt.items()}
               for bt in batches]
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    res = Evaluator(Options(**opt_kw), image_size=IMG, dataset=batches,
                    state_dict=sd, device="cpu").eval()
    return {"mpjpe_mm": res["mpjpe_mm"], "auc": res["auc"],
            "pck": np.asarray(res["pck"])}


def float32_gaps(rank, world):
    """Every mode's world-4 step against world 1 in float32 (the tests
    hold them in float64)."""
    refs = {}
    return {name: train_mode(name, refs, rank, torch.float32)
            for name in MODES}


if __name__ == "__main__":
    # python tests/torch_parallel_worker.py: the float32 gaps of every
    # mode, as JSON (4 gloo ranks on the CPU, about a minute)
    import json
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(json.dumps(spawn(float32_gaps, 4), indent=1))
