"""Device mesh and data parallelism (port of ``scat_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets
GSPMD place the collectives.  Here every device is a process of a
``torch.distributed`` group (``torchrun``: NCCL on CUDA, gloo on the
CPU), and ``--mesh_shape`` (``data:2,seq:2``...) lays the processes out
row-major over the named axes, as ``init_device_mesh`` does:

  * ``data``: each rank takes its rows of the global batch
    (``shard_batch``; a real dataset's loaders read only those,
    ``data/common``); the replicas are ``DistributedDataParallel``
    (``replicate_state``) or FSDP2 ``fully_shard`` (``fsdp_state``,
    ``--param_sharding fsdp``), and BatchNorm reduces its statistics over
    the axis (``models/resnet.BatchNorm2d``), so the step is that of the
    global batch, as GSPMD's is;
  * ``model``: Megatron tensor parallelism of the transformer's pairs
    (``sharding_rules.shard_transformer``);
  * ``seq``: the token stream of ViP and ViT split over the axis
    (``sharding_rules``);
  * ``pipe``: the GPipe schedule of ``pipeline.pipeline_apply``; the
    train step replicates over it, as the JAX package's does.

Every loss term is a share of its global-batch value: a rank's terms
are multiplied by the ``data`` size, as DDP and FSDP average the
gradients over the ranks they span (``loss_scale``).  A mesh of one
device in a single process is no mesh (``make_mesh`` returns None) and
nothing changes; a mesh of one process in a group (``data:1`` under
``torchrun --nproc_per_node 1``) runs every collective, over one rank.

``make_mesh(..., devices=[...])`` lays out the devices of ONE process
instead (``serving.HandPosePredictor(mesh=)``: one replica a device of
the ``data`` axis); it has no groups.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"      # sequence parallelism (the token axis)
PIPE_AXIS = "pipe"    # pipeline parallelism over transformer depth
AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS)
# the small-leaf rule of sharding_rules.fsdp_partition_spec (JAX :146-166)
FSDP_MIN_ELEMS = 1 << 14


def mesh_axes(opt) -> Tuple[Tuple[str, int], ...]:
    """``--mesh_shape`` as ((name, size), ...), -1 = the rest."""
    axes = []
    for part in opt.mesh_shape.split(","):
        name, _, n = part.partition(":")
        axes.append((name.strip(), int(n) if n else -1))
    return tuple(axes)


@dataclasses.dataclass
class Mesh:
    """Named axes over the ranks of a process group (``rank``: this
    process's flat position; its device is ``rank_device``), or over the
    ``devices`` of one process (``rank`` None)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[List[torch.device]] = None
    rank: Optional[int] = None
    device_mesh: object = None
    _replica_group: object = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The axis coordinates of ``rank`` (default: this process)."""
        rank = self.rank if rank is None else rank
        idx = np.unravel_index(rank, self.sizes)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def coord(self, axis: str) -> int:
        return self.coords().get(axis, 0) if self.rank is not None else 0

    def group_ranks(self, axes: Iterable[str],
                    rank: Optional[int] = None) -> List[int]:
        """The ranks that share the coordinates of ``rank`` (default:
        this process) on every axis but ``axes``, in flat order."""
        axes = tuple(axes)
        mine = self.coords(rank)
        return [r for r in range(int(np.prod(self.sizes)))
                if all(c == mine[a] for a, c in self.coords(r).items()
                       if a not in axes)]

    def group(self, axis: str):
        """The process group along ``axis`` (the device mesh's), None
        where the mesh has no such axis."""
        if axis not in self.axis_names:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def data_group(self):
        return self.group(DATA_AXIS)

    @property
    def replica_axes(self) -> Tuple[str, ...]:
        """Every axis but ``model``: the ranks whose parameters are the
        same tensors."""
        return tuple(a for a in self.axis_names if a != MODEL_AXIS)

    @property
    def replica_group(self):
        """The group over ``replica_axes`` on which DDP and FSDP reduce
        the gradients: a group of its own, apart from the ``data`` axis's
        that the forward's collectives (the BatchNorm statistics, the
        loss counts) use, so that DDP's asynchronous bucket reductions
        never share a queue with them."""
        return self._replica_group

    def new_group(self, axes: Sequence[str]):
        """A new process group over ``axes``: every rank creates the
        groups of every coordinate in one order (a collective of the
        default group) and gets its own."""
        groups = {}
        for r in range(int(np.prod(self.sizes))):
            ranks = tuple(self.group_ranks(axes, r))
            if ranks not in groups:
                groups[ranks] = dist.new_group(list(ranks))
        return groups[tuple(self.group_ranks(axes))]

    def loss_scale(self) -> float:
        """The factor of a rank's loss terms: the ``data`` size (see the
        module docstring; ``seq`` ranks' copies of the loss add up
        through the sequence-parallel collectives' backward)."""
        return float(self.size(DATA_AXIS))


_ACTIVE: List[Optional[Mesh]] = [None]


def active_mesh() -> Optional[Mesh]:
    """The process mesh ``make_mesh`` built last (None without one): the
    data loaders read each ``data`` rank's share under it
    (``data/common``)."""
    return _ACTIVE[0]


def maybe_initialize_distributed(device_type: Optional[str] = None) -> bool:
    """Initialise the default process group from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``) when
    there is one and no group yet: NCCL on CUDA, gloo on the CPU.
    Returns whether a group exists."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method="env://")
    return True


def rank_device(device_type: str) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` on CUDA."""
    if device_type == "cuda":
        return torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", torch.cuda.current_device())))
    return torch.device(device_type)


def _resolve(mesh_shape, n: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    if mesh_shape is None:
        mesh_shape = ((DATA_AXIS, -1),)
    names = tuple(name for name, _ in mesh_shape)
    bad = [a for a in names if a not in AXES]
    if bad:
        raise ValueError(f"--mesh_shape axes {bad}: expected "
                         f"{'/'.join(AXES)}")
    sizes = [size for _, size in mesh_shape]
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    known = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if len(unknown) > 1:
        raise ValueError("at most one -1 axis in --mesh_shape")
    if unknown:
        sizes[unknown[0]] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {list(zip(names, sizes))} != {n} devices")
    return names, tuple(sizes)


def make_mesh(mesh_shape: Optional[Sequence[Tuple[str, int]]] = None,
              devices: Optional[Sequence] = None,
              device_type: Optional[str] = None) -> Optional[Mesh]:
    """The mesh of ``mesh_shape`` (default: every device on ``data``; a
    ``-1`` size absorbs the rest).

    With ``devices``: a one-process mesh over them.  Otherwise the mesh
    spans the processes of the default group (initialised from
    ``torchrun``'s environment if need be): a
    ``torch.distributed.device_mesh.init_device_mesh`` of the axes, plus
    a group for every set of axes the port reduces over.  With no group,
    a mesh of size 1 is None (a single process: nothing changes) and a
    larger one raises."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        names, sizes = _resolve(mesh_shape, len(devices))
        return Mesh(names, sizes, devices)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not maybe_initialize_distributed(device_type):
        names, sizes = _resolve(mesh_shape, 1) if all(
            s in (1, -1) for _, s in (mesh_shape or ())) else (None, None)
        if names is None:
            raise RuntimeError(
                f"--mesh_shape {mesh_shape} spans several devices: run one "
                "process a device, e.g. `torchrun --nproc_per_node N -m "
                "scat_tpu_torch.train --mesh_shape ...`")
        _ACTIVE[0] = None
        return None
    names, sizes = _resolve(mesh_shape, dist.get_world_size())
    from torch.distributed.device_mesh import init_device_mesh
    device_mesh = init_device_mesh(device_type, sizes,
                                   mesh_dim_names=names)
    mesh = Mesh(names, sizes, None, dist.get_rank(), device_mesh)
    mesh._replica_group = mesh.new_group(mesh.replica_axes)
    _ACTIVE[0] = mesh
    return mesh


def release_mesh() -> None:
    """Forget the active mesh (its groups stay with the default group)."""
    _ACTIVE[0] = None


# ---------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------

def pad_batch_to_multiple(batch: Dict[str, torch.Tensor], multiple: int
                          ) -> Dict[str, torch.Tensor]:
    """Pad the leading axis of every tensor to a multiple of ``multiple``
    with zeros, marking the pad rows invalid in ``valid`` (the JAX
    package's static-shape counterpart of dynamic batch slicing)."""
    n = next(iter(batch.values())).shape[0]
    rem = n % multiple
    if rem == 0:
        return batch
    pad = multiple - rem
    out = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
           for k, v in batch.items()}
    valid = batch.get("valid")
    if valid is None:
        from scat_tpu_torch.ops.metrics import valid_sample_mask
        valid = valid_sample_mask(batch["image"]).float()
    out["valid"] = torch.cat([valid.float(), valid.new_zeros(pad).float()])
    return out


def shard_rows(x: torch.Tensor, index: int, count: int,
               grad_accum: int = 1) -> torch.Tensor:
    """Rows ``index`` of ``count`` of a global [B, ...] tensor, taken
    within each of the ``grad_accum`` microbatches, so that microbatch i
    of this rank is its share of the global microbatch i."""
    b = x.shape[0]
    m = b // (grad_accum * count)
    return x.reshape((grad_accum, count, m) + tuple(x.shape[1:]))[
        :, index].reshape((grad_accum * m,) + tuple(x.shape[1:]))


def shard_batch(mesh: Optional[Mesh], batch, grad_accum: int = 1):
    """This rank's rows of a global batch dict (or of each member of a
    tuple of them): padded to a multiple of the ``data`` size times
    ``grad_accum`` with invalid rows first, then sliced by
    ``shard_rows``.  Identity without a mesh or at ``data`` size 1."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(mesh, b, grad_accum) for b in batch)
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return batch
    d = mesh.size(DATA_AXIS)
    batch = pad_batch_to_multiple(batch, d * grad_accum)
    return {k: shard_rows(v, mesh.coord(DATA_AXIS), d, grad_accum)
            for k, v in batch.items()}


def gather_rows(group, x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank of ``group``, in rank order (no gradient):
    [world * b, ...] from [b, ...] (equal b on every rank)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable sum over ``group``
    (``torch.distributed.nn.functional.all_reduce``): its backward sums
    the gradients too."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def wait_for_all_processes(tag: str, timeout_ms: int = 1_800_000,
                           group=None) -> None:
    """A barrier of every process (of ``group``) that raises, naming
    ``tag``, when one has not arrived within ``timeout_ms``."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    work = dist.barrier(group=group, async_op=True)
    if not work.wait(timeout=datetime.timedelta(milliseconds=timeout_ms)):
        raise TimeoutError(f"barrier {tag!r}: a process did not arrive "
                           f"within {timeout_ms} ms")


# ---------------------------------------------------------------------
# the train state over the mesh
# ---------------------------------------------------------------------

def sync_batch_norm(model: nn.Module, group) -> int:
    """Route every ``models/resnet.BatchNorm2d`` of ``model`` through the
    cross-rank statistics over ``group``; returns how many."""
    from scat_tpu_torch.models.resnet import BatchNorm2d
    n = 0
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
            n += 1
    return n


def broadcast_module(model: nn.Module, group=None, src: int = 0) -> None:
    """Every parameter and buffer of ``model`` from global rank ``src``."""
    with torch.no_grad():
        for t in itertools.chain(model.parameters(), model.buffers()):
            dist.broadcast(t.data, src=src, group=group)


def replicate_state(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Data-parallel replicas (JAX ``replicate_state`` :207): the
    parameters broadcast from rank 0, the BN statistics over ``data``,
    and a ``DistributedDataParallel`` over the replica group (the
    forward module of the train state).  ``broadcast_buffers`` is off:
    the cross-rank BN keeps the running statistics equal on every
    rank."""
    from torch.nn.parallel import DistributedDataParallel
    sync_batch_norm(model, mesh.data_group)
    kw = {}
    if model.parameters().__next__().is_cuda:
        kw["device_ids"] = [model.parameters().__next__().device]
    return DistributedDataParallel(model, process_group=mesh.replica_group,
                                   broadcast_buffers=False, **kw)


def fsdp_placement(param: torch.Tensor, data_size: int,
                   min_elems: int = FSDP_MIN_ELEMS) -> Optional[int]:
    """The dimension that FSDP shards ``param`` on: the largest one that
    the ``data`` size divides (JAX ``fsdp_partition_spec`` :146-166);
    None for a leaf below ``min_elems`` or with no such dimension, which
    stays replicated."""
    if param.numel() < min_elems:
        return None
    for i in sorted(range(param.dim()), key=lambda i: -param.shape[i]):
        if param.shape[i] % data_size == 0:
            return i
    return None


def fsdp_state(mesh: Mesh, model: nn.Module,
               min_elems: int = FSDP_MIN_ELEMS) -> Callable[[], None]:
    """FSDP2 (JAX ``fsdp_state`` :258): ``fully_shard`` over the ``data``
    axis, each large parameter sharded on the dimension of
    ``fsdp_placement``; the small ones stay replicated (FSDP's
    ``ignored_params``).  The parameters are broadcast from rank 0 first
    and the BN statistics reduce over ``data``.

    Returns the step's gradient reduction after the backward: FSDP's
    reduce-scatter averages the sharded gradients over ``data`` alone,
    so where ``seq`` or ``pipe`` ranks replicate the shards (each holding
    its tokens' or its stage's part of the gradient, as DDP's ranks do)
    their shards are averaged over those axes too; the replicated
    parameters' gradients are averaged over the whole replica group, as
    DDP averages them."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    sync_batch_norm(model, mesh.data_group)
    broadcast_module(model, mesh.replica_group,
                     src=mesh.group_ranks(mesh.replica_axes)[0])
    # FSDP2 shards contiguous parameters only: the channels_last
    # convolution weights go back to NCHW storage
    with torch.no_grad():
        for p in model.parameters():
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    d = mesh.size(DATA_AXIS)
    replicated = [p for p in model.parameters()
                  if fsdp_placement(p, d, min_elems) is None]
    ids = {id(p) for p in replicated}

    def placement(p):
        return Shard(fsdp_placement(p, d, min_elems) or 0)

    fsdp_mesh = mesh.device_mesh[DATA_AXIS] if len(mesh.axis_names) > 1 \
        else mesh.device_mesh
    fully_shard(model, mesh=fsdp_mesh, shard_placement_fn=placement,
                ignored_params=set(replicated))
    # fully_shard swaps in DTensor parameters: the sharded ones are those
    # that are not the ignored ones
    sharded = [p for p in model.parameters() if id(p) not in ids]
    others = tuple(a for a in mesh.replica_axes
                   if a != DATA_AXIS and mesh.size(a) > 1)
    shard_group = mesh.new_group(others) if others else None

    def reduce_gradients() -> None:
        with torch.no_grad():
            average_gradients([p.grad for p in replicated
                               if p.grad is not None], mesh.replica_group)
            if shard_group is not None:
                average_gradients([p.grad.to_local() for p in sharded
                                   if p.grad is not None], shard_group)

    return reduce_gradients


def average_gradients(grads: Iterable[torch.Tensor], group) -> None:
    """Each of ``grads`` replaced by its mean over ``group``, in place."""
    n = dist.get_world_size(group)
    for g in grads:
        dist.all_reduce(g, group=group)
        g.div_(n)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict in the global reference layout, whatever
    its sharding: FSDP's DTensors gathered, the tensor-parallel slices of
    ``sharding_rules.shard_transformer`` reassembled (every rank takes
    part; the values are on the CPU)."""
    from scat_tpu_torch.parallel import sharding_rules
    module = getattr(model, "module", model)
    out = {}
    for k, v in module.state_dict().items():
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        out[k] = v
    out.update(sharding_rules.gather_tp(module, out))
    return {k: v.detach().cpu() for k, v in out.items()}


def full_optimizer_state(model: nn.Module,
                         optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with every moment of a sharded
    parameter in the global layout (FSDP's gathered, the
    tensor-parallel slices reassembled), the form an optimizer of the
    unsplit model loads; every rank takes part."""
    from scat_tpu_torch.parallel import sharding_rules
    module = getattr(model, "module", model)
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in module.named_parameters()}
    state = {}
    for idx, st in sd["state"].items():
        p = params[idx]
        st = dict(st)
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                if hasattr(v, "full_tensor"):
                    v = v.full_tensor()
                v = sharding_rules.gather_shard(module, names[id(p)], v)
                st[k] = v.detach().cpu()
        state[idx] = st
    return {"state": state, "param_groups": sd["param_groups"]}


def shard_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                          sd: dict) -> None:
    """Load ``full_optimizer_state``'s dict into the optimizer of a
    split model: each moment sliced as its parameter is."""
    from scat_tpu_torch.parallel import sharding_rules
    module = getattr(model, "module", model)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in module.named_parameters()}
    rank = getattr(module, "_tp_rank", 0)
    state = {}
    for idx, st in sd["state"].items():
        p = params[int(idx)]
        st = dict(st)
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                v = sharding_rules.shard_like(v, module, names[id(p)], rank)
                if hasattr(p, "device_mesh"):
                    from torch.distributed.tensor import distribute_tensor
                    v = distribute_tensor(v.to(p.device), p.device_mesh,
                                          p.placements)
                st[k] = v
        state[idx] = st
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})


def is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
