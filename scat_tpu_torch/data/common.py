"""Shared loader plumbing (port of ``scat_tpu/data/common.py``), and the
loaders' PIL decode.

Every dataset iterates with torch-DataLoader(shuffle=True) semantics:
each pass advances an epoch counter and takes a fresh deterministic
permutation from (seed, epoch).  The process topology is (0, 1) unless
``torch.distributed`` is initialised; then each process walks a disjoint
shard of every epoch at its share of the global batch.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

EPOCH_STRIDE = 9973   # a prime stride decorrelates the per-epoch streams


def sibling_root(data_dir: str, *names: str) -> str:
    """The first of ``names`` that is a directory beside ``data_dir`` (the
    STB tree of ``--data_dir``), else ``data_dir`` itself: where the
    FreiHAND, HO-3D, MHP and RHD loaders find their trees."""
    parent = os.path.dirname(data_dir.rstrip("/"))
    for name in names:
        if os.path.isdir(os.path.join(parent, name)):
            return os.path.join(parent, name)
    return data_dir


def load_rgb(path: str) -> np.ndarray:
    """A frame decoded by PIL as uint8 [H,W,3]."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _process_topology() -> Tuple[int, int]:
    """(process index, process count): (0, 1) unless torch.distributed
    is initialised.  Under the port's mesh (``parallel/mesh.make_mesh``)
    they are the ``data`` coordinate and size, so that each data rank
    reads and decodes only its share, and the ranks of one data
    coordinate (``model``, ``seq`` and ``pipe`` peers) the same rows."""
    import torch.distributed as dist

    from scat_tpu_torch.parallel.mesh import DATA_AXIS, active_mesh
    mesh = active_mesh()
    if mesh is not None:
        return mesh.coord(DATA_AXIS), mesh.size(DATA_AXIS)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of a global batch; the global batch itself in
    a single process."""
    _, pc = _process_topology()
    if pc == 1:
        return global_batch_size
    if global_batch_size % pc:
        raise ValueError(
            f"--batch_size {global_batch_size} must divide evenly over "
            f"{pc} processes (each process feeds its own shard of the "
            "global batch)")
    return global_batch_size // pc


def host_shard(order: np.ndarray) -> np.ndarray:
    """This process's slice of an epoch's order: strided, cut to the same
    length on every process, so that all run the same number of steps."""
    pi, pc = _process_topology()
    if pc == 1:
        return order
    return order[pi::pc][:len(order) // pc]


def num_batches(n_samples: int, batch_size: int) -> int:
    """Batches an epoch for this process: its shard of the samples over
    its batch size (``n // batch_size`` in a single process)."""
    _, pc = _process_topology()
    return (n_samples // pc) // batch_size


def epoch_order(dataset, n: int) -> Tuple[np.ndarray, int]:
    """(permutation of ``n`` samples, epoch index) for this pass.
    ``dataset`` has ``shuffle`` and ``seed`` and carries the ``_epoch``
    counter; the permutation is a function of (seed, epoch) alone."""
    epoch = getattr(dataset, "_epoch", 0)
    dataset._epoch = epoch + 1
    order = np.arange(n)
    if dataset.shuffle:
        np.random.RandomState(dataset.seed + EPOCH_STRIDE * epoch).shuffle(
            order)
    return host_shard(order), epoch
