"""Numerical sanity and consistency checks (the port's own copy of
``scat_tpu/utils/debugging.py``; the reference has none).

* ``check_graph_consistency``: the counterpart of the JAX package's
  ``check_jit_consistency``.  A program run eagerly against the same
  program replayed from a CUDA graph (``serving.GraphRunner``) on CUDA
  tensors, or against its ``torch.export`` program on CPU tensors:
  catches state that capture freezes (a host value read once, a buffer
  that a later call overwrites) and what export cannot record.
* ``assert_all_finite``: a NaN/Inf audit of a state_dict or a nested
  structure of tensors and arrays, naming each bad key.
* ``check_determinism``: the same seeded ``torch.Generator`` twice ->
  identical outputs (catches hidden host randomness like the
  reference's python-RNG token masking, hand_net.py:369-373).
* ``count_params``.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """(key path, leaf) of a nested dict / list / tuple; a module is its
    state_dict."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def check_graph_consistency(fn: Callable, *args: torch.Tensor,
                            atol: float = 1e-5, rtol: float = 1e-5) -> None:
    """``fn(*args)`` eagerly against ``fn`` replayed from a CUDA graph
    (CUDA tensors) or run as its ``torch.export`` program (CPU tensors);
    ``fn`` takes and returns tensors (or a tuple of them)."""
    with torch.no_grad():
        eager = fn(*args)
        if args[0].is_cuda:
            from scat_tpu_torch.serving import GraphRunner
            if len(args) != 1:
                raise ValueError("the CUDA graph check takes one input")
            other = GraphRunner(lambda x: _tuple(fn(x)),
                                args[0].device)(args[0])
        else:
            program = torch.export.export(_Module(fn), tuple(args))
            other = program.module()(*args)
    for e, o in zip(_tuple(eager), _tuple(other)):
        np.testing.assert_allclose(_numpy(e), _numpy(o), atol=atol,
                                   rtol=rtol)


def _tuple(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class _Module(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming (up to 10 of) the floating
    leaves of ``tree`` (a module's state_dict, a dict, list or tuple of
    tensors or arrays) that hold a NaN or an Inf."""
    bad = []
    for path, leaf in _leaves(tree):
        arr = _numpy(leaf)
        if np.issubdtype(arr.dtype, np.floating) and \
                not np.all(np.isfinite(arr)):
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def check_determinism(fn: Callable[[torch.Generator], object],
                      seed: int = 0) -> None:
    """``fn`` called twice with a ``torch.Generator`` seeded ``seed``
    gives identical outputs."""
    a = fn(torch.Generator().manual_seed(seed))
    b = fn(torch.Generator().manual_seed(seed))
    for (_, x), (_, y) in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(_numpy(x), _numpy(y))


def count_params(params) -> int:
    """Elements of every leaf of ``params`` (a module: its parameters,
    as the JAX package counts its ``params`` tree; or a nested
    structure of tensors)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(int(np.prod(np.shape(leaf))) for _, leaf in _leaves(params))
