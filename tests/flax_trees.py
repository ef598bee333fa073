"""Flax variable trees filled from a numpy seed, for the port's parity
tests: ``jax.eval_shape`` of a module's init gives the shapes without
compiling the init, and seeded draws at flax's scales fill them."""

import jax
import numpy as np


def plain(tree):
    """A (frozen) dict tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def fill(shapes, rng):
    """Seeded values for a tree of ShapeDtypeStructs: lecun-normal
    kernels, non-trivial BatchNorm and LayerNorm affines, running
    statistics, small biases, normal(1) tokens and embeddings."""
    def leaf(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "mean":
            v = rng.uniform(-0.1, 0.1, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("mask_token", "cls_token", "pos_embedding"):
            v = rng.randn(*shape)
        else:
            v = rng.randn(*shape) * 0.05
        return np.asarray(v, np.float32)
    return plain(jax.tree_util.tree_map_with_path(leaf, shapes))


def variables(module, rng, *args, **kw):
    """``module``'s variables for inputs ``args``, filled by ``fill``."""
    shapes = jax.eval_shape(lambda *a: module.init(
        {"params": jax.random.key(0), "mask": jax.random.key(1),
         "dropout": jax.random.key(2)}, *a, **kw), *args)
    return fill(shapes, rng)
