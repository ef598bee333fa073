"""scat_tpu_torch — the PyTorch / NVIDIA H100 port of scat_tpu.

The same SCAT hand-pose model (CNN backbone -> token-pyramid transformer
-> iterative regressor, 224x224 crop -> 21 root-centred 3D joints) in
PyTorch, with the JAX package's Pallas TPU kernels rewritten by hand
for Hopper (``csrc/``, built at first use by ``kernels/build.py``).

The layout mirrors ``scat_tpu`` module for module, so the counterpart of
a JAX module is found by path.  Weights use the reference SCAT torch key
layout (``main_encoder.layer1.0.conv1.weight``,
``transformer.layers.{i}.0.fn.fn.to_qkv.weight``), so
``utils.weights.state_dict_from_flax`` output loads with
``load_state_dict(strict=True)`` and a reference ``.pth`` loads as the
JAX package loads it (``utils.checkpoint.load_pth``).

The package imports nothing of ``jax``, ``flax`` or ``scat_tpu``; it
keeps its own copies of the framework-free modules it needs.  Importing
it does not import torch: submodules are imported explicitly.
"""

__version__ = "0.1.0"
