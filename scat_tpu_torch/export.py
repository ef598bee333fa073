"""Serving export: the predictor's forward as a saved program (port of
``scat_tpu/export.py``).

``export_predictor`` records ``serving.serving_forward`` (uint8 or
float32 NHWC crops -> camera, joints_3d, joints_2d) of a
``HandPosePredictor`` with ``torch.export`` and a symbolic batch
dimension (1 to the predictor's ``max_batch``), once per request dtype,
into a directory, as the JAX package's ``export.py:3-13`` lays it out:

    manifest.json         format, image size, max batch, dtypes, the
                          device type exported for, net, compute dtype,
                          the bit-cast keys of the weights
    forward_uint8.pt2     the program for [b, S, S, 3] uint8 requests
    forward_float32.pt2   ... for float32 requests already in [-1, 1]
    weights.npz           the model's state_dict under its flat reference
                          keys; bf16 tensors bit-cast to uint16, as the
                          JAX package's ``_BITCAST`` stores them

The programs take the weights as an input (``torch.func.functional_call``
of the model on a dict of tensors), so no program carries a copy: the
model's non-persistent buffers (the sinusoidal encoding, the mean
parameters) are the programs' constants, as the JAX package bakes its
constants into its programs.  The hand-written kernels are
the custom ops ``scat_tpu_torch::attention_fwd``, ``::favor_stats`` and
``::favor_apply``, recorded as nodes of the programs
(``ops/attention.py``, ``ops/favor.py``).

``ExportedPredictor`` (``load_artifact``) serves the directory WITHOUT
importing any model module of the port: the artifact carries the
program, and only the ops that it names are imported.  It reads
``weights.npz`` once, onto the device, and hands the same tensors to
both programs and to their CUDA graphs.  Its ``predict``
has ``HandPosePredictor.predict``'s contract (bucketing, padding, the
bounded in-flight window of ``serving.run_bucketed``).  On CUDA each
(bucket, request dtype) is one CUDA graph (``serving.GraphRunner``),
the counterpart of the JAX package's one compiled program per concrete
batch shape; on the CPU the programs run eagerly.  A program exported
for one device type serves on that type only: loading it for another
raises, as the JAX package's platform check does.

CLI (on the CUDA device; ``--device cpu`` asks for the CPU):
    python -m scat_tpu_torch.export --net reg_transformer --iteration 3 \\
        --vit_heads 8 --checkpoint_path_eval .../hand_net_final.pth \\
        --export_dir out/
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

# the programs name these ops: importing the modules registers them
from scat_tpu_torch.ops import attention, favor  # noqa: F401
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.serving import (GraphRunner, ServingForward,
                                    bucket_ladder, check_image_dtype,
                                    frames_to_crops, run_bucketed)

MANIFEST = "manifest.json"
WEIGHTS = "weights.npz"
FORMAT = "scat_tpu_torch.export/2"
# numpy's .npz has no bfloat16: such tensors ship bit-cast to a
# same-width integer and are restored by key (the JAX package's _BITCAST)
BITCAST = {torch.bfloat16: (torch.int16, "uint16")}
DTYPES = {"uint8": torch.uint8, "float32": torch.float32}
# torch.export takes sizes 0 and 1 for constants; the example batch is 2,
# and the program's batch range starts at 1
EXAMPLE_BATCH = 2


def program_path(path: str, dtype_name: str) -> str:
    return os.path.join(path, f"forward_{dtype_name}.pt2")


class _Functional(torch.nn.Module):
    """``serving_forward`` of a model whose state_dict is the first input:
    the form in which a program takes its weights instead of holding
    them.  The model is not a submodule, so ``torch.export`` lifts none
    of its tensors."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        object.__setattr__(self, "_serving", ServingForward(model).eval())

    def forward(self, weights: Dict[str, torch.Tensor], images):
        return torch.func.functional_call(
            self._serving, {f"model.{k}": v for k, v in weights.items()},
            (images,))


def save_weights(state_dict: Dict[str, torch.Tensor], path: str
                 ) -> Dict[str, str]:
    """``state_dict`` as one ``.npz`` under its keys; returns the
    bit-cast keys and their dtype names."""
    arrays, bitcast = {}, {}
    for k, v in state_dict.items():
        v = v.detach().cpu().contiguous()
        if v.dtype in BITCAST:
            as_int, _ = BITCAST[v.dtype]
            bitcast[k] = str(v.dtype).replace("torch.", "")
            v = v.view(as_int)
        arrays[k] = v.numpy()
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return bitcast


def load_weights_npz(path: str, bitcast: Dict[str, str],
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """The tensors of ``save_weights``'s file on ``device``, 4-d ones
    channels_last as the live predictor holds its convolution weights."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            t = torch.from_numpy(z[k])
            if k in bitcast:
                t = t.view(getattr(torch, bitcast[k]))
            t = t.to(device)
            if t.dim() == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            out[k] = t
    return out


def export_predictor(predictor, out_dir: str,
                     net: Optional[str] = None) -> Dict[str, object]:
    """Write the serving artifact of ``predictor`` (a
    ``serving.HandPosePredictor``) to ``out_dir`` for the device type it
    runs on; ``net`` is recorded in the manifest.  Returns the
    manifest."""
    if predictor.max_batch < EXAMPLE_BATCH:
        raise ValueError(f"export needs max_batch >= {EXAMPLE_BATCH}, got "
                         f"{predictor.max_batch}")
    os.makedirs(out_dir, exist_ok=True)
    size = predictor.image_size
    module = _Functional(predictor.model)
    weights = dict(predictor.model.state_dict())
    batch = torch.export.Dim("batch", min=1, max=predictor.max_batch)
    for name, dtype in DTYPES.items():
        example = torch.zeros((EXAMPLE_BATCH, size, size, 3), dtype=dtype,
                              device=predictor.device)
        with torch.no_grad():
            program = torch.export.export(
                module, (weights, example),
                dynamic_shapes=({k: None for k in weights}, {0: batch}))
        # the saved program would carry its example inputs, the weights
        # among them
        program.example_inputs = None
        torch.export.save(program, program_path(out_dir, name))
    bitcast = save_weights(weights, os.path.join(out_dir, WEIGHTS))
    manifest = {
        "format": FORMAT,
        "image_size": size,
        "max_batch": predictor.max_batch,
        "dtypes": list(DTYPES),
        "device": predictor.device.type,
        "net": net,
        "compute_dtype": str(getattr(predictor.model, "compute_dtype",
                                     torch.float32)).replace("torch.", ""),
        "weights": WEIGHTS,
        "bitcast": bitcast,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def op_nodes(module: torch.nn.Module) -> Dict[str, int]:
    """How many nodes of each ``scat_tpu_torch`` op a loaded program
    (``ExportedPredictor.programs[dtype]``) holds, counted through its
    submodules (an autocast block is one)."""
    counts: Dict[str, int] = {}
    for sub in module.modules():
        graph = getattr(sub, "graph", None)
        for node in graph.nodes if graph is not None else ():
            target = str(node.target)
            if node.op == "call_function" and \
                    target.startswith("scat_tpu_torch."):
                op = target.split(".")[1]
                counts[op] = counts.get(op, 0) + 1
    return counts


class ExportedPredictor:
    """Serve from an exported artifact: no model code, no checkpoint.

    Same request contract as ``HandPosePredictor.predict``: ``[N,S,S,3]``
    uint8 [0,255] or float [-1,1] crops, any N; returns numpy ``camera
    [N,3]``, ``joints_3d [N,21,3]``, ``joints_2d [N,21,2]`` (crop
    pixels).  ``device`` defaults to ``cuda``; it must be of the device
    type the artifact was exported for."""

    def __init__(self, path: str,
                 device: Union[str, torch.device, None] = None):
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: artifact format "
                             f"{manifest.get('format')!r}, expected "
                             f"{FORMAT!r}")
        self.device = resolve_device(device, "ExportedPredictor")
        if manifest["device"] != self.device.type:
            raise ValueError(
                f"{path} was exported for {manifest['device']} and cannot "
                f"serve on {self.device.type}; export it there")
        self.manifest = manifest
        self.path = path
        self.image_size = int(manifest["image_size"])
        self.max_batch = int(manifest["max_batch"])
        self._buckets = bucket_ladder(self.max_batch)
        self.weights = load_weights_npz(
            os.path.join(path, manifest["weights"]), manifest["bitcast"],
            self.device)
        self.programs = {name: torch.export.load(
            program_path(path, name)).module() for name in manifest["dtypes"]}
        forwards = {name: functools.partial(module, self.weights)
                    for name, module in self.programs.items()}
        if self.device.type == "cuda":
            self._forwards = {name: GraphRunner(fn, self.device)
                              for name, fn in forwards.items()}
        else:
            self._forwards = {name: _eager(fn)
                              for name, fn in forwards.items()}

    def _forward_of(self, x: np.ndarray):
        name = "uint8" if x.dtype == np.uint8 else "float32"
        forward = self._forwards.get(name)
        if forward is None:
            raise ValueError(f"{self.path} was not exported for {name} "
                             "inputs")
        return forward

    def _put(self, a: np.ndarray) -> torch.Tensor:
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def warmup(self) -> None:
        """Run every bucket once for each request dtype before serving
        traffic: on CUDA this captures every (bucket, dtype) graph."""
        for b in self._buckets:
            for name in self._forwards:
                x = np.zeros((b, self.image_size, self.image_size, 3),
                             np.dtype(name))
                for t in self._forward_of(x)(self._put(x)):
                    t.cpu()

    def predict(self, images) -> Dict[str, np.ndarray]:
        """``HandPosePredictor.predict`` on the artifact."""
        x = np.asarray(images)
        check_image_dtype(x)
        if x.dtype != np.uint8:
            x = x.astype(np.float32, copy=False)
        return run_bucketed(self._forward_of(x), x, self._buckets,
                            self._put)

    def predict_from_frames(self, frames: np.ndarray,
                            joints_2d_hint: np.ndarray
                            ) -> Dict[str, np.ndarray]:
        """Whole frames and rough 2D joints -> crops -> ``predict``, as
        ``HandPosePredictor.predict_from_frames``; adds ``crop_affine``."""
        crops, M = frames_to_crops(frames, joints_2d_hint, self.image_size,
                                   self.device)
        out = self.predict(crops)
        out["crop_affine"] = M
        return out


def _eager(module):
    def forward(x):
        with torch.inference_mode():
            return module(x)
    return forward


def load_artifact(path: str, device: Union[str, torch.device, None] = None
                  ) -> ExportedPredictor:
    return ExportedPredictor(path, device)


def main(argv=None) -> None:
    import argparse
    import sys

    from scat_tpu_torch.config import BaseOptions
    from scat_tpu_torch.serving import HandPosePredictor

    peel = argparse.ArgumentParser(add_help=False)
    peel.add_argument("--device", default="cuda",
                      help="device to export for (default cuda)")
    peel_opt, rest = peel.parse_known_args(
        sys.argv[1:] if argv is None else argv)
    opt = BaseOptions().parse(rest)
    predictor = HandPosePredictor.from_checkpoint(opt,
                                                  device=peel_opt.device)
    export_predictor(predictor, opt.export_dir, net=opt.net)
    files = sorted(os.listdir(opt.export_dir))
    total = sum(os.path.getsize(os.path.join(opt.export_dir, f))
                for f in files)
    print(f"exported {opt.net} -> {opt.export_dir} "
          f"({len(files)} files, {total / 1e6:.1f} MB)")
    for f in files:
        print(f"  {f}")


if __name__ == "__main__":
    main()
