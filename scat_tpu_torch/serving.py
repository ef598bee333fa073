"""Serving: crops in, 3D joints out (port of
``scat_tpu/serving.py:38-256``), for ``--net reg_transformer``,
``reg_transformer_coarse``, ``ViT`` and ``ViP``: the 66-dim camera +
joints heads (a 61-dim MANO-parameter head is refused at construction;
``--net frankmocap`` is served by ``evaluation/tester.py``).

Requests of any size are padded to a ladder of power-of-two batch
buckets and streamed through the model in bucket-sized chunks, so the
device only ever sees a bounded set of batch shapes.  uint8 crops are
uploaded as uint8 and normalised on the device (``/127.5 - 1``).

Example:
    predictor = HandPosePredictor.from_checkpoint(opt)   # on cuda
    out = predictor.predict(crops_uint8)                 # [N,224,224,3]
    out["joints_3d"], out["joints_2d"], out["camera"]

From whole frames: ``predict_from_frames(frames, joints_2d_hint)`` crops
each hand about its rough 2D joints with one warp on the device, then
predicts.

``serving_forward`` is the program that both serve: crops to camera,
joints_3d and joints_2d; ``export.export_predictor`` records it with
``torch.export``.  ``GraphRunner`` replays one CUDA graph per (bucket,
request dtype) of such a program, the counterpart of the JAX package's
one compiled program per bucket; ``export.ExportedPredictor`` serves
through it.  This module imports the models only where a live
predictor is built, so an artifact serves without them.

``mesh=`` (a one-process ``parallel.mesh.make_mesh(..., devices=[...])``,
JAX ``serving.py:140-224``): data-parallel serving.  The predictor holds
one replica of the model on each device of the ``data`` axis, every
bucket is a multiple of the axis size (the ladder starts there), and
each padded bucket is split across the replicas, which run at once and
whose outputs are gathered on the first device.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from scat_tpu_torch.config import Options
from scat_tpu_torch.data import preprocess
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.ops import COUNTED
from scat_tpu_torch.ops.geometry import batch_orth_proj_idrot, project_2d
from scat_tpu_torch.utils.checkpoint import load_weights
from scat_tpu_torch.utils.profiling import span


def check_image_dtype(x: np.ndarray) -> None:
    """Enforce the request dtype contract: uint8 [0,255] or float [-1,1].
    The on-device ``/127.5 - 1`` is only right for uint8; any other
    integer dtype would be silently misscaled."""
    if (np.issubdtype(x.dtype, np.integer) or x.dtype == np.bool_) \
            and x.dtype != np.uint8:
        raise ValueError(
            f"integer inputs must be uint8 [0,255], got {x.dtype}; "
            "pass float crops already normalized to [-1,1] instead")


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_ladder(max_batch: int, base: int = 1) -> list:
    """Power-of-two bucket sizes from ``base``, the top clamped to
    ``max_batch``."""
    buckets = [min(base, max_batch)]
    while buckets[-1] < max_batch:
        buckets.append(min(buckets[-1] * 2, max_batch))
    return buckets


def run_bucketed(forward: Callable, x: np.ndarray, buckets, put: Callable,
                 window: int = 4) -> Dict[str, np.ndarray]:
    """Stream a request through ``forward`` in bucket-sized chunks.

    The request is padded so that every chunk is exactly a bucket size:
    full max-bucket chunks plus one bucketed remainder.  Up to ``window``
    chunks are in flight (launched, not yet fetched), so the device
    computes chunk k+1 while chunk k's outputs come back; fetching as it
    goes keeps a large request from holding every chunk on the device.
    Each chunk's upload, launch and fetch is a span of its own
    (``utils.profiling``), siblings with no span around the request."""
    n = x.shape[0]
    big = buckets[-1]
    rem = n % big
    total = (n - rem) + (pick_bucket(rem, buckets) if rem else 0)
    if total < max(n, 1):
        total = pick_bucket(n, buckets)
    if n < total:
        x = np.concatenate(
            [x, np.zeros((total - n,) + x.shape[1:], x.dtype)])
    inflight: list = []
    cams, j3ds, j2ds = [], [], []

    def drain_one():
        cam, j3d, j2d = inflight.pop(0)
        cams.append(cam.cpu().numpy())
        j3ds.append(j3d.cpu().numpy())
        j2ds.append(j2d.cpu().numpy())

    for s in range(0, x.shape[0], big):
        if len(inflight) >= window:
            with span("scat.serve.fetch"):
                drain_one()
        with span("scat.serve.upload"):
            xb = put(x[s:s + big])
        with span("scat.serve.launch"):
            inflight.append(forward(xb))
    while inflight:
        with span("scat.serve.fetch"):
            drain_one()
    return {"camera": np.concatenate(cams)[:n],
            "joints_3d": np.concatenate(j3ds)[:n],
            "joints_2d": np.concatenate(j2ds)[:n]}


def serving_forward(model: nn.Module, images: torch.Tensor):
    """The serving program: NHWC crops, uint8 [0,255] (normalised here,
    ``/127.5 - 1``) or float32 [-1,1], -> (camera [B,3], joints_3d
    [B,21,3], joints_2d [B,21,2]) of ``model`` in eval mode.  The
    prediction is the first output of a tuple, as
    ``training.steps.prediction`` reads it."""
    if images.dtype == torch.uint8:
        # uint8 requests normalise on the device: the host uploads 4x
        # fewer bytes than float32 crops
        images = images.float() / 127.5 - 1.0
    outputs = model(images.permute(0, 3, 1, 2))
    pred = outputs[0] if isinstance(outputs, tuple) else outputs
    cam = pred[:, :3]
    j3d = pred[:, 3:66].reshape(-1, 21, 3)
    return cam, j3d, project_2d(batch_orth_proj_idrot(j3d, cam))


class ServingForward(nn.Module):
    """``serving_forward`` of ``model`` as a module, the form that
    ``torch.export`` records."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor):
        return serving_forward(self.model, images)


class GraphRunner:
    """Runs ``fn`` (CUDA tensor -> tuple of CUDA tensors) by replaying
    one CUDA graph per input shape and dtype, each with a static input
    buffer, captured on first use (or by ``capture``).  Before a capture
    ``fn`` runs once eagerly on a side stream (library builds, cuDNN
    and cuBLAS set-up happen there, not in the graph).  The graphs share
    one memory pool: replays run in stream order, one at a time, so
    their intermediates can share memory; each graph's static outputs
    stay its own.

    A call copies its input into the static buffer, replays, and
    returns copies of the static outputs made on the device before the
    call returns, so a later replay of the same graph cannot overwrite
    what an earlier call handed out (``run_bucketed`` keeps several
    chunks in flight).  A capture that fails raises.  The kernels' launch
    counters (``ops.COUNTED``) count the warm-up run and the capture,
    not replays; ``replayed`` tallies, by kernel, the launches the
    replays ran: each replay runs what its capture counted."""

    def __init__(self, fn: Callable, device: Union[str, torch.device]):
        self._fn = fn
        self.device = torch.device(device)
        self._graphs: dict = {}
        self._captured: dict = {}   # key -> launches its capture counted
        self._pool = None
        self.replayed: collections.Counter = collections.Counter()

    @property
    def keys(self) -> list:
        """The (shape, dtype) of every captured graph."""
        return list(self._graphs)

    def capture(self, shape, dtype: torch.dtype):
        """The graph for inputs of ``shape`` and ``dtype``, captured
        now if it is not yet: (graph, static input, static outputs)."""
        key = (tuple(shape), dtype)
        if key not in self._graphs:
            static = torch.zeros(key[0], dtype=dtype, device=self.device)
            stream = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.no_grad(), torch.cuda.stream(side):
                self._fn(static)
            stream.wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            before = {n: w.launches for n, w in COUNTED.items()}
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool):
                outs = self._fn(static)
            self._captured[key] = {
                n: w.launches - before.get(n, 0)
                for n, w in COUNTED.items() if w.launches != before.get(n, 0)}
            self._graphs[key] = (graph, static, tuple(outs))
        return self._graphs[key]

    def __call__(self, x: torch.Tensor) -> tuple:
        graph, static, outs = self.capture(x.shape, x.dtype)
        static.copy_(x)
        graph.replay()
        self.replayed.update(self._captured[(tuple(x.shape), x.dtype)])
        return tuple(o.clone() for o in outs)


@dataclasses.dataclass
class HandPosePredictor:
    model: nn.Module
    image_size: int = 224
    max_batch: int = 64
    device: Union[str, torch.device] = "cuda"
    mesh: Optional[object] = None   # parallel.mesh.Mesh over devices

    @classmethod
    def from_checkpoint(cls, opt: Options, image_size: int = 224,
                        device: Union[str, torch.device, None] = None,
                        mesh=None) -> "HandPosePredictor":
        """The predictor of ``opt`` (``--net reg_transformer``,
        ``reg_transformer_coarse``, ``ViT`` or ``ViP``) on ``device``
        (default ``cuda``; the CPU only when asked for), or on the first
        device of ``mesh``.  Weights come from ``opt.checkpoint_path_eval``:
        a reference ``.pth`` (``utils/checkpoint.load_pth``: a partial file
        warns, a ViP file must carry its frozen ``mains.{i}.w``), or an
        empty path for a fresh init seeded with ``opt.seed``."""
        from scat_tpu_torch.models import build_model
        from scat_tpu_torch.models.factory import compute_dtype
        device = resolve_device(device if mesh is None else mesh.devices[0],
                                "HandPosePredictor")
        model, _ = build_model(opt, image_size)
        load_weights(model, opt.checkpoint_path_eval, seed=opt.seed)
        model.cast_compute(compute_dtype(opt))
        return cls(model=model, image_size=image_size, device=device,
                   mesh=mesh)

    def __post_init__(self):
        import copy

        from scat_tpu_torch.models.factory import check_keypoint_head
        check_keypoint_head(self.model, "HandPosePredictor")
        self.device = torch.device(self.device)
        # NHWC crops permuted to NCHW are channels_last tensors; keeping
        # the weights channels_last too lets cuDNN run NHWC convolutions
        self.model = self.model.to(
            self.device, memory_format=torch.channels_last).eval()
        self._replicas = [self.model]
        base = 1
        if self.mesh is not None:
            if self.mesh.rank is not None:
                raise ValueError(
                    "HandPosePredictor(mesh=) takes a one-process mesh of "
                    "devices, make_mesh(..., devices=[...])")
            n = self.mesh.size("data")
            devices = self.mesh.devices[:n]
            if devices[0] != self.device:
                raise ValueError(f"the predictor's device {self.device} is "
                                 f"not the mesh's first, {devices[0]}")
            self._replicas += [copy.deepcopy(self.model).to(d)
                               for d in devices[1:]]
            if self.max_batch % n:
                self.max_batch = max(self.max_batch // n, 1) * n
            base = n
        # power-of-two bucket sizes (multiples of the data-axis size) up
        # to max_batch: at most log2(max_batch)+1 batch shapes
        self._buckets = bucket_ladder(self.max_batch, base)

    def _forward(self, images: torch.Tensor):
        with torch.inference_mode():
            if len(self._replicas) == 1:
                return serving_forward(self.model, images)
            # each replica takes its rows of the padded bucket; the
            # devices run at once, the outputs meet on the first
            outs = [serving_forward(m, x.to(next(m.parameters()).device))
                    for m, x in zip(self._replicas,
                                    images.chunk(len(self._replicas)))]
            return tuple(torch.cat([o[i].to(self.device) for o in outs])
                         for i in range(3))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        # torch tensors are writable: copy a read-only request buffer
        # (an HTTP body) instead of sharing it
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    def warmup(self) -> None:
        """Run every bucket once for uint8 and float32 crops before
        serving traffic: builds the kernels and settles the convolution
        algorithms."""
        for b in self._buckets:
            for dtype in (np.uint8, np.float32):
                x = np.zeros((b, self.image_size, self.image_size, 3), dtype)
                for t in self._forward(self._put(x)):
                    t.cpu()

    def predict(self, images) -> Dict[str, np.ndarray]:
        """``images``: [N,H,W,3] uint8 [0,255] or float [-1,1] crops, N
        arbitrary.  Returns numpy ``camera [N,3]``, ``joints_3d [N,21,3]``
        (root-centred by ``reg_transformer`` and
        ``reg_transformer_coarse``; ``ViT`` and ``ViP`` predict joint 1
        like the others) and ``joints_2d [N,21,2]`` (crop pixels)."""
        x = np.asarray(images)
        check_image_dtype(x)
        if x.dtype != np.uint8:
            x = x.astype(np.float32, copy=False)
        return run_bucketed(self._forward, x, self._buckets, self._put)

    def predict_from_frames(self, frames: np.ndarray,
                            joints_2d_hint: np.ndarray
                            ) -> Dict[str, np.ndarray]:
        """Whole frames and rough 2D joints -> crops (one warp on the
        predictor's device) -> ``predict``.  ``frames`` [N,H,W,3] uint8;
        ``joints_2d_hint`` [N,21,2] frame pixels (a detector's output, or
        the previous frame's prediction, as the demo tracks).  Adds
        ``crop_affine`` [N,2,3], frame px -> crop px."""
        crops, M = frames_to_crops(frames, joints_2d_hint, self.image_size,
                                   self.device)
        out = self.predict(crops)
        out["crop_affine"] = M
        return out


def frames_to_crops(frames: np.ndarray, joints_2d_hint: np.ndarray,
                    image_size: int, device=None) -> tuple:
    """The detection-to-crop stage (port of
    ``scat_tpu/serving.py:272-286``): the crop affine of each frame from
    its 2D hints (expand 1.5, min_size 20: the reference's crop_hand_ref,
    eval.py:89-108), then one bilinear warp of the batch on ``device``
    (default ``cuda``).  Returns numpy (crops [N,S,S,3] float32 in
    [-1, 1], crop_affine [N,2,3])."""
    device = resolve_device(device, "frames_to_crops")
    frames = np.asarray(frames)
    check_image_dtype(frames)
    _, H, W, _ = frames.shape
    hints = torch.as_tensor(np.asarray(joints_2d_hint, np.float32),
                            device=device)
    M, _ = preprocess.crop_hand_affine(hints, W, H, image_size, expand=1.5,
                                       min_size=20.0)
    crops = preprocess.affine_sample(
        preprocess.normalize_to_unit(torch.as_tensor(frames, device=device)),
        M, image_size, image_size, fill=-1.0)
    return crops.cpu().numpy(), M.cpu().numpy()
