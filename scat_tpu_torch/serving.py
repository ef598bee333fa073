"""Serving: crops in, 3D joints out (port of
``scat_tpu/serving.py:38-256``), for ``--net reg_transformer``,
``reg_transformer_coarse`` and ``ViP``: the 66-dim camera + joints heads
(a 61-dim MANO-parameter head is refused at construction).

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
predicts.  Not ported yet: ``mesh=`` data-parallel serving (ROADMAP.md
queue 1 item 17).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from scat_tpu_torch.config import Options
from scat_tpu_torch.data import preprocess
from scat_tpu_torch.devices import resolve_device
from scat_tpu_torch.models import build_model
from scat_tpu_torch.models.factory import check_keypoint_head, compute_dtype
from scat_tpu_torch.ops.geometry import batch_orth_proj_idrot, project_2d
from scat_tpu_torch.training.steps import prediction
from scat_tpu_torch.utils.checkpoint import load_weights


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


def bucket_ladder(max_batch: int) -> list:
    """Power-of-two bucket sizes from 1, the top clamped to
    ``max_batch``."""
    buckets = [1]
    while buckets[-1] < max_batch:
        buckets.append(min(buckets[-1] * 2, max_batch))
    return buckets


def run_bucketed(forward: Callable, x: np.ndarray, buckets, put: Callable,
                 window: int = 4,
                 chunk_device_times: Optional[list] = None
                 ) -> Dict[str, np.ndarray]:
    """Stream a request through ``forward`` in bucket-sized chunks.

    The request is padded so that every chunk is exactly a bucket size:
    full max-bucket chunks plus one bucketed remainder.  Up to ``window``
    chunks are in flight (launched, not yet fetched), so the device
    computes chunk k+1 while chunk k's outputs come back; fetching as it
    goes keeps a large request from holding every chunk on the device.

    ``chunk_device_times``: pass a list to record each chunk's device
    latency in seconds (dispatch -> outputs on the host, measured after
    the chunk's upload has finished).  Timing waits on every chunk, so
    this mode gives up the in-flight overlap: it is for measurement."""
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
            drain_one()
        xb = put(x[s:s + big])
        if chunk_device_times is None:
            inflight.append(forward(xb))
        else:
            if xb.is_cuda:
                torch.cuda.synchronize(xb.device)  # upload complete
            t0 = time.perf_counter()
            out = tuple(o.cpu() for o in forward(xb))
            chunk_device_times.append(time.perf_counter() - t0)
            inflight.append(out)
    while inflight:
        drain_one()
    return {"camera": np.concatenate(cams)[:n],
            "joints_3d": np.concatenate(j3ds)[:n],
            "joints_2d": np.concatenate(j2ds)[:n]}


@dataclasses.dataclass
class HandPosePredictor:
    model: nn.Module
    image_size: int = 224
    max_batch: int = 64
    device: Union[str, torch.device] = "cuda"

    @classmethod
    def from_checkpoint(cls, opt: Options, image_size: int = 224,
                        device: Union[str, torch.device, None] = None
                        ) -> "HandPosePredictor":
        """The predictor of ``opt`` (``--net reg_transformer``,
        ``reg_transformer_coarse`` or ``ViP``) on ``device`` (default ``cuda``; the CPU only when asked
        for).  Weights come from ``opt.checkpoint_path_eval``: a reference
        ``.pth`` (loaded strictly: a ViP file must carry its frozen
        ``mains.{i}.w``), or an empty path for a fresh init seeded with
        ``opt.seed``."""
        device = resolve_device(device, "HandPosePredictor")
        model, _ = build_model(opt, image_size)
        load_weights(model, opt.checkpoint_path_eval, seed=opt.seed)
        model.cast_compute(compute_dtype(opt))
        return cls(model=model, image_size=image_size, device=device)

    def __post_init__(self):
        check_keypoint_head(self.model, "HandPosePredictor")
        self.device = torch.device(self.device)
        # NHWC crops permuted to NCHW are channels_last tensors; keeping
        # the weights channels_last too lets cuDNN run NHWC convolutions
        self.model = self.model.to(
            self.device, memory_format=torch.channels_last).eval()
        # power-of-two bucket sizes up to max_batch: at most
        # log2(max_batch)+1 distinct batch shapes reach the device
        self._buckets = bucket_ladder(self.max_batch)

    def _forward(self, images: torch.Tensor):
        with torch.inference_mode():
            if images.dtype == torch.uint8:
                # uint8 requests normalise on the device: the host
                # uploads 4x fewer bytes than float32 crops
                images = images.float() / 127.5 - 1.0
            pred = prediction(self.model(images.permute(0, 3, 1, 2)))
            cam = pred[:, :3]
            j3d = pred[:, 3:66].reshape(-1, 21, 3)
            j2d = project_2d(batch_orth_proj_idrot(j3d, cam))
            return cam, j3d, j2d

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

    def predict(self, images,
                chunk_device_times: Optional[list] = None
                ) -> Dict[str, np.ndarray]:
        """``images``: [N,H,W,3] uint8 [0,255] or float [-1,1] crops, N
        arbitrary.  Returns numpy ``camera [N,3]``, ``joints_3d [N,21,3]``
        (root-centred by ``reg_transformer`` and
        ``reg_transformer_coarse``; ``ViP`` predicts joint 1 like the
        others) and ``joints_2d [N,21,2]`` (crop pixels).

        ``chunk_device_times``: measurement mode, see ``run_bucketed``."""
        x = np.asarray(images)
        check_image_dtype(x)
        if x.dtype != np.uint8:
            x = x.astype(np.float32, copy=False)
        return run_bucketed(self._forward, x, self._buckets, self._put,
                            chunk_device_times=chunk_device_times)

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
