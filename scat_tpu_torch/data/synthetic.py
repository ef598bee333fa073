"""Synthetic in-memory hand dataset (port of
``scat_tpu/data/synthetic.py``).

Crops with Gaussian blobs at the projected joints and analytic labels:
105-wide (63 floats of 3D joints + 42 of 2D pixels, the STB layout,
reference load_STB.py:286-289) or 166-wide (the FreiHAND/HO-3D layout).
Deterministic given a seed, and made on the device that will train on
it.

The batch is split in two so that a test can feed the JAX package's
random numbers to the port: ``draw`` takes the random numbers from a
``torch.Generator`` (rotation vector, joint jitter, camera scale and
translation), and ``render`` is a pure function of them that builds the
images and labels as ``_synth_batch_impl`` does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from scat_tpu_torch import assets
from scat_tpu_torch.ops.geometry import (batch_orth_proj_idrot, project_2d,
                                         rodrigues_guarded)

LAYOUTS = ("stb", "frei")


def draw(generator: torch.Generator, batch_size: int
         ) -> Dict[str, torch.Tensor]:
    """The random numbers of one batch, on ``generator``'s device: a
    global rotation of the template (recoverable from the rendered
    pattern), small per-joint jitter, camera scale and translation."""
    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device)
    return {"rotvec": normal(batch_size, 3) * 0.4,
            "jitter": normal(batch_size, 21, 3) * 0.002,
            "scale": 5.0 + normal(batch_size, 1) * 0.3,
            "trans": normal(batch_size, 2) * 0.02}


def render(draws: Dict[str, torch.Tensor], template: torch.Tensor,
           image_size: int = 224, layout: str = "stb"
           ) -> Dict[str, torch.Tensor]:
    """Images NHWC [B,S,S,3] in [-1,1], labels and an all-ones ``valid``
    from the draws; ``template`` is the [21,3] mean hand."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 'stb' or 'frei', got {layout!r}")
    rotvec = draws["rotvec"]
    b = rotvec.shape[0]
    device = rotvec.device
    R = rodrigues_guarded(rotvec)
    joints_3d = torch.einsum("bij,nj->bni", R, template.to(device))
    joints_3d = joints_3d + draws["jitter"]
    joints_3d = joints_3d - joints_3d[:, 1:2]  # root-centred like labels
    cam = torch.cat([draws["scale"], draws["trans"]], dim=1)
    joints_2d = project_2d(batch_orth_proj_idrot(joints_3d, cam))

    # per-joint blobs whose size and colour encode the joint; labels stay
    # in the 224-pixel projection at every image_size and the blob
    # centres are scaled onto the actual canvas
    canvas = image_size / 224.0
    blob_2d = joints_2d * canvas
    j = torch.arange(21, dtype=torch.float32, device=device)
    sigma = torch.clamp((3.0 + 0.35 * j) * canvas, min=0.75)[None, :, None]
    grid = torch.arange(image_size, dtype=torch.float32, device=device)
    gy = torch.exp(-(grid[None, None] - blob_2d[:, :, 1:2]) ** 2
                   / (2 * sigma ** 2))                        # [B,21,H]
    gx = torch.exp(-(grid[None, None] - blob_2d[:, :, 0:1]) ** 2
                   / (2 * sigma ** 2))                        # [B,21,W]
    chan = torch.stack([0.3 + 0.7 * torch.cos(j) ** 2,
                        0.3 + 0.7 * torch.sin(j) ** 2,
                        0.3 + 0.7 * torch.cos(2 * j) ** 2], dim=-1)
    # sum over joints of gy x gx x colour, as one batched product
    blobs = torch.einsum("bjhc,bjw->bhwc",
                         gy[..., None] * chan[None, :, None, :], gx)
    images = blobs.clamp(0.0, 1.0) * 2.0 - 1.0

    if layout == "frei":
        # [cam3 | pose48 | shape10 | 3D63 | 2D42]; the rotation is the
        # pose's global orientation, local pose and shape are zero
        zeros = torch.zeros(b, 55, device=device)
        labels = torch.cat([cam, rotvec, zeros, joints_3d.reshape(b, 63),
                            joints_2d.reshape(b, 42)], dim=1)
    else:
        labels = torch.cat([joints_3d.reshape(b, 63),
                            joints_2d.reshape(b, 42)], dim=1)
    return {"image": images, "label": labels,
            "valid": torch.ones(b, device=device)}


def _template(mean_params: Optional[np.ndarray]) -> torch.Tensor:
    if mean_params is None:
        mean_params = assets.load_mean_params()
    return torch.as_tensor(np.asarray(mean_params)[3:66].reshape(21, 3),
                           dtype=torch.float32)


def synth_batch(generator: torch.Generator, batch_size: int,
                image_size: int = 224,
                mean_params: Optional[np.ndarray] = None,
                layout: str = "stb") -> Dict[str, torch.Tensor]:
    """One batch on ``generator``'s device."""
    return render(draw(generator, batch_size), _template(mean_params),
                  image_size, layout)


class SyntheticDataset:
    """Iterator with the reference loader's (image, label) contract:
    ``num_batches`` batches a pass, batch i drawn from a generator seeded
    by (``seed``, i), so every pass yields the same batches."""

    def __init__(self, batch_size: int, num_batches: int = 16,
                 seed: int = 0, image_size: int = 224,
                 mean_params: Optional[np.ndarray] = None,
                 layout: str = "stb", device="cpu"):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be 'stb' or 'frei', "
                             f"got {layout!r}")
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.seed = seed
        self.image_size = image_size
        self.layout = layout
        self.device = torch.device(device)
        self.template = _template(mean_params).to(self.device)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for i in range(self.num_batches):
            seed = int(np.random.SeedSequence([self.seed, i])
                       .generate_state(1)[0])
            gen = torch.Generator(self.device).manual_seed(seed)
            yield render(draw(gen, self.batch_size), self.template,
                         self.image_size, self.layout)
