"""Export the serving forward to a ``torch.export`` artifact, then serve
it, on the PyTorch port.

Stage 1 (a machine with the framework + checkpoint):

    python -m scat_tpu_torch.export --net reg_transformer --iteration 3 \
        --vit_heads 8 --checkpoint_path_eval experiments/.../hand_net_final.pth \
        --export_dir /srv/scat_artifact

Stage 2 (the serving host, on the device type the artifact was exported
for; needs only torch + numpy + scat_tpu_torch's ``export``/``serving``
modules and the kernels' ops: no model code, no checkpoint):

    python examples/serve_artifact_torch.py /srv/scat_artifact

This script does both stages in one process against a fresh-init
predictor so it runs anywhere with a CUDA device (no checkpoint on disk
needed); ``--device cpu`` exports and serves on the CPU instead (an
artifact serves only on the device type it was exported for).
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the fresh-init flagship: resnet50, 224-px crops, bf16 compute; the
# port spells a fresh init as an empty checkpoint path
FLAGSHIP = dict(net="reg_transformer", iteration=3, vit_heads=8,
                checkpoint_path_eval="")
IMAGE_SIZE = 224


def main(artifact=None, device=None):
    """Serve ``artifact`` (a directory), or export the fresh-init flagship
    to a new temporary directory and serve that, on ``device`` (default
    ``cuda``; raises where CUDA is absent unless ``device="cpu"``).
    Returns what it printed (the outputs, the crops, the artifact's
    directory) with the served artifact and the live predictor (None when
    an artifact was given)."""
    from scat_tpu_torch.devices import resolve_device
    from scat_tpu_torch.export import export_predictor, load_artifact

    device = resolve_device(device, "serve_artifact_torch")
    predictor = None
    if artifact is None:
        from scat_tpu_torch.config import Options
        from scat_tpu_torch.serving import HandPosePredictor
        opt = Options(**FLAGSHIP)
        predictor = HandPosePredictor.from_checkpoint(
            opt, image_size=IMAGE_SIZE, device=device)
        artifact = tempfile.mkdtemp(prefix="scat_artifact_")
        export_predictor(predictor, artifact, net=opt.net)
        print(f"exported fresh-init flagship -> {artifact}")

    served = load_artifact(artifact, device=device)
    crops = np.random.default_rng(0).integers(
        0, 256, (5, served.image_size, served.image_size, 3), np.uint8)
    out = served.predict(crops)
    print("camera:", out["camera"].shape,
          "joints_3d:", out["joints_3d"].shape,
          "joints_2d:", out["joints_2d"].shape)
    print("sample camera row:", np.round(out["camera"][0], 4))
    return {"artifact": artifact, "crops": crops, "out": out,
            "served": served, "live": predictor}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", nargs="?", default=None,
                    help="artifact directory (default: export one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args()
    main(args.artifact, args.device)
