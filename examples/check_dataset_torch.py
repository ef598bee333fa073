"""Loader sanity-check script on the PyTorch port: the reference's
check_dataset.ipynb (extra_data/check_dataset.ipynb) as a runnable
module: iterate each available loader, print batch shapes/ranges, and
save a debug plot of the first sample (skipped, with a message, where
matplotlib is missing).

The batches are made on the CUDA device; ``--device cpu`` makes them on
the CPU.

Usage: python examples/check_dataset_torch.py [--data_dir ./STB/] [--n 2]
           [--out_dir .] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def check(name, loader, n, out_dir):
    """Print ``n`` batches of ``loader`` and plot the first sample; returns
    the printed batch lines."""
    import itertools
    lines = []
    print(f"== {name}: {len(loader)} batches")
    for i, batch in enumerate(itertools.islice(iter(loader), n)):
        img = batch["image"].float().cpu().numpy()     # NHWC
        lab = batch["label"].float().cpu().numpy()
        valid = batch["valid"].float().mean().item()
        lines.append(f"  batch {i}: image{img.shape} [{img.min():.2f},"
                     f"{img.max():.2f}] label{lab.shape} "
                     f"valid={valid:.2f}")
        print(lines[-1])
        if i == 0:
            from scat_tpu_torch.viz.draw import (debug_dataset,
                                                 unnormalize_image)
            j3d = lab[0, :63].reshape(21, 3)
            j2d = (lab[0, 63:105].reshape(21, 2) if lab.shape[1] == 105
                   else lab[0, 124:].reshape(21, 2))
            debug_dataset(unnormalize_image(img[0]), j2d, j3d,
                          os.path.join(out_dir, f"{name}_debug"))
    return lines


def main(argv=None, device=None):
    """The flags of the module docstring (``device`` is ``--device``'s
    default: ``cuda`` when None, which raises where CUDA is absent).
    Returns {loader name: its batch lines, or None where it was
    skipped}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="./STB/")
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--out_dir", default=".")
    ap.add_argument("--device", default=device,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from scat_tpu_torch.config import Options
    from scat_tpu_torch.data.synthetic import SyntheticDataset
    from scat_tpu_torch.devices import resolve_device
    dev = resolve_device(args.device, "check_dataset_torch")
    opt = Options(data_dir=args.data_dir, batch_size=4)

    seen = {"synthetic": check(
        "synthetic", SyntheticDataset(4, num_batches=2, device=dev), args.n,
        args.out_dir)}
    from scat_tpu_torch.data.stb import get_loader_STB
    stb = get_loader_STB("training", 4, opt, device=dev)
    if len(stb):
        seen["STB"] = check("STB", stb, args.n, args.out_dir)
    else:
        seen["STB"] = None
        print(f"== STB: no data under {args.data_dir}, skipped")
    try:
        from scat_tpu_torch.data.freihand import get_loader_frei
        seen["FreiHAND"] = check(
            "FreiHAND", get_loader_frei("training", 4, opt, device=dev),
            args.n, args.out_dir)
    except (FileNotFoundError, OSError):
        seen["FreiHAND"] = None
        print("== FreiHAND: no data, skipped")
    try:
        from scat_tpu_torch.data.ho3d import get_loader_ho3d
        seen["HO3D"] = check(
            "HO3D", get_loader_ho3d("training", 4, opt, device=dev),
            args.n, args.out_dir)
    except (FileNotFoundError, OSError):
        seen["HO3D"] = None
        print("== HO3D: no data, skipped")
    return seen


if __name__ == "__main__":
    main()
