"""Checkpoint conversion CLI (port of ``scat_tpu/convert.py``): a port
train state, or any reference-keyed ``.pth``, to a bare reference-keyed
``.pth`` that the reference loads with ``net.load_state_dict``.

    python -m scat_tpu_torch.convert --direction to_pth \\
        --net reg_transformer \\
        --checkpoint_path_eval experiments/run1/hand_net_final.pth \\
        --convert_out hand_net_final_bare.pth

The file is read through ``utils/checkpoint.load_weights`` (the JAX
package's partial-load semantics: a partial merge warns, no match
raises) into the model of the model flags (``--net``, ``--vit_depth``,
``--vit_heads``, ``--iteration`` ...), which must match the checkpoint.

``--direction to_orbax`` writes the JAX package's orbax train state,
which needs orbax; the port does not import it, so it refuses and names
``scat-convert --direction to_orbax``, which reads the port's ``.pth``
as it is (its ``restore_variables_nonstrict`` loads reference-keyed
files).  The conversion runs on the CPU: it moves weights, no compute.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn

from scat_tpu_torch.config import Options
from scat_tpu_torch.utils import checkpoint as ckpt_lib

TO_ORBAX = ("--direction to_orbax writes the JAX package's orbax train "
            "state, which the port does not import; run `scat-convert "
            "--direction to_orbax --checkpoint_path_eval <this .pth> ...` "
            "from the JAX package, which reads the port's .pth as it is")


def state_dict_for_net(net: str, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Reference-keyed CPU state_dict of ``model``, built for ``--net
    net``: the port's modules keep the reference's names, so this is
    their state_dict; the positional-encoding buffer that the reference
    registers is the one key the port recomputes and leaves out, as the
    JAX package's export does."""
    from scat_tpu_torch.models.factory import NETS
    if net not in NETS:
        raise ValueError(f"no torch interchange for --net {net!r}")
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k != ckpt_lib.PE_KEY}


def to_pth(opt: Options, out_path: str, image_size: int = 224) -> int:
    """``opt.checkpoint_path_eval`` (a port train state or any ``.pth``)
    -> a bare reference-keyed ``.pth`` at ``out_path``; returns the
    tensor count."""
    from scat_tpu_torch.models import build_model

    if not os.path.exists(os.path.abspath(opt.checkpoint_path_eval)):
        # the loader would fall back to a fresh init, and that would be
        # converted to a .pth
        raise FileNotFoundError(
            f"--checkpoint_path_eval {opt.checkpoint_path_eval!r} "
            "does not exist")
    model, _ = build_model(opt, image_size)
    ckpt_lib.load_weights(model, opt.checkpoint_path_eval, seed=opt.seed)
    sd = state_dict_for_net(opt.net, model)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save(sd, out_path)
    return len(sd)


def main(argv=None) -> None:
    import argparse
    import sys

    from scat_tpu_torch.config import BaseOptions

    peel = argparse.ArgumentParser(add_help=False)
    peel.add_argument("--direction", required=True,
                      choices=("to_pth", "to_orbax"))
    peel.add_argument("--convert_out", required=True,
                      help="output .pth path")
    conv_opt, rest = peel.parse_known_args(
        sys.argv[1:] if argv is None else argv)
    if conv_opt.direction == "to_orbax":
        raise SystemExit(TO_ORBAX)
    opt = BaseOptions().parse(rest)
    n = to_pth(opt, conv_opt.convert_out)
    print(f"wrote {n} tensors -> {conv_opt.convert_out}")


if __name__ == "__main__":
    main()
