"""Flag-compatible configuration surface (the port's own copy of
``scat_tpu/config.py``).

The same ``Options`` fields and the same ``BaseOptions`` argparse front
end as the JAX package, so one flag line (``--net reg_transformer
--vit_heads 8 --iteration 3 ...``, reference ``script/ablation_pose.sh``)
configures both.  Booleans parse properly (``--pos_embed False`` is
False); ``--compat_argparse_bool`` restores the reference's truthy
``type=bool`` parsing.

Fields the port does not read yet (mesh, FSDP, FAVOR+ and training
options) are kept so that every flag line of the JAX package still
parses; each is read by the slice that ports its feature.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def _compat_bool(v) -> bool:
    """Reference ``type=bool`` semantics: truthiness of the raw string."""
    return bool(v)


@dataclasses.dataclass
class Options:
    """Typed view of the option namespace (reference ``config.py:9-67``
    plus the JAX package's extensions)."""

    # checkpointing
    resume: bool = False
    checkpoint_hand: str = "hand_net.pth"
    checkpoint_folder: str = "experiments/0131_224_smplx"

    # MANO mean shape: palm vs back-of-hand template vertices
    outside: bool = True

    # ViT options
    net: str = "ViT"
    vit_dim: int = 256
    vit_depth: int = 3
    vit_heads: int = 8
    vit_mlp_dim: int = 512
    vit_dropout: float = 0.0

    # dead in the reference; accepted for flag compatibility
    feature: str = "x2"

    # visualization
    debug_img: str = "single"
    debug: bool = True

    # train options
    batch_size: int = 32
    lr: float = 1e-4
    epoch: int = 50
    iteration: int = 1
    stage: int = 1
    order: str = "SMPLX"  # dead in the reference
    hand_choice: str = "mano"
    smplx_model_path: str = "extra_data/SMPLX_NEUTRAL.pkl"
    mean_mano_param: str = "extra_data/mean_mano_params.pkl"
    smplx_hand_info_file: str = "extra_data/SMPLX_HAND_INFO.pkl"
    right_hand_model: str = "extra_data/MANO_RIGHT.pkl"
    use_heatmap: bool = False
    freeze: bool = False

    # ablations
    mask_rate: float = 0.0
    pos_embed: bool = True
    pl_reg: bool = False

    # loss weights
    l_weight_3d: float = 0.0
    l_weight_2d: float = 0.0

    # data augmentation
    motion_blur: bool = False
    rotation: bool = False

    # eval options
    eval_dataset: str = "STB"
    result_dir: str = "./output/eval_0219/"
    checkpoint_path_eval: str = "experiments/0207_iccv_1/hand_net_final.pth"

    # extensions of the JAX package (no reference equivalent)
    mesh_shape: str = "data:-1"
    param_dtype: str = "float32"
    # backbone / conv1x1 / transformer compute dtype; the regressor and
    # the projection stay float32
    compute_dtype: str = "bfloat16"
    # flagship attention through the hand-written kernel
    # (ops/attention.py); False takes the plain PyTorch version
    use_pallas_attention: bool = True
    # --net ViP's FAVOR+ through the hand-written kernels (ops/favor.py);
    # False takes the plain PyTorch version, as in the JAX package
    use_pallas_favor: bool = False
    favor_precision: str = "highest"
    remat_blocks: bool = False
    norm_layer: str = "batch"
    seed: int = 0
    steps_per_epoch: int = 0
    log_every: int = 10
    checkpoint_every_epochs: int = 10
    data_dir: str = "./STB/"
    synthetic_data: bool = False
    synthetic_layout: str = "stb"
    pretrained_resnet_pth: str = ""
    compat_argparse_bool: bool = False
    compat_pl_ema_reset: bool = True
    compat_pck_flat: bool = True
    donate_state: bool = True
    grad_accum: int = 1
    param_sharding: str = "replicated"
    export_dir: str = "./export/scat"
    profile_trace_dir: str = ""
    profile_trace_steps: int = 20
    tensorboard: bool = False


_BOOL_FIELDS = (
    "resume", "outside", "use_heatmap", "freeze", "debug", "pos_embed",
    "pl_reg", "motion_blur", "rotation",
    "use_pallas_attention", "use_pallas_favor", "remat_blocks",
    "synthetic_data", "tensorboard", "compat_argparse_bool",
    "compat_pl_ema_reset", "compat_pck_flat", "donate_state",
)


class BaseOptions:
    """Argparse front end with reference flag parity."""

    def __init__(self, compat_argparse_bool: bool = False):
        parser = argparse.ArgumentParser(
            description="scat_tpu_torch: SCAT hand pose in PyTorch")
        bool_type = _compat_bool if compat_argparse_bool else str2bool
        defaults = Options()
        for f in dataclasses.fields(Options):
            name = f.name
            default = getattr(defaults, name)
            if name in _BOOL_FIELDS:
                parser.add_argument(f"--{name}", type=bool_type,
                                    default=default)
            elif f.type in ("int", int):
                parser.add_argument(f"--{name}", type=int, default=default)
            elif f.type in ("float", float):
                parser.add_argument(f"--{name}", type=float, default=default)
            else:
                parser.add_argument(f"--{name}", type=str, default=default)
        self.parser = parser

    def parse(self, argv: Optional[Sequence[str]] = None) -> Options:
        # two passes: --compat_argparse_bool switches the boolean parser
        # to the reference's truthy-string semantics before the real parse
        raw = list(sys.argv[1:] if argv is None else argv)
        if any(a.split("=")[0] == "--compat_argparse_bool" for a in raw):
            probe = argparse.ArgumentParser(add_help=False)
            probe.add_argument("--compat_argparse_bool", type=str2bool,
                               default=False)
            peek, _ = probe.parse_known_args(raw)
            if peek.compat_argparse_bool:
                self.__init__(compat_argparse_bool=True)
        ns = self.parser.parse_args(argv)
        return Options(**vars(ns))

    def parse_jupyter(self) -> Options:
        return self.parse([])
