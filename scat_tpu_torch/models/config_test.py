"""The option surface of module-level smoke runs (the port's own copy of
``scat_tpu/models/config_test.py``).

Reference models/config_test.py:4-76 is a near-duplicate of the main
``BaseOptions`` used by ``__main__`` blocks, with other defaults
(``vit_heads=4`` at :21, ``pos_embed=False`` at :50).  Here it is the
one ``Options`` dataclass with those defaults applied where the flag is
not given.
"""

from __future__ import annotations

import dataclasses
import sys

from scat_tpu_torch.config import BaseOptions as _BaseOptions, Options

TWIN_DEFAULTS = {"vit_heads": 4, "pos_embed": False}


class BaseOptions(_BaseOptions):
    """Smoke-run options (reference config_test.py defaults)."""

    def parse(self, argv=None) -> Options:
        opt = super().parse(argv)
        raw = sys.argv[1:] if argv is None else argv
        for flag, default in TWIN_DEFAULTS.items():
            if not any(a.split("=")[0] == f"--{flag}" for a in raw):
                opt = dataclasses.replace(opt, **{flag: default})
        return opt
