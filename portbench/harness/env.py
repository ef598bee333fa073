"""Paths of the checkout and the fixed cache directories inside it.

``prepare()`` runs before ``torch`` is imported: every build or kernel
cache the program or PyTorch could write (the port's nvcc libraries,
Triton's and Inductor's caches) goes to a fixed directory under the
checkout's ``build/``, which ``.gitignore`` lists, so that only the
first run of a cell in a checkout builds anything."""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)            # <checkout>/portbench
ROOT = os.path.dirname(BENCH_DIR)            # the checkout
BUILD = os.path.join(ROOT, "build")
# the port builds its libraries here itself (kernels/build.py BUILD_DIR)
CACHES = {
    "TRITON_CACHE_DIR": os.path.join(BUILD, "triton"),
    "TORCHINDUCTOR_CACHE_DIR": os.path.join(BUILD, "inductor"),
    "TORCH_EXTENSIONS_DIR": os.path.join(BUILD, "torch_extensions"),
}
ARTIFACTS = os.path.join(BUILD, "portbench", "artifacts")
# what the process must not hold once the window has closed: JAX and the
# JAX package, compared by whole top-level module name (the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "scat_tpu")


def prepare() -> None:
    """Fix the cache directories, keep the process to one CPU thread of
    its own work (the host's cores are shared, and a pool of spinning
    threads made the host-paced cells' runs spread), and make the
    checkout importable."""
    os.environ.update(CACHES)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (from /proc where it exists;
    else since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        import time
        return time.perf_counter() - _IMPORTED


def _now() -> float:
    import time
    return time.perf_counter()


_IMPORTED = _now()
