"""ctypes glue to the repo's native host input pipeline,
``native/scat_native.cpp`` (the port's own copy of
``scat_tpu/data/native_loader.py``): libjpeg/libpng decode, an optional
motion blur, the fused affine warp and the normalisation in a C++ thread
pool, on the host, beside the card's work.

The library is built with g++ at first use (never at import) into
``build/scat_tpu_torch/`` beside the package, or the per-user cache for
a read-only install (``kernels/build.build_dir``), under a name keyed by
a hash of the source, so an edited source is rebuilt.  Where it cannot
be built (no g++, no libjpeg or libpng headers), ``available()`` is
False and the loaders decode with PIL instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

from scat_tpu_torch.kernels.build import PKG_DIR, build_dir

# the C++ source: a checkout's native/, else the copy a wheel of the JAX
# package carries (setup.py BuildPyWithData)
SOURCE_CANDIDATES = (
    os.path.join(os.path.dirname(PKG_DIR), "native", "scat_native.cpp"),
    os.path.join(os.path.dirname(PKG_DIR), "scat_tpu", "_native",
                 "scat_native.cpp"))
# the JAX package's recipe (native/build.sh): generic x86-64, no
# -march=native, since the library may outlive the machine that built it
CXX_CMD = ("g++", "-O3", "-fPIC", "-shared", "-std=c++17")
CXX_LIBS = ("-ljpeg", "-lpng", "-lpthread")


def source_path() -> Optional[str]:
    return next((p for p in SOURCE_CANDIDATES if os.path.exists(p)), None)


def library_path(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_CMD).encode())
    return os.path.join(build_dir(),
                        f"libscat_native-{digest.hexdigest()[:16]}.so")


def _compile(src: str, out: str) -> bool:
    """g++ into a process-unique temporary, then an atomic rename, so a
    concurrent process never maps a half-written library.  False, with
    the reason printed, when it cannot be built."""
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([*CXX_CMD, src, "-o", tmp, *CXX_LIBS], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except subprocess.CalledProcessError as e:
        tail = (e.stderr or b"").decode(errors="replace")[-300:]
        print(f"[native] build failed, decoding with PIL: {tail}")
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"[native] cannot build ({e}); decoding with PIL")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    int_p = ctypes.POINTER(ctypes.c_int)
    float_p = ctypes.POINTER(ctypes.c_float)
    lib.scat_load_batch_aug.restype = ctypes.c_int
    lib.scat_load_batch_aug.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, float_p, float_p, ctypes.c_int, ctypes.c_int, int_p,
        int_p, int_p]
    return lib


@functools.lru_cache(maxsize=None)
def native_library() -> Optional[ctypes.CDLL]:
    """The library, built first if needed; None where it cannot be
    built or loaded."""
    src = source_path()
    if src is None:
        print("[native] native/scat_native.cpp not found; decoding with PIL")
        return None
    path = library_path(src)
    if not os.path.exists(path) and not _compile(src, path):
        return None
    try:
        return _bind(ctypes.CDLL(path))
    except (OSError, AttributeError) as e:
        print(f"[native] cannot load {path} ({e}); decoding with PIL")
        return None


def available() -> bool:
    return native_library() is not None


def load_batch(paths: Sequence[str], height: int, width: int,
               M_inv: np.ndarray, oh: int = 224, ow: int = 224,
               blur_ksize: Optional[np.ndarray] = None,
               blur_axis: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, (blur,) warp and normalise a batch in the thread pool.

    ``blur_ksize``/``blur_axis`` [N] int: an optional per-image motion
    blur of the whole frame before the warp (ksize <= 1: none; axis 0
    vertical, 1 horizontal; the reference's per-sample draw,
    load_STB.py:266-268).  Returns (images [N,oh,ow,3] float32 in
    [-1, 1], valid [N] float32): a failed decode comes back all -1 with
    valid 0 (the reference's empty-crop filter, train.py:143-150).

    Sizes below 2 are refused: the C++ blur reflects a 1-pixel-wide
    image out of bounds for even kernel sizes."""
    if min(height, width, oh, ow) < 2:
        raise ValueError(
            f"load_batch needs frames and outputs of at least 2x2 pixels, "
            f"got {height}x{width} -> {oh}x{ow}")
    lib = native_library()
    if lib is None:
        raise RuntimeError("the native library is not available")
    n = len(paths)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    Minv = np.ascontiguousarray(M_inv, np.float32).reshape(n, 6)
    out = np.empty((n, oh, ow, 3), np.float32)
    status = np.empty((n,), np.int32)
    int_p = ctypes.POINTER(ctypes.c_int)
    ks_p = ax_p = ctypes.cast(None, int_p)
    if blur_ksize is not None:
        ks = np.ascontiguousarray(blur_ksize, np.int32)
        ax = np.ascontiguousarray(
            np.zeros(n) if blur_axis is None else blur_axis, np.int32)
        ks_p, ax_p = ks.ctypes.data_as(int_p), ax.ctypes.data_as(int_p)
    lib.scat_load_batch_aug(
        names, n, height, width,
        Minv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), oh, ow,
        status.ctypes.data_as(int_p), ks_p, ax_p)
    return out, (status == 0).astype(np.float32)
