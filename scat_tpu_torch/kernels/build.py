"""Compile the CUDA sources under ``scat_tpu_torch/csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, which ``ctypes`` loads: the source includes no
PyTorch header, so a build takes seconds.  Libraries go to
``build/scat_tpu_torch/<name>-<hash>.so`` beside the package, or, where
that is not writable (a wheel in site-packages), to the per-user cache
``~/.cache/scat_tpu_torch/``; the name is keyed by a hash of the source,
of every shared header ``csrc/*.cuh`` and of the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
``build_all`` starts one ``nvcc`` per source, all at once, and keeps
each compiler's output (``-Xptxas -v``: registers, shared memory and
spills of every kernel) in ``LOGS``.  Without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "scat_tpu_torch")
USER_CACHE_DIR = os.path.join("~", ".cache", "scat_tpu_torch")


def build_dir() -> str:
    """``BUILD_DIR`` where it can be written (or created), else the
    per-user cache: a read-only install still builds."""
    probe = BUILD_DIR
    while not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    if os.access(probe, os.W_OK):
        return BUILD_DIR
    return os.path.expanduser(USER_CACHE_DIR)
SOURCES = ("attention_fwd", "attention_bwd", "favor", "favor_bwd",
           "fused_link")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
        "the CUDA kernels of scat_tpu_torch are built from csrc/ with the "
        "CUDA toolkit")


# the compiler's output of each library this process built
LOGS: dict = {}


def headers() -> list:
    """The shared headers ``csrc/*.cuh`` every library's key hashes."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"), *headers()]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> int:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, all started together.  Returns how many were
    compiled; raises with the compiler's output if one fails."""
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return 0
    nvcc = nvcc_path()
    os.makedirs(build_dir(), exist_ok=True)
    procs = []
    for name in todo:
        # unique temporary name, then an atomic rename: concurrent
        # processes never load a half-written library
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        procs.append((name, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log = proc.communicate()[0]
        LOGS[name] = log
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return len(todo)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if needed)."""
    build_all((name,))
    return ctypes.CDLL(library_path(name))
