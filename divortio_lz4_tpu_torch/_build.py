"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own into ``_build/lib<name>-<hash>.so``, where the hash covers the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here includes PyTorch's headers: a plain C interface builds
in seconds. The build runs when a kernel is first launched, never at
import, so machines without the CUDA toolkit import the package fine.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# sm_90a (not sm_90) keeps Hopper-only instructions available to later
# kernels; -Xptxas -v writes registers/shared memory/spills to the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                       "the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu (built if missing)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        text = f.read()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a temp file and rename: a concurrent loader never sees a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                               f"{res.stderr}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for *name*."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu."""
    return ctypes.CDLL(library_path(name))
