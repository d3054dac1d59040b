"""Build the port's native sources at first use; load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, built by nvcc) or
``csrc/<name>.cpp`` (host C++, built by g++) exposes plain C entry points
and is compiled on its own into ``_build/lib<name>-<hash>.so``, where the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source or header rebuilds and an unchanged one is reused. Nothing
here includes PyTorch's headers: a plain C interface builds in seconds. A
build writes a temporary file and renames it
into place, so processes that build the same library at once (test
workers) never load a half-written one. The build runs when a library is
first used, never at import, so machines without the CUDA toolkit import
the package fine.
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
# Portable flags: a library built on one host stays loadable on another.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                       "the CUDA toolkit (set CUDA_HOME)")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host library "
                           "(csrc/host_kernels.cpp) builds with g++")
    return gxx


def _source(name: str) -> tuple[str, list]:
    """(source path, compiler command without -o) for csrc/<name>.*"""
    cu = os.path.join(CSRC_DIR, name + ".cu")
    if os.path.exists(cu):
        return cu, [_nvcc(), *NVCC_FLAGS]
    cpp = os.path.join(CSRC_DIR, name + ".cpp")
    if os.path.exists(cpp):
        return cpp, [_gxx(), *GXX_FLAGS]
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def source_digest(src: str, flags) -> str:
    """The build hash of *src*: its text, every ``*.cuh`` header beside it
    (a CUDA source may include any of them) and the compiler *flags*."""
    h = hashlib.sha256()
    folder = os.path.dirname(src)
    headers = sorted(f for f in os.listdir(folder) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(folder, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Path of the built library for csrc/<name>.cu or .cpp (built if
    missing)."""
    src, cmd = _source(name)
    digest = source_digest(src, cmd[1:])
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([*cmd, "-o", tmp, src], capture_output=True,
                             text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed on "
                               f"{src}:\n{res.stdout}{res.stderr}")
        with open(lib[:-3] + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_log(name: str) -> str:
    """The compiler's output for *name* (for a CUDA source, ptxas's
    register, shared-memory and spill report)."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu or .cpp."""
    return ctypes.CDLL(library_path(name))
