"""Build and load the port's CUDA C++ kernels.

A ``psld_tpu_torch/csrc/<name>.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
and loaded with ``ctypes``. A library's file name carries a hash of its
source and of the flags, so an edited source is rebuilt and a stale
library never loads. The build directory is ``<repo>/build/kernels``,
which ``.gitignore`` lists.

A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
# ptxas register/shared-memory report of each build, for the smoke log
build_logs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def build(src: str) -> str:
    """Compile ``csrc/<src>`` unless its library is current; returns the
    library's path."""
    with open(os.path.join(CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                          os.path.join(CSRC, src)],
                         capture_output=True, text=True)
    build_logs[src] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{build_logs[src]}")
    os.replace(tmp, path)
    return path


def load(src: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<src>``, built if needed."""
    if src not in _libs:
        _libs[src] = ctypes.CDLL(build(src))
    return _libs[src]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        lib.psld_cuda_error_string.restype = ctypes.c_char_p
        lib.psld_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.psld_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
