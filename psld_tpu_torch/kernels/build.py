"""Build and load the port's CUDA C++ kernels.

A ``psld_tpu_torch/csrc/<name>.cu`` file is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
and loaded with ``ctypes``. A library's file name carries a hash of its
source, of the local headers it includes (``#include "<name>.cuh"``
from ``csrc/``) and of the flags, so an edited source or header is
rebuilt and a stale library never loads. No kernel needs `libcuda` at
link time, so nothing links beyond the CUDA runtime. The build directory is ``<repo>/build/kernels``,
which ``.gitignore`` lists. :func:`build_all` starts one nvcc per source
at once, so a process that needs several libraries waits for the slowest
build only.

A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: str, seen=None) -> list:
    """``csrc/<src>`` and every local header it includes, transitively,
    each once, in the order first met."""
    seen = [] if seen is None else seen
    if src not in seen:
        seen.append(src)
        with open(os.path.join(CSRC, src), "rb") as f:
            for inc in _LOCAL_INCLUDE.findall(f.read()):
                if os.path.exists(os.path.join(CSRC, inc.decode())):
                    _sources(inc.decode(), seen)
    return seen


def _library(src: str) -> str:
    """The path of ``csrc/<src>``'s library for the current source, its
    local headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources(src):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build_all(srcs) -> dict:
    """Compile every ``csrc/<src>`` of ``srcs`` whose library is not
    current, one nvcc process per source, all started together; returns
    ``{src: library path}``. Raises with nvcc's output if one fails."""
    paths = {src: _library(src) for src in srcs}
    jobs = {}
    for src, path in paths.items():
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        jobs[src] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, proc) in jobs.items():
        build_logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, paths[src])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{src}:\n{build_logs[src]}" for src in failed))
    return paths


def build(src: str) -> str:
    """Compile ``csrc/<src>`` unless its library is current; returns the
    library's path."""
    return build_all([src])[src]


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
