"""The port's native PNG codec (``psld_tpu/native``): ``pngio.cpp``,
multithreaded batch encoding of samples and decoding of image-folder
datasets, on the host.

The source is compiled with ``g++ -O2 -shared -fPIC -pthread -lz`` at
first use into ``<repo>/build/native`` (which ``.gitignore`` lists), under
a file name that carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library never loads. A failed build raises
with the compiler's output, and a failed decode raises: nothing falls
back to another reader. Valid PNGs the decoder does not take (16-bit,
interlaced, transparency chunks) raise :class:`UnsupportedPng`; the
datasets send such folders to Pillow before they decode
(``data/datasets.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
SOURCE = os.path.join(_HERE, "pngio.cpp")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
LIBS = ["-lz"]

_LOCK = threading.Lock()
_LIB = None


def _library() -> str:
    """The library's path for the current source and flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libpngio_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``pngio.cpp`` unless its library is current; returns the
    library's path. Raises with g++'s output if the build fails."""
    path = _library()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def _get_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        u8p, cp, i = (ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
                      ctypes.c_int)
        ip = ctypes.POINTER(ctypes.c_int)
        for name, args in (
                ("psld_write_png_batch",
                 [ctypes.POINTER(cp), u8p, i, i, i, i, i]),
                ("psld_read_png_info", [cp, ip, ip, ip]),
                ("psld_read_png_batch",
                 [ctypes.POINTER(cp), u8p, i, i, i, i, i])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _LIB = lib
        return _LIB


class UnsupportedPng(ValueError):
    """A valid PNG of a variant the decoder does not take (16-bit,
    interlaced, transparency chunks)."""


def _check_read(rc: int, path: str) -> None:
    if rc == 0:
        return
    if rc == -5:
        raise UnsupportedPng(path)
    if rc == -6:
        raise ValueError(f"png shape mismatch: {path}")
    raise OSError(f"native png read failed ({rc}): {path}")


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def read_png_info(path: str) -> tuple[int, int, int]:
    """(h, w, c) of the decoded image (a palette reports 3 channels)."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _get_lib().psld_read_png_info(
        path.encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    _check_read(rc, path)
    return h.value, w.value, c.value


def read_png_batch(paths: list[str], h: int, w: int, c: int,
                   threads: int = 0) -> np.ndarray:
    """Decode PNGs of shape (h, w, c) into an NHWC uint8 batch, in
    parallel (``threads`` 0: one a core)."""
    n = len(paths)
    out = np.empty((n, h, w, c), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = _get_lib().psld_read_png_batch(arr, _u8(out), n, h, w, c, threads)
    _check_read(rc, paths[0] if paths else "<empty>")
    return out


def write_png_batch(batch: np.ndarray, file_prefix: str,
                    threads: int = 0) -> None:
    """Write an NHWC (or NHW) uint8 batch as ``<file_prefix>_<i>.png``,
    in parallel."""
    batch = np.ascontiguousarray(batch, np.uint8)
    if batch.ndim == 3:
        batch = batch[..., None]
    n, h, w, c = batch.shape
    paths = [f"{file_prefix}_{i}.png".encode() for i in range(n)]
    arr = (ctypes.c_char_p * n)(*paths)
    rc = _get_lib().psld_write_png_batch(arr, _u8(batch), n, h, w, c,
                                         threads)
    if rc != 0:
        raise OSError(f"native batch png write failed ({rc})")
