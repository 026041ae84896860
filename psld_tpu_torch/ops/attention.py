"""Single-head attention: the CUDA C++ kernel (``csrc/attention.cu``) and
its plain PyTorch version.

Replaces ``psld_tpu/ops/attention.py::_attn_kernel`` (launched by
``_pallas_attention``). The source note in ``csrc/attention.cu`` says what
bounds the kernel on the H100 and how it streams K and V past the shared
memory limit. ``_lane_pad`` is a TPU-lane detail and has no counterpart:
the kernel takes any C that is a multiple of 8.
"""

from __future__ import annotations

import ctypes

import torch

from psld_tpu_torch.kernels import build

MAX_N = 256
MAX_C = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v, scale: float):
    """(B, N, C) attention as the reference einsum chain: f32 scores,
    softmax in f32, P (f32) times v upcast to f32, cast to q's dtype."""
    w = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * scale
    w = torch.softmax(w, dim=-1)
    return torch.einsum("bqk,bkc->bqc", w, v.float()).to(q.dtype)


def _lib():
    lib = build.load("attention.cu")
    fn = lib.psld_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def attention(q, k, v, scale: float):
    """(B, N, C) -> (B, N, C) softmax(q k^T * scale) v.

    A CPU tensor runs :func:`attention_plain`. A CUDA tensor launches the
    kernel (``attention.launches`` counts the calls) or raises on what the
    kernel does not take."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no path for device {q.device}")
    b, n, c = q.shape
    for t in (q, k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("attention kernel: q, k, v must share shape, "
                             "dtype and device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel needs contiguous (B, N, C) "
                             "tensors on 16-byte boundaries")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention kernel: dtype {q.dtype} unsupported")
    if not (1 <= n <= MAX_N and 8 <= c <= MAX_C and c % 8 == 0
            and 1 <= b <= 65535):
        raise ValueError(f"attention kernel takes N <= {MAX_N} and C a "
                         f"multiple of 8 up to {MAX_C}; got {(b, n, c)}")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.psld_attention_fwd(q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr(), b, n, c,
                                     float(scale), _DTYPE_CODE[q.dtype],
                                     stream)
    build.check(lib, err, "attention kernel launch")
    attention.launches += 1
    return out


attention.launches = 0
