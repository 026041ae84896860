"""Single-head attention: the CUDA C++ kernel (``csrc/attention.cu``) and
its plain PyTorch version.

Replaces ``psld_tpu/ops/attention.py::_attn_kernel`` (launched by
``_pallas_attention``). The source note in ``csrc/attention.cu`` says what
bounds the kernel on the H100 and how it streams K and V past the shared
memory limit. ``_lane_pad`` is a TPU-lane detail and has no counterpart:
the kernel takes any C that is a multiple of 8.

The gradient follows ``_attention_bwd`` of the JAX package, which is no
kernel either: the autograd Function saves q, k and v only, recomputes
the probability matrix and pulls the cotangent back through the float32
einsum chain (:func:`attention_backward`). Those products lie outside any
kernel in the JAX package too and stay ``torch.einsum``.
"""

from __future__ import annotations

import ctypes

import torch

from psld_tpu_torch.kernels import build

MAX_N = 256
MAX_C = 512
MAX_B = 65535
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_fits(shape, dtype) -> bool:
    """Whether the kernel takes (B, N, C) q, k and v of ``shape`` and
    ``dtype``: f32 or bf16, N at most 256, C a multiple of 8 up to 512, B
    at most 65,535. Contiguity and 16-byte alignment are the caller's:
    :func:`attention` raises on them. ``models.layers.AttnBlock`` runs
    :func:`attention_plain` where this is False, as the JAX package's
    ``fused_attention`` runs its einsum chain where its Pallas kernel does
    not fit."""
    if dtype not in _DTYPE_CODE or len(shape) != 3:
        return False
    b, n, c = shape
    return 1 <= n <= MAX_N and 8 <= c <= MAX_C and c % 8 == 0 \
        and 1 <= b <= MAX_B


def attention_plain(q, k, v, scale: float):
    """(B, N, C) attention as the reference einsum chain: f32 scores,
    softmax in f32, P (f32) times v upcast to f32, cast to q's dtype."""
    w = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * scale
    w = torch.softmax(w, dim=-1)
    return torch.einsum("bqk,bkc->bqc", w, v.float()).to(q.dtype)


def attention_backward(q, k, v, scale: float, g,
                       need=(True, True, True)):
    """(dq, dk, dv) of :func:`attention_plain` at cotangent ``g``: P is
    recomputed, then dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP *
    P)), dQ = dS K * scale, dK = dS^T Q * scale, all in float32, cast to
    the inputs' dtype at the end. A gradient whose ``need`` entry is
    False is not computed and comes back as None."""
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("bqc,bkc->bqk", q32, k32) * scale, dim=-1)
    dq = dk = dv = None
    if need[2]:
        dv = torch.einsum("bqk,bqc->bkc", p, g32).to(v.dtype)
    if need[0] or need[1]:
        dp = torch.einsum("bqc,bkc->bqk", g32, v32)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        if need[0]:
            dq = (torch.einsum("bqk,bkc->bqc", ds, k32) * scale).to(q.dtype)
        if need[1]:
            dk = (torch.einsum("bqk,bqc->bkc", ds, q32) * scale).to(k.dtype)
    return dq, dk, dv


def _lib():
    lib = build.load("attention.cu")
    fn = lib.psld_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def _launch(q, k, v, scale: float):
    b, n, c = q.shape
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


class _Attention(torch.autograd.Function):
    """Forward kernel; saves q, k, v and recomputes P in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return (*attention_backward(*ctx.saved_tensors, ctx.scale, g,
                                    need=ctx.needs_input_grad[:3]), None)


def attention(q, k, v, scale: float):
    """(B, N, C) -> (B, N, C) softmax(q k^T * scale) v, differentiable in
    q, k and v.

    A CPU tensor runs :func:`attention_plain`. A CUDA tensor launches the
    kernel (``attention.launches`` counts the calls) or raises on what the
    kernel does not take."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no path for device {q.device}")
    _check_kernel_args(q, k, v)
    return _Attention.apply(q, k, v, float(scale))


attention.launches = 0


def _check_kernel_args(q, k, v) -> None:
    """Raise on what the kernel does not take: ``attention_fits``'s shapes
    and dtypes, and q, k, v alike, contiguous, on 16-byte boundaries."""
    for t in (q, k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("attention kernel: q, k, v must share shape, "
                             "dtype and device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention kernel needs contiguous (B, N, C) "
                             "tensors on 16-byte boundaries")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention kernel: dtype {q.dtype} unsupported")
    if not attention_fits(q.shape, q.dtype):
        raise ValueError(f"attention kernel takes N <= {MAX_N} and C a "
                         f"multiple of 8 up to {MAX_C}; got "
                         f"{tuple(q.shape)}")
