"""Fused bias add + leaky ReLU + gain: the CUDA C++ kernels
(``csrc/fused_act.cu``, forward and backward) and their plain PyTorch
versions.

Replaces ``psld_tpu/ops/fused_act.py::_fwd_kernel`` and ``_bwd_kernel``
(launched by ``_run_elementwise``): ``y = leaky_relu(x + bias[c], slope)
* scale`` on the last axis of an NHWC (or any ``(..., C)``) tensor. No
model of either package calls it; it is the fused epilogue of
StyleGAN2-style networks. The source note in ``csrc/fused_act.cu`` says
what bounds the kernels on the H100 and how they are laid out.

Rounding is the JAX package's. There ``slope`` and ``scale`` are weakly
typed Python floats: on a bf16 tensor they become bf16 before use (0.2 ->
0.2001953125, sqrt(2) -> 1.4140625), and every op rounds its result:
``x + b``, then ``* slope``, then ``* scale``. The backward's negative
factor is ``slope * scale`` formed in Python float64 first, then cast.
PyTorch would multiply a bf16 tensor by a Python float in f32 and round
once, so the plain version multiplies by 0-dim tensors of x's dtype, and
the kernels take the constants rounded on the host. ``dbias`` is the sum
of ``dx`` over every axis but the last, in f32, rounded to dx's dtype and
then cast to the bias's, outside the kernel as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from psld_tpu_torch.kernels import build

SQRT2 = 2 ** 0.5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX's weak typing rounds a Python
    float that meets a tensor of that dtype."""
    return float(torch.tensor(value, dtype=dtype))


def _const(value: float, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype, filled on its
    device (no copy from the host, so a CUDA graph can capture it)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _bias_of(x, bias):
    return bias.to(x.dtype).reshape((1,) * (x.ndim - 1) + (-1,))


def _dbias(dx, bias):
    """The sum of ``dx`` over every axis but the last, in f32, rounded to
    dx's dtype, in the bias's dtype."""
    dims = tuple(range(dx.ndim - 1))
    return dx.float().sum(dim=dims).to(dx.dtype).to(bias.dtype)


def fused_leaky_relu_plain(x, bias, slope: float = 0.2,
                           scale: float = SQRT2):
    """``where(y >= 0, y, y * slope) * scale`` with ``y = x + bias``,
    every op rounded to x's dtype."""
    y = x + _bias_of(x, bias)
    return torch.where(y >= 0, y, y * _const(slope, y)) * _const(scale, y)


def fused_leaky_relu_backward_plain(x, bias, g, slope: float = 0.2,
                                    scale: float = SQRT2,
                                    need_dbias: bool = True):
    """(dx, dbias) at cotangent ``g``: ``dx = g * (scale or slope *
    scale)`` by the sign of ``x + bias`` (``dbias`` None unless
    ``need_dbias``)."""
    y = x + _bias_of(x, bias)
    dx = g * torch.where(y >= 0, _const(scale, g), _const(slope * scale, g))
    return dx, _dbias(dx, bias) if need_dbias else None


def _lib():
    lib = build.load("fused_act.cu")
    if lib.psld_fused_lrelu_fwd.argtypes is None:
        for fn, n_ptr in ((lib.psld_fused_lrelu_fwd, 3),
                          (lib.psld_fused_lrelu_bwd, 4)):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return lib


def _check(what: str, x, bias, g=None) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what} kernel takes f32/bf16, got {x.dtype}")
    if x.ndim < 1 or not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous (..., C) tensor")
    if bias.shape != (x.shape[-1],) or bias.device != x.device:
        raise ValueError(f"{what} kernel: bias must be (C,) on x's device")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype
                          or g.device != x.device or not g.is_contiguous()):
        raise ValueError(f"{what} kernel: the cotangent must be contiguous "
                         "of x's shape, dtype and device")


def _launch(name: str, x, bias, g, a: float, b: float):
    c = x.shape[-1]
    lib = _lib()
    out = torch.empty_like(x)
    b_t = bias.to(x.dtype).contiguous()
    ptrs = [x.data_ptr(), b_t.data_ptr()]
    if g is not None:
        ptrs.append(g.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*ptrs, out.data_ptr(), x.numel() // c, c,
                                 _rounded(a, x.dtype), _rounded(b, x.dtype),
                                 _DTYPE_CODE[x.dtype], stream)
    build.check(lib, err, f"{name} launch")
    return out


def fused_leaky_relu_backward(x, bias, g, slope: float = 0.2,
                              scale: float = SQRT2, need_dbias: bool = True):
    """(dx, dbias) of :func:`fused_leaky_relu` at cotangent ``g``
    (``dbias`` None unless ``need_dbias``).

    A CPU tensor runs :func:`fused_leaky_relu_backward_plain`. A CUDA
    tensor launches the backward kernel
    (``fused_leaky_relu_backward.launches`` counts the launches) or raises
    on what the kernel does not take."""
    if x.device.type == "cpu":
        return fused_leaky_relu_backward_plain(x, bias, g, slope, scale,
                                               need_dbias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu_backward: no path for device "
                         f"{x.device}")
    _check("fused_leaky_relu_backward", x, bias, g)
    if x.numel() == 0:
        dx = torch.empty_like(x)
    else:
        dx = _launch("psld_fused_lrelu_bwd", x, bias, g, scale,
                     slope * scale)
        fused_leaky_relu_backward.launches += 1
    return dx, _dbias(dx, bias) if need_dbias else None


fused_leaky_relu_backward.launches = 0


def _forward(x, bias, slope, scale):
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, slope, scale)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch("psld_fused_lrelu_fwd", x, bias, None, slope, scale)
    fused_leaky_relu.launches += 1
    return out


class _FusedLeakyReLU(torch.autograd.Function):
    """The JAX package's custom VJP: saves x and bias; the backward
    recomputes the sign of x + bias. On the CPU both directions run the
    plain versions, on CUDA the kernels."""

    @staticmethod
    def forward(ctx, x, bias, slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.args = (slope, scale)
        return _forward(x, bias, slope, scale)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx, db = fused_leaky_relu_backward(
            x, bias, g.contiguous(), *ctx.args,
            need_dbias=ctx.needs_input_grad[1])
        return dx, db, None, None


def fused_leaky_relu(x, bias, slope: float = 0.2, scale: float = SQRT2):
    """``leaky_relu(x + bias[channel], slope) * scale`` on the last axis,
    differentiable in x and bias, with the JAX package's gradient
    (:func:`fused_leaky_relu_backward`).

    A CPU tensor runs :func:`fused_leaky_relu_plain`. A CUDA tensor
    launches the forward kernel (``fused_leaky_relu.launches`` counts the
    launches), and its gradient the backward kernel, or raises on what
    the kernels do not take."""
    if x.device.type == "cuda":
        _check("fused_leaky_relu", x, bias)
    elif x.device.type != "cpu":
        raise ValueError(f"fused_leaky_relu: no path for device {x.device}")
    return _FusedLeakyReLU.apply(x, bias, float(slope), float(scale))


fused_leaky_relu.launches = 0
