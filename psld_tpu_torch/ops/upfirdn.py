"""FIR up/down-sampling as grouped PyTorch convolutions
(``psld_tpu/ops/upfirdn.py``).

The JAX package expresses these as XLA convolutions, not Pallas kernels,
so plain ``F.conv2d`` / ``F.conv_transpose2d`` are their counterparts
here. Semantics are those of ``upfirdn2d_native`` in the reference
(``tests/oracles.py::upfirdn2d_oracle``): zero-stuff by ``up`` (trailing
zeros kept), pad (negative pads crop), TRUE convolution with the 2D
kernel, stride by ``down``; the kernel is applied depthwise.

Public functions take NHWC tensors and OIHW conv weights. Their NCHW view
is a free permute of NHWC memory, so a network that keeps its activations
``channels_last`` pays no copy on either side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def setup_kernel(k) -> np.ndarray:
    """Normalize a 1D (separable) or 2D FIR kernel."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= k.sum()
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be square, got {k.shape}")
    return k


@functools.lru_cache(maxsize=64)
def _depthwise_cached(kbytes: bytes, kh: int, c: int, dtype, device):
    # a plain tensor even when first asked for under inference_mode
    with torch.inference_mode(False):
        k = torch.from_numpy(
            np.frombuffer(kbytes, np.float32).reshape(kh, kh).copy())
        k = k.to(device=device, dtype=dtype)
        return k.expand(c, 1, kh, kh).contiguous(
            memory_format=torch.channels_last)


def _depthwise(kernel, c: int, like: torch.Tensor) -> torch.Tensor:
    """The (C, 1, kh, kw) depthwise weight of a FIR kernel, on ``like``'s
    device and dtype; cached, so a forward on the card copies no kernel
    from the host."""
    k = np.ascontiguousarray(kernel, dtype=np.float32)
    return _depthwise_cached(k.tobytes(), k.shape[0], c, like.dtype,
                             like.device)


def _upfirdn2d_nchw(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """:func:`upfirdn2d` on an NCHW-logical tensor."""
    c = x.shape[1]
    kh = int(np.asarray(kernel).shape[0])
    if up > 1:
        # conv_transpose2d with the UNFLIPPED kernel is the true
        # convolution of the zero-stuffed input: y[j] = sum_i x[i]
        # k[j + p - up*i]; p and output_padding place the upfirdn window
        p = kh - 1 - pad[0]
        op = up + pad[1] - pad[0] - 1
        if p < 0 or not 0 <= op < up:
            raise ValueError(f"upfirdn2d: pad {pad} unsupported for "
                             f"up={up}, kernel {kh}")
        y = F.conv_transpose2d(x, _depthwise(kernel, c, x), stride=up,
                               padding=p, output_padding=op, groups=c)
        return y[:, :, ::down, ::down] if down > 1 else y
    y = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    kflip = np.ascontiguousarray(np.asarray(kernel)[::-1, ::-1])
    return F.conv2d(y, _depthwise(kflip, c, x), stride=down, groups=c)


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """Upsample-FIR-downsample, NHWC, same kernel for every channel."""
    return _upfirdn2d_nchw(x.permute(0, 3, 1, 2), kernel, up, down,
                           pad).permute(0, 2, 3, 1)


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample, NHWC."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, 1, w, 1, c).expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Mean-pool downsample, NHWC."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    return x.mean(dim=(2, 4))


def _up_kernel(k, factor: int, gain: float):
    if k is None:
        k = [1.0] * factor
    return setup_kernel(k) * (gain * factor**2)


def _down_kernel(k, factor: int, gain: float):
    if k is None:
        k = [1.0] * factor
    return setup_kernel(k) * gain


def upsample_2d_nchw(x, k=None, factor: int = 2, gain: float = 1.0):
    k = _up_kernel(k, factor, gain)
    p = k.shape[0] - factor
    return _upfirdn2d_nchw(x, k, up=factor,
                           pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d_nchw(x, k=None, factor: int = 2, gain: float = 1.0):
    k = _down_kernel(k, factor, gain)
    p = k.shape[0] - factor
    return _upfirdn2d_nchw(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d_nchw(x, w, k=None, factor: int = 2, gain: float = 1.0):
    """Stride-``factor`` transposed conv, then FIR. ``w`` is OIHW.

    The JAX package cross-correlates the zero-stuffed input with ``w``;
    ``conv_transpose2d`` with the spatially flipped, (I, O)-transposed
    weight is that same product."""
    kh = w.shape[-1]
    k = _up_kernel(k, factor, gain)
    p = (k.shape[0] - factor) - (kh - 1)
    wt = w.to(x.dtype).transpose(0, 1).flip((2, 3))
    y = F.conv_transpose2d(x, wt, stride=factor)
    return _upfirdn2d_nchw(y, k, pad=((p + 1) // 2 + factor - 1,
                                      p // 2 + 1))


def conv_downsample_2d_nchw(x, w, k=None, factor: int = 2,
                            gain: float = 1.0):
    """FIR, then a stride-``factor`` VALID conv. ``w`` is OIHW."""
    kh = w.shape[-1]
    k = _down_kernel(k, factor, gain)
    p = (k.shape[0] - factor) + (kh - 1)
    y = _upfirdn2d_nchw(x, k, pad=((p + 1) // 2, p // 2))
    return F.conv2d(y, w.to(x.dtype), stride=factor)


def _nhwc(fn):
    def wrapped(x, *args, **kwargs):
        return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)

    wrapped.__name__ = fn.__name__.replace("_nchw", "")
    wrapped.__doc__ = f"NHWC form of :func:`{fn.__name__}`."
    return wrapped


upsample_2d = _nhwc(upsample_2d_nchw)
downsample_2d = _nhwc(downsample_2d_nchw)
upsample_conv_2d = _nhwc(upsample_conv_2d_nchw)
conv_downsample_2d = _nhwc(conv_downsample_2d_nchw)
