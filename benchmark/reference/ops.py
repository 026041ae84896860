"""The arithmetic the reference network is made of, behind one object, so
that the same forward runs exactly (:class:`Float32`), in the control's
lower precision (:class:`Float8`) or on the ``meta`` device to list its
calls (:class:`Recorder`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stuff(x, up: int):
    """Zero-stuff the height and width of NCHW ``x`` by ``up``, trailing
    zeros kept."""
    b, c, h, w = x.shape
    y = x.new_zeros(b, c, h * up, w * up)
    y[:, :, ::up, ::up] = x
    return y


class Float32:
    """Plain float32 PyTorch. TF32 must be off (:func:`exact_float32`)."""

    def conv2d(self, x, w, b=None, stride=1, padding=0, first=False):
        return F.conv2d(x, w, b, stride, padding)

    def conv_transpose2x(self, x, w):
        """The stride-2 transposed convolution of StyleGAN2's
        ``upsample_conv_2d``: the zero-stuffed input, padded by the
        kernel's reach, cross-correlated with ``w`` (OIHW)."""
        r = w.shape[-1] - 1
        y = F.pad(stuff(x, 2)[:, :, :-1, :-1], (r, r, r, r))
        return self.conv2d(y, w, None, 1, 0)

    def depthwise(self, x, k, stride=1, up=1):
        """A fixed FIR kernel ``k`` (kh, kw) on every channel of ``x``
        (cross-correlation, no padding); ``up``: x is zero-stuffed by it."""
        c = x.shape[1]
        w = k.to(x)[None, None].expand(c, 1, *k.shape)
        return F.conv2d(x, w, None, stride, 0, 1, c)

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def bmm(self, a, b):
        return torch.bmm(a, b)

    def group_norm(self, x, scale, bias, groups: int, eps: float):
        return F.group_norm(x, groups, scale, bias, eps)


def exact_float32() -> None:
    """Matrix products and convolutions in full float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round8(x):
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at the format's largest value), back in x's dtype."""
    scale = 448.0 / x.abs().amax().float().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Float8 storage both ways: the value rounded going forward, its
    gradient rounded going back."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g)


_fp8 = _Fp8.apply


class Float8(Float32):
    """The control: the network computed in float8 e4m3, the precision
    below the configurations' bfloat16. Every operand and every result of
    a convolution, a FIR filter, a matrix product and a GroupNorm is held
    in float8 (one scale a tensor; gradients too), the sums in float32."""

    def conv2d(self, x, w, b=None, stride=1, padding=0, first=False):
        return _fp8(F.conv2d(_fp8(x), _fp8(w), b, stride, padding))

    def depthwise(self, x, k, stride=1, up=1):
        return _fp8(super().depthwise(_fp8(x), k, stride))

    def linear(self, x, w, b=None):
        return _fp8(F.linear(_fp8(x), _fp8(w), b))

    def bmm(self, a, b):
        return _fp8(torch.bmm(_fp8(a), _fp8(b)))

    def group_norm(self, x, scale, bias, groups: int, eps: float):
        return _fp8(F.group_norm(x, groups, scale, bias, eps))


class Recorder(Float32):
    """Runs the forward on ``meta`` tensors and lists each call with its
    shapes: ``("conv", x, w, out, first)``, ``("conv_t", x, w, out)``,
    ``("depthwise", x, taps, out, up)``,
    ``("linear", x, w, out)``, ``("bmm", a, b, out)``, ``("gn", x)``."""

    def __init__(self):
        self.calls: list = []

    def conv2d(self, x, w, b=None, stride=1, padding=0, first=False):
        out = super().conv2d(x, w, b, stride, padding)
        self.calls.append(("conv", tuple(x.shape), tuple(w.shape),
                           tuple(out.shape), first))
        return out

    def conv_transpose2x(self, x, w):
        out = Float32.conv2d(self, F.pad(stuff(x, 2)[:, :, :-1, :-1],
                                          (2, 2, 2, 2)), w)
        self.calls.append(("conv_t", tuple(x.shape), tuple(w.shape),
                           tuple(out.shape)))
        return out

    def depthwise(self, x, k, stride=1, up=1):
        out = super().depthwise(x, k, stride)
        self.calls.append(("depthwise", tuple(x.shape), k.numel(),
                           tuple(out.shape), up))
        return out

    def linear(self, x, w, b=None):
        out = super().linear(x, w, b)
        self.calls.append(("linear", tuple(x.shape), tuple(w.shape),
                           tuple(out.shape)))
        return out

    def bmm(self, a, b):
        out = super().bmm(a, b)
        self.calls.append(("bmm", tuple(a.shape), tuple(b.shape),
                           tuple(out.shape)))
        return out

    def group_norm(self, x, scale, bias, groups: int, eps: float):
        self.calls.append(("gn", tuple(x.shape)))
        return super().group_norm(x, scale, bias, groups, eps)
