"""NCSN++ layers (``psld_tpu/models/layers.py``), eval-mode.

Activations are NCHW-logical tensors in ``channels_last`` memory; the NHWC
view that GroupNorm, NIN and attention take is a free permute. Each
module names its submodules and parameters as flax names the JAX
module's (``GroupNormAct_0``, ``Conv_1``, ``NIN_2.Dense_0``, ``scale``,
``W``), so :mod:`psld_tpu_torch.interop.from_flax` maps a param tree by
path. Convs and Denses compute in the promoted dtype of input and
weight, as flax does: f32 inputs with bf16 weights run in f32.

Dropout is the identity in eval mode; ``train=True`` raises until the
training slice brings the dropout kernel.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from psld_tpu_torch.ops import attention, group_norm_act
from psld_tpu_torch.ops.upfirdn import (conv_downsample_2d_nchw,
                                        downsample_2d_nchw,
                                        upsample_2d_nchw,
                                        upsample_conv_2d_nchw)

SQRT2 = math.sqrt(2.0)

_ACT_FNS = {
    "elu": F.elu,
    "relu": F.relu,
    "lrelu": partial(F.leaky_relu, negative_slope=0.2),
    "swish": F.silu,
}


def get_act(name: str) -> Callable:
    """Activation by name (``elu``, ``relu``, ``lrelu``, ``swish``)."""
    name = name.lower()
    if name not in _ACT_FNS:
        raise NotImplementedError(f"activation function {name} does not "
                                  "exist!")
    return _ACT_FNS[name]


def _check_eval(train: bool) -> None:
    if train:
        raise NotImplementedError(
            "train=True: the dropout of a training-mode forward comes with "
            "the port's training slice")


def _promote(x, *params):
    """Cast input and params to their promoted dtype (flax's rule)."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return (x.to(dt),) + tuple(None if p is None else p.to(dt)
                               for p in params)


def _nhwc(x):
    """NHWC view of an NCHW-logical tensor, made contiguous if the
    activation is not ``channels_last``."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Conv(nn.Conv2d):
    """flax ``nn.Conv``: stride ``stride``, symmetric int ``padding`` or
    explicit ((top, bottom), (left, right)) padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding=1, bias: bool = True):
        self._pad = None
        if not isinstance(padding, int):
            (t, b), (l_, r) = padding
            self._pad = (l_, r, t, b)
            padding = 0
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=bias)

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        if self._pad is not None:
            x = F.pad(x, self._pad)
        return F.conv2d(x, w, b, self.stride, self.padding)


class Dense(nn.Linear):
    """flax ``nn.Dense`` on the last axis, with dtype promotion."""

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        return F.linear(x, w, b)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1, bias: bool = True,
            padding=1) -> Conv:
    return Conv(in_ch, out_ch, 3, stride=stride, padding=padding, bias=bias)


def conv1x1(in_ch: int, out_ch: int, bias: bool = True) -> Conv:
    return Conv(in_ch, out_ch, 1, padding=0, bias=bias)


class GroupNormAct(nn.Module):
    """GroupNorm(min(C//4, 32)) fused with the following activation; on
    CUDA it runs the Triton kernel of :mod:`psld_tpu_torch.ops.group_norm`.
    """

    def __init__(self, ch: int, act: str = "none", eps: float = 1e-6):
        super().__init__()
        self.act = act
        self.eps = eps
        self.num_groups = min(ch // 4, 32)
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward_nhwc(self, x):
        return group_norm_act(x, self.scale, self.bias, self.num_groups,
                              self.eps, self.act)

    def forward(self, x):
        return _nchw(self.forward_nhwc(_nhwc(x)))


def get_timestep_embedding(timesteps, embedding_dim: int,
                           max_positions: int = 10_000):
    """DDPM sinusoidal embedding, f32."""
    if timesteps.ndim != 1:
        raise ValueError("timesteps must be a vector")
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                 device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GaussianFourierProjection(nn.Module):
    """Random Fourier features of the noise level; ``W`` is fixed."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(embedding_size) * scale,
                              requires_grad=False)

    def forward(self, x):
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class NIN(nn.Module):
    """1x1 projection over channels: a Dense on the last (NHWC) axis."""

    def __init__(self, in_ch: int, num_units: int):
        super().__init__()
        self.Dense_0 = Dense(in_ch, num_units)

    def forward(self, x):
        return self.Dense_0(x)


class Combine(nn.Module):
    """Combine a progressive-input pyramid branch with the trunk."""

    def __init__(self, in_ch: int, dim2: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = conv1x1(in_ch, dim2)

    def forward(self, x, y):
        h = self.Conv_0(x)
        if self.method == "cat":
            return torch.cat([h, y], dim=1)
        return h + y


class AttnBlock(nn.Module):
    """Full-spatial single-head self-attention; on CUDA the score/softmax/
    value chain is the kernel of :mod:`psld_tpu_torch.ops.attention`."""

    def __init__(self, ch: int, skip_rescale: bool = False):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNormAct_0 = GroupNormAct(ch)
        self.NIN_0 = NIN(ch, ch)
        self.NIN_1 = NIN(ch, ch)
        self.NIN_2 = NIN(ch, ch)
        self.NIN_3 = NIN(ch, ch)

    def forward(self, x):
        b, c, hh, ww = x.shape
        xh = _nhwc(x)
        h = self.GroupNormAct_0.forward_nhwc(xh)
        q = self.NIN_0(h).reshape(b, hh * ww, c)
        k = self.NIN_1(h).reshape(b, hh * ww, c)
        v = self.NIN_2(h).reshape(b, hh * ww, c)
        h = attention(q, k, v, float(c) ** -0.5)
        h = self.NIN_3(h.reshape(b, hh, ww, c).to(x.dtype))
        out = xh + h
        if self.skip_rescale:
            out = out / SQRT2
        return _nchw(out)


class FIRConv2d(nn.Module):
    """Conv2d fused with FIR resampling (StyleGAN2). ``weight`` is OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 up: bool = False, down: bool = False,
                 resample_kernel: Sequence[float] = (1, 3, 3, 1),
                 use_bias: bool = True):
        super().__init__()
        if up and down:
            raise ValueError("FIRConv2d: up and down are exclusive")
        if kernel < 1 or kernel % 2 != 1:
            raise ValueError("FIRConv2d: kernel must be odd")
        self.up, self.down = up, down
        self.resample_kernel = list(resample_kernel)
        self.weight = nn.Parameter(
            torch.randn(out_ch, in_ch, kernel, kernel)
            / math.sqrt(in_ch * kernel * kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.up:
            x = upsample_conv_2d_nchw(x, w, k=self.resample_kernel)
        elif self.down:
            x = conv_downsample_2d_nchw(x, w, k=self.resample_kernel)
        else:
            x = F.conv2d(x, w, padding=w.shape[-1] // 2)
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)[None, :, None, None]
        return x


class Upsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.fir, self.with_conv = fir, with_conv
        self.fir_kernel = list(fir_kernel)
        if with_conv and fir:
            self.FIRConv2d_0 = FIRConv2d(in_ch, out_ch, 3, up=True,
                                         resample_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = conv3x3(in_ch, out_ch)

    def forward(self, x):
        if not self.fir:
            y = F.interpolate(x, scale_factor=2, mode="nearest")
            return self.Conv_0(y) if self.with_conv else y
        if not self.with_conv:
            return upsample_2d_nchw(x, self.fir_kernel, factor=2)
        return self.FIRConv2d_0(x)


class Downsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int | None = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1)):
        super().__init__()
        out_ch = out_ch or in_ch
        self.fir, self.with_conv = fir, with_conv
        self.fir_kernel = list(fir_kernel)
        if with_conv and fir:
            self.FIRConv2d_0 = FIRConv2d(in_ch, out_ch, 3, down=True,
                                         resample_kernel=fir_kernel)
        elif with_conv:
            # asymmetric (0, 1) pad + VALID stride-2 conv
            self.Conv_0 = conv3x3(in_ch, out_ch, stride=2,
                                  padding=((0, 1), (0, 1)))

    def forward(self, x):
        if not self.fir:
            return self.Conv_0(x) if self.with_conv else F.avg_pool2d(x, 2)
        if not self.with_conv:
            return downsample_2d_nchw(x, self.fir_kernel, factor=2)
        return self.FIRConv2d_0(x)


def _temb_bias(dense, act, temb):
    return dense(act(temb))[:, :, None, None]


class ResnetBlockDDPM(nn.Module):
    """DDPM-style residual block."""

    def __init__(self, act: str, in_ch: int, out_ch: int | None = None,
                 conv_shortcut: bool = False, skip_rescale: bool = False,
                 temb_dim: int | None = None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = get_act(act)
        self.skip_rescale = skip_rescale
        self.in_ch, self.out_ch = in_ch, out_ch
        self.GroupNormAct_0 = GroupNormAct(in_ch, act)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNormAct_1 = GroupNormAct(out_ch, act)
        self.Conv_1 = conv3x3(out_ch, out_ch)
        self.shortcut = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch)
                self.shortcut = "conv"
            else:
                self.NIN_0 = NIN(in_ch, out_ch)
                self.shortcut = "nin"

    def forward(self, x, temb=None, train: bool = False):
        _check_eval(train)
        h = self.Conv_0(self.GroupNormAct_0(x))
        if temb is not None:
            h = h + _temb_bias(self.Dense_0, self.act, temb)
        h = self.Conv_1(self.GroupNormAct_1(h))
        if self.shortcut == "conv":
            x = self.Conv_2(x)
        elif self.shortcut == "nin":
            x = _nchw(self.NIN_0(_nhwc(x)))
        if not self.skip_rescale:
            return x + h
        return (x + h) / SQRT2


class ResnetBlockBigGAN(nn.Module):
    """BigGAN-style residual block with in-block resampling."""

    def __init__(self, act: str, in_ch: int, out_ch: int | None = None,
                 up: bool = False, down: bool = False, fir: bool = False,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1),
                 skip_rescale: bool = True, temb_dim: int | None = None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = get_act(act)
        self.up, self.down, self.fir = up, down, fir
        self.fir_kernel = list(fir_kernel)
        self.skip_rescale = skip_rescale
        self.GroupNormAct_0 = GroupNormAct(in_ch, act)
        self.Conv_0 = conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.Dense_0 = Dense(temb_dim, out_ch)
        self.GroupNormAct_1 = GroupNormAct(out_ch, act)
        self.Conv_1 = conv3x3(out_ch, out_ch)
        self.has_shortcut = in_ch != out_ch or up or down
        if self.has_shortcut:
            self.Conv_2 = conv1x1(in_ch, out_ch)

    def _resample(self, x):
        if self.up:
            if self.fir:
                return upsample_2d_nchw(x, self.fir_kernel, factor=2)
            return F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            if self.fir:
                return downsample_2d_nchw(x, self.fir_kernel, factor=2)
            return F.avg_pool2d(x, 2)
        return x

    def forward(self, x, temb=None, train: bool = False):
        _check_eval(train)
        h = self.GroupNormAct_0(x)
        h, x = self._resample(h), self._resample(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + _temb_bias(self.Dense_0, self.act, temb)
        h = self.Conv_1(self.GroupNormAct_1(h))
        if self.has_shortcut:
            x = self.Conv_2(x)
        if not self.skip_rescale:
            return x + h
        return (x + h) / SQRT2
